"""WebVTT caption parsing and cue->frame alignment (a copy of
``lipreading_tpu/vtt.py``, which imports nothing of JAX, kept here so that
the port imports nothing of the JAX package).

The reference pairs YouTube closed-caption ``.vtt`` tracks with video frames to
build (frame-range, text) supervision pairs — "dataviews" (SURVEY.md §3
"Caption parser/aligner"). This module is a dependency-free WebVTT subset
parser plus the time->frame-index alignment used to build dataviews.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from lipreading_tpu_torch.text import normalize_text

_TS_RE = re.compile(
    r"(?:(\d+):)?(\d{2}):(\d{2})[.,](\d{3})"
)
_CUE_LINE_RE = re.compile(
    r"^\s*((?:\d+:)?\d{2}:\d{2}[.,]\d{3})\s*-->\s*((?:\d+:)?\d{2}:\d{2}[.,]\d{3})"
)
_TAG_RE = re.compile(r"<[^>]+>")


def parse_timestamp(ts: str) -> float:
    """``HH:MM:SS.mmm`` or ``MM:SS.mmm`` -> seconds (float)."""
    m = _TS_RE.fullmatch(ts.strip())
    if not m:
        raise ValueError(f"bad WebVTT timestamp: {ts!r}")
    h, mm, ss, ms = m.groups()
    return (int(h or 0)) * 3600 + int(mm) * 60 + int(ss) + int(ms) / 1000.0


def format_timestamp(seconds: float) -> str:
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}.{ms:03d}"


@dataclass(frozen=True)
class Cue:
    start: float          # seconds
    end: float            # seconds
    text: str             # raw cue text (tags stripped, lines joined)

    @property
    def normalized(self) -> str:
        return normalize_text(self.text)

    def frame_range(self, fps: float) -> tuple[int, int]:
        """[start_frame, end_frame) covered by this cue at the given FPS."""
        first = int(round(self.start * fps))
        last = int(round(self.end * fps))
        return first, max(last, first + 1)


def parse_vtt(content: str) -> list[Cue]:
    """Parse a WebVTT document into a list of cues.

    Supports the subset YouTube emits: optional WEBVTT header, optional cue
    identifiers, ``-->`` timing lines with optional settings, multi-line
    payloads, ``<c>``/``<v>`` style tags (stripped), NOTE/STYLE blocks
    (skipped).
    """
    cues: list[Cue] = []
    lines = content.splitlines()
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        m = _CUE_LINE_RE.match(line)
        if not m:
            # skip headers, identifiers, NOTE/STYLE blocks, blank lines
            if line.strip().upper().startswith(("NOTE", "STYLE", "REGION")):
                i += 1
                while i < n and lines[i].strip():
                    i += 1
            else:
                i += 1
            continue
        start = parse_timestamp(m.group(1))
        end = parse_timestamp(m.group(2))
        i += 1
        payload: list[str] = []
        while i < n and lines[i].strip():
            payload.append(_TAG_RE.sub("", lines[i]).strip())
            i += 1
        text = " ".join(p for p in payload if p)
        if text:
            cues.append(Cue(start=start, end=end, text=text))
    return cues


def write_vtt(cues: list[Cue]) -> str:
    """Serialize cues back to a WebVTT document (fixture generation)."""
    out = ["WEBVTT", ""]
    for c in cues:
        out.append(f"{format_timestamp(c.start)} --> {format_timestamp(c.end)}")
        out.append(c.text)
        out.append("")
    return "\n".join(out)


def align_cues_to_frames(
    cues: list[Cue], fps: float, num_frames: int, min_chars: int = 1
) -> list[tuple[int, int, str]]:
    """Cues -> (first_frame, last_frame_exclusive, normalized_text) samples.

    Drops cues that fall outside the video or normalize to fewer than
    ``min_chars`` characters. This is the supervision-pair extraction the
    reference performs when it builds a dataview (SURVEY.md §4.1).
    """
    out = []
    for c in cues:
        text = c.normalized
        if len(text) < min_chars:
            continue
        first, last = c.frame_range(fps)
        first = max(0, first)
        last = min(num_frames, last)
        if last - first < 1:
            continue
        out.append((first, last, text))
    return out
