"""Deterministic synthetic talking-face fixtures.

A numpy copy of the renderer in ``lipreading_tpu/fixtures.py`` (``make_clip``,
``make_clips``, and the robustness helpers ``render_faceless_frames``,
``blank_out_frames`` and ``paste_second_face``): the same seed gives the same frames, landmarks and text
byte for byte, and the same WebVTT caption track (one cue per word, which
``data/pipeline.FixtureVideoDataset`` cuts into samples), so clips with known
transcripts reach the port without the JAX package.

Each clip is a face (soft-edged ellipse with eyes, brows, nose and lips) that
drifts and scales over time, with a mouth whose openness and width animate
per transcript character through a distinct per-character shape table.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lipreading_tpu_torch.config import DataConfig
from lipreading_tpu_torch.text import normalize_text
from lipreading_tpu_torch.vtt import Cue, write_vtt

# 28 drawable characters (a-z, space, apostrophe) -> distinct (openness, width)
_CHARS = "abcdefghijklmnopqrstuvwxyz' "


def char_mouth_params(c: str) -> tuple[float, float]:
    """Per-character mouth shape. Distinct grid point per char; space ~closed."""
    if c == " ":
        return 0.04, 0.70
    k = _CHARS.index(c)
    openness = 0.12 + 0.80 * ((k % 7) / 6.0)
    width = 0.55 + 0.42 * ((k // 7) / 3.0)
    return float(openness), float(width)


# A small fixed lexicon (common words; reference transcripts are monologue
# English — SURVEY.md §1). Sampled with the clip seed.
LEXICON = (
    "the and you that was for are with his they this have from one had word "
    "but not what all were when your can said there use each which she how "
    "their time will way about many then them write would like these her long"
).split()


@dataclass
class Clip:
    frames: np.ndarray      # [T, H, W, 3] uint8 RGB
    landmarks: np.ndarray   # [T, 68, 2] float32, (x, y) pixel coords
    boxes: np.ndarray       # [T, 4] float32, face box (x0, y0, w, h)
    text: str               # normalized transcript
    fps: float
    vtt: str                # WebVTT caption track for this clip

    @property
    def num_frames(self) -> int:
        return int(self.frames.shape[0])


def _ellipse_mask(yy, xx, cx, cy, rx, ry, soft=1.5):
    """Soft-edged filled ellipse: 1 inside, 0 outside, ~soft px transition."""
    rx = max(rx, 1e-3)
    ry = max(ry, 1e-3)
    d = np.sqrt(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2)
    # convert normalized distance to approx pixel distance at the boundary
    scale = 0.5 * (rx + ry)
    return np.clip((1.0 - d) * scale / soft + 0.5, 0.0, 1.0)


def _face_geometry(t, rng_params, H, W):
    """Per-frame face center/radii from seeded smooth motion."""
    (ax, ay, fx, fy, px, py, s_amp, s_freq, s_ph, base_r) = rng_params
    cx = W * 0.5 + ax * np.sin(2 * np.pi * fx * t + px)
    cy = H * 0.5 + ay * np.sin(2 * np.pi * fy * t + py)
    scale = 1.0 + s_amp * np.sin(2 * np.pi * s_freq * t + s_ph)
    rx = base_r * 0.78 * scale
    ry = base_r * 1.00 * scale
    return float(cx), float(cy), float(rx), float(ry)


def _landmarks(cx, cy, rx, ry, mouth_open, mouth_width):
    """Analytic iBUG-68 landmark layout for the rendered face geometry."""
    pts = np.zeros((68, 2), dtype=np.float64)

    # jaw 0-16: lower half of the face ellipse, left ear -> chin -> right ear
    tj = np.pi - np.pi * np.arange(17) / 16.0
    pts[0:17, 0] = cx + rx * np.cos(tj)
    pts[0:17, 1] = cy + ry * np.sin(tj)

    # brows 17-21 (left), 22-26 (right): arched segments above the eyes
    u = np.arange(5) / 4.0
    arch = 0.05 * ry * np.sin(np.pi * u)
    pts[17:22, 0] = cx - rx * (0.60 - 0.36 * u)
    pts[17:22, 1] = cy - 0.48 * ry - arch
    pts[22:27, 0] = cx + rx * (0.24 + 0.36 * u)
    pts[22:27, 1] = cy - 0.48 * ry - arch[::-1]

    # nose bridge 27-30 and base 31-35
    pts[27:31, 0] = cx
    pts[27:31, 1] = cy + ry * np.linspace(-0.32, 0.08, 4)
    pts[31:36, 0] = cx + rx * np.linspace(-0.10, 0.10, 5)
    pts[31:36, 1] = cy + 0.17 * ry

    # eyes 36-41 (left), 42-47 (right): hexagon on the eye ellipse
    te = np.array([np.pi, -2 * np.pi / 3, -np.pi / 3, 0.0, np.pi / 3, 2 * np.pi / 3])
    for base, ex in ((36, cx - 0.42 * rx), (42, cx + 0.42 * rx)):
        ey = cy - 0.30 * ry
        pts[base:base + 6, 0] = ex + 0.16 * rx * np.cos(te)
        pts[base:base + 6, 1] = ey + 0.10 * ry * np.sin(te)

    # mouth: outer lip 48-59 (12 pts), inner lip 60-67 (8 pts)
    mx, my = cx, cy + 0.52 * ry
    mw = 0.45 * rx * mouth_width
    mh = ry * (0.055 + 0.22 * mouth_open)
    to = np.pi + 2 * np.pi * np.arange(12) / 12.0
    pts[48:60, 0] = mx + mw * np.cos(to)
    pts[48:60, 1] = my + mh * np.sin(to)
    ih = mh * (0.15 + 0.75 * mouth_open)
    ti = np.pi + 2 * np.pi * np.arange(8) / 8.0
    pts[60:68, 0] = mx + 0.72 * mw * np.cos(ti)
    pts[60:68, 1] = my + ih * np.sin(ti)

    return pts.astype(np.float32)


DEFAULT_STYLE = {
    "skin": (198.0, 160.0, 132.0),
    "lips": (150.0, 70.0, 70.0),
    "bg_shift": 0.0,
    "noise_sigma": 2.0,
}


def _sample_style(seed: int, variation: float) -> dict:
    """Per-clip appearance style; identity at variation=0 (separate rng
    stream so the base renderer's draws are untouched)."""
    if variation <= 0.0:
        return dict(DEFAULT_STYLE)
    srng = np.random.default_rng(np.random.SeedSequence([0x57717E, seed]))
    v = float(np.clip(variation, 0.0, 1.0))
    skin = np.asarray(DEFAULT_STYLE["skin"]) + srng.uniform(-60, 40, 3) * v
    lips = np.asarray(DEFAULT_STYLE["lips"]) + srng.uniform(-40, 40, 3) * v
    return {
        "skin": tuple(np.clip(skin, 40, 255)),
        "lips": tuple(np.clip(lips, 30, 230)),
        "bg_shift": float(srng.uniform(-40, 60)) * v,
        "noise_sigma": 2.0 + float(srng.uniform(0, 6)) * v,
    }


def _render_frame(yy, xx, geom, mouth_open, mouth_width, bg, noise,
                  style=DEFAULT_STYLE):
    cx, cy, rx, ry = geom
    img = bg.copy()

    def paint(mask, color):
        m = mask[..., None]
        img[:] = img * (1 - m) + np.asarray(color, dtype=np.float64) * m

    # skin
    paint(_ellipse_mask(yy, xx, cx, cy, rx, ry), style["skin"])
    # brows
    for sx in (-1, 1):
        paint(
            _ellipse_mask(yy, xx, cx + sx * 0.42 * rx, cy - 0.50 * ry,
                          0.20 * rx, 0.035 * ry),
            (70.0, 50.0, 35.0),
        )
    # eyes
    for sx in (-1, 1):
        ex, ey = cx + sx * 0.42 * rx, cy - 0.30 * ry
        paint(_ellipse_mask(yy, xx, ex, ey, 0.16 * rx, 0.10 * ry),
              (245.0, 245.0, 240.0))
        paint(_ellipse_mask(yy, xx, ex, ey, 0.065 * rx, 0.065 * ry),
              (55.0, 40.0, 32.0))
    # nose
    paint(_ellipse_mask(yy, xx, cx, cy - 0.05 * ry, 0.055 * rx, 0.24 * ry),
          (176.0, 138.0, 112.0))
    # lips + mouth cavity (same geometry as _landmarks)
    mx, my = cx, cy + 0.52 * ry
    mw = 0.45 * rx * mouth_width
    mh = ry * (0.055 + 0.22 * mouth_open)
    paint(_ellipse_mask(yy, xx, mx, my, mw, mh), style["lips"])
    ih = mh * (0.15 + 0.75 * mouth_open)
    paint(_ellipse_mask(yy, xx, mx, my, 0.72 * mw, ih), (40.0, 18.0, 20.0))

    img += noise
    return np.clip(img, 0, 255).astype(np.uint8)


def _mouth_curves(text: str, frames_per_char: int):
    """Transcript -> per-frame (openness, width) with short transitions."""
    opens, widths = [], []
    for c in text:
        o, w = char_mouth_params(c)
        opens.append(o)
        widths.append(w)
    o = np.repeat(np.asarray(opens), frames_per_char)
    w = np.repeat(np.asarray(widths), frames_per_char)
    # small box smoothing for articulation-like transitions
    k = np.array([0.2, 0.6, 0.2])
    o = np.convolve(np.pad(o, 1, mode="edge"), k, mode="valid")
    w = np.convolve(np.pad(w, 1, mode="edge"), k, mode="valid")
    return o, w


def _make_vtt(text: str, frames_per_char: int, fps: float) -> str:
    cues = []
    pos = 0
    for word in text.split(" "):
        start_c, end_c = pos, pos + len(word)
        cues.append(
            Cue(
                start=start_c * frames_per_char / fps,
                end=end_c * frames_per_char / fps,
                text=word,
            )
        )
        pos = end_c + 1  # the space char
    return write_vtt(cues)


def sample_text(rng: np.random.Generator, min_words=2, max_words=4) -> str:
    n = int(rng.integers(min_words, max_words + 1))
    return " ".join(LEXICON[int(i)] for i in rng.integers(0, len(LEXICON), n))


def _clip_rng_and_text(seed: int, text: str | None = None):
    """``make_clip(seed)``'s generator and normalised text: the text, unless
    given, is the generator's first draw."""
    rng = np.random.default_rng(np.random.SeedSequence([0xFACE, seed]))
    if text is None:
        text = sample_text(rng)
    return rng, normalize_text(text)


def make_clip(seed: int, cfg: DataConfig | None = None, text: str | None = None,
              variation: float = 0.0) -> Clip:
    """Render one deterministic clip. Same (seed, cfg, text, variation) ->
    same bytes.

    ``variation`` in [0, 1] scales per-clip appearance diversity (skin tone,
    lip color, background palette, noise level) drawn from an independent
    seeded stream — variation=0.0 is byte-identical to the original renderer,
    so existing golden dumps / trained assets stay valid while robustness
    corpora can opt in.
    """
    cfg = cfg or DataConfig()
    rng, text = _clip_rng_and_text(seed, text)
    style = _sample_style(seed, variation)
    H, W = cfg.frame_height, cfg.frame_width

    o_curve, w_curve = _mouth_curves(text, cfg.frames_per_char)
    T = len(o_curve)

    # seeded smooth face motion parameters
    base_r = H * float(rng.uniform(0.26, 0.33))
    params = (
        float(rng.uniform(2.0, 6.0)),      # ax drift amplitude (px)
        float(rng.uniform(2.0, 6.0)),      # ay
        float(rng.uniform(0.002, 0.008)),  # fx drift freq (1/frame)
        float(rng.uniform(0.002, 0.008)),  # fy
        float(rng.uniform(0, 2 * np.pi)),  # phase x
        float(rng.uniform(0, 2 * np.pi)),  # phase y
        float(rng.uniform(0.01, 0.04)),    # scale osc amplitude
        float(rng.uniform(0.002, 0.006)),  # scale osc freq
        float(rng.uniform(0, 2 * np.pi)),  # scale phase
        base_r,
    )

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    c0 = rng.uniform(60, 110, size=3) + style["bg_shift"]
    c1 = rng.uniform(90, 150, size=3) + style["bg_shift"]
    bg = c0[None, None, :] + (c1 - c0)[None, None, :] * (yy / H)[..., None]

    frames = np.empty((T, H, W, 3), dtype=np.uint8)
    landmarks = np.empty((T, 68, 2), dtype=np.float32)
    boxes = np.empty((T, 4), dtype=np.float32)
    for t in range(T):
        geom = _face_geometry(t, params, H, W)
        cx, cy, rx, ry = geom
        noise = rng.normal(0.0, style["noise_sigma"], size=(H, W, 1))
        frames[t] = _render_frame(yy, xx, geom, o_curve[t], w_curve[t], bg,
                                  noise, style)
        landmarks[t] = _landmarks(cx, cy, rx, ry, o_curve[t], w_curve[t])
        boxes[t] = (cx - rx, cy - ry, 2 * rx, 2 * ry)

    return Clip(
        frames=frames,
        landmarks=landmarks,
        boxes=boxes,
        text=text,
        fps=cfg.fps,
        vtt=_make_vtt(text, cfg.frames_per_char, cfg.fps),
    )


def make_clips(seed: int, n: int, cfg: DataConfig | None = None,
               variation: float = 0.0) -> list[Clip]:
    return [make_clip(seed * 10_000 + i, cfg, variation=variation)
            for i in range(n)]


def clip_text(seed: int) -> str:
    """``make_clip(seed).text`` without rendering."""
    return _clip_rng_and_text(seed)[1]


# --- robustness fixtures (copies of the JAX package's helpers): frames
# where the detector finds no face or two faces, for the tracking tests


def render_faceless_frames(seed: int, n: int, cfg: DataConfig | None = None,
                           variation: float = 0.0) -> np.ndarray:
    """[n, H, W, 3] u8 background-only frames (the renderer's background and
    noise, no face): what a cutaway or slate frame looks like."""
    cfg = cfg or DataConfig()
    rng = np.random.default_rng(np.random.SeedSequence([0x0FF, seed]))
    style = _sample_style(seed, variation)
    H, W = cfg.frame_height, cfg.frame_width
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    c0 = rng.uniform(60, 110, size=3) + style["bg_shift"]
    c1 = rng.uniform(90, 150, size=3) + style["bg_shift"]
    bg = c0[None, None, :] + (c1 - c0)[None, None, :] * (yy / H)[..., None]
    out = np.empty((n, H, W, 3), np.uint8)
    for t in range(n):
        noise = rng.normal(0.0, style["noise_sigma"], size=(H, W, 1))
        out[t] = np.clip(bg + noise, 0, 255).astype(np.uint8)
    return out


def blank_out_frames(clip: Clip, idxs, seed: int = 0) -> np.ndarray:
    """Copy of ``clip.frames`` with the frames ``idxs`` replaced by faceless
    background frames (a cutaway)."""
    frames = clip.frames.copy()
    idxs = list(idxs)
    bg = render_faceless_frames(seed, len(idxs),
                                DataConfig(frame_height=frames.shape[1],
                                           frame_width=frames.shape[2]))
    for k, t in enumerate(idxs):
        frames[t] = bg[k]
    return frames


def paste_second_face(clip: Clip, donor_seed: int = 777,
                      scale: float = 0.6) -> np.ndarray:
    """Copy of ``clip.frames`` with a second, smaller face composited into
    the corner farthest from the true face (two detections a frame)."""
    frames = clip.frames.copy()
    T, H, W, _ = frames.shape
    donor = make_clip(donor_seed)
    for t in range(T):
        d = donor.frames[min(t, donor.frames.shape[0] - 1)]
        x0, y0, bw, bh = donor.boxes[min(t, donor.boxes.shape[0] - 1)]
        pad = 0.25
        x0 = max(int(x0 - pad * bw), 0)
        y0 = max(int(y0 - pad * bh), 0)
        x1 = min(int(x0 + (1 + 2 * pad) * bw), d.shape[1])
        y1 = min(int(y0 + (1 + 2 * pad) * bh), d.shape[0])
        patch = d[y0:y1, x0:x1]
        ph = max(int(patch.shape[0] * scale), 8)
        pw = max(int(patch.shape[1] * scale), 8)
        ys = (np.arange(ph) * patch.shape[0] / ph).astype(np.int32)
        xs = (np.arange(pw) * patch.shape[1] / pw).astype(np.int32)
        small = patch[ys[:, None], xs[None, :]]
        # the corner farthest from the true face box
        fx, fy = clip.boxes[t][0], clip.boxes[t][1]
        cy = 0 if fy > H / 2 else H - ph
        cx = 0 if fx > W / 2 else W - pw
        frames[t, cy:cy + ph, cx:cx + pw] = small
    return frames
