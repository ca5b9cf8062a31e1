"""Frozen copy of the port's fixture renderer (``make_clip``'s frames and
text, ``sample_text`` and ``LEXICON`` of ``lipreading_tpu_torch/fixtures.py``):
the benchmark's traffic, kept here so that a change to the program cannot
change the inputs it is measured on. ``tests/test_portbench_frozen.py``
holds it equal, byte for byte, to the program's renderer.

Frames are 160 x 160 RGB, 4 frames a character (the program's
``DataConfig`` defaults)."""

from __future__ import annotations

import re

import numpy as np

FRAME_H = FRAME_W = 160
FRAMES_PER_CHAR = 4

_KEEP_RE = re.compile(r"[^a-z' ]+")
_WS_RE = re.compile(r"\s+")


def normalize_text(s: str) -> str:
    """Lowercase, strip everything but [a-z' ], collapse whitespace."""
    s = s.lower()
    s = _KEEP_RE.sub(" ", s)
    s = _WS_RE.sub(" ", s).strip()
    return s


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



def make_clip(seed: int, variation: float = 0.0):
    """One deterministic clip -> (frames [T, H, W, 3] uint8, text): the
    frames and text of the program's ``make_clip(seed, variation=...)``."""
    rng, text = _clip_rng_and_text(seed)
    style = _sample_style(seed, variation)
    H, W = FRAME_H, FRAME_W
    o_curve, w_curve = _mouth_curves(text, FRAMES_PER_CHAR)
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
    for t in range(T):
        geom = _face_geometry(t, params, H, W)
        noise = rng.normal(0.0, style["noise_sigma"], size=(H, W, 1))
        frames[t] = _render_frame(yy, xx, geom, o_curve[t], w_curve[t], bg,
                                  noise, style)
    return frames, text


def render(job):
    """Worker entry: (seed, variation) -> ``make_clip``'s (frames, text)."""
    seed, variation = job
    return make_clip(seed, variation)
