"""Face detector architecture constants (copy of ``lipreading_tpu/oracle/detector.py``).

Input 64x64 gray normalised to [-1, 1]; three 3x3 stride-2 convolutions with
relu (1->8->16->32 channels, 64->8 px) and a 1x1 head giving, per 8x8 cell,
(score, dx, dy, log_size). The argmax-score cell locates the face centre;
sigmoid offsets place it within the cell (stride 8 on the 64 px input) and
size = exp(log_size) * 32 px. ``init_detector`` draws a fresh detector's
weights and ``save_params`` writes them. ``forward``, ``decode_box`` and
``detect`` are the numpy forward of the per-frame oracle
(``oracle/pipeline.run_clip``), the one ``ops/detector.py`` is held to.
"""

from __future__ import annotations

import numpy as np

STRIDE = 8
INPUT = 64
SIZE_ANCHOR = 32.0

# (name, kernel, c_in, c_out, stride)
LAYERS = (
    ("conv1", 3, 1, 8, 2),
    ("conv2", 3, 8, 16, 2),
    ("conv3", 3, 16, 32, 2),
    ("head", 1, 32, 4, 1),
)


def init_detector(seed: int = 0) -> dict[str, np.ndarray]:
    """He-normal weights and zero biases drawn from numpy, the same draw as
    the JAX package's for the same ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([0xFACE, 0xDE7, seed]))
    params: dict[str, np.ndarray] = {}
    for name, k, cin, cout, _ in LAYERS:
        fan_in = k * k * cin
        params[f"{name}/w"] = rng.normal(
            0, np.sqrt(2.0 / fan_in), size=(k, k, cin, cout)
        ).astype(np.float32)
        params[f"{name}/b"] = np.zeros(cout, dtype=np.float32)
    return params


def _conv2d(x: np.ndarray, w: np.ndarray, stride: int) -> np.ndarray:
    """SAME-padded strided conv by an im2col product. x: [H, W, Cin]."""
    kh, kw, cin, cout = w.shape
    H, W, _ = x.shape
    ph, pw = kh // 2, kw // 2
    xp = np.pad(x, ((ph, ph), (pw, pw), (0, 0)))
    oh, ow = -(-H // stride), -(-W // stride)
    # gather patches [oh, ow, kh, kw, cin]
    iy = (np.arange(oh) * stride)[:, None] + np.arange(kh)[None, :]   # [oh, kh]
    ix = (np.arange(ow) * stride)[:, None] + np.arange(kw)[None, :]   # [ow, kw]
    patches = xp[iy[:, None, :, None], ix[None, :, None, :], :]       # [oh,ow,kh,kw,cin]
    flat = patches.reshape(oh * ow, kh * kw * cin).astype(np.float32)
    out = flat @ w.reshape(kh * kw * cin, cout).astype(np.float32)
    return out.reshape(oh, ow, cout)


def forward(params: dict[str, np.ndarray], gray64: np.ndarray) -> np.ndarray:
    """64x64 gray (0..255) -> [8, 8, 4] raw head outputs."""
    x = ((gray64.astype(np.float32) / 255.0) - 0.5) / 0.5
    x = x[..., None]
    for name, _, _, _, stride in LAYERS:
        x = _conv2d(x, params[f"{name}/w"], stride) + params[f"{name}/b"]
        if name != "head":
            x = np.maximum(x, 0.0)
    return x


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def decode_box(
    head: np.ndarray, frame_h: int, frame_w: int
) -> tuple[float, float, float]:
    """[8, 8, 4] head -> square face box (x0, y0, size) in frame pixels; the
    first maximal score in row-major order wins."""
    score = head[..., 0]
    idx = int(np.argmax(score))
    cy_cell, cx_cell = divmod(idx, score.shape[1])
    dx = _sigmoid(head[cy_cell, cx_cell, 1])
    dy = _sigmoid(head[cy_cell, cx_cell, 2])
    size64 = np.exp(head[cy_cell, cx_cell, 3]) * SIZE_ANCHOR
    cx64 = (cx_cell + dx) * STRIDE
    cy64 = (cy_cell + dy) * STRIDE
    sx, sy = frame_w / INPUT, frame_h / INPUT
    cx, cy = cx64 * sx, cy64 * sy
    size = float(size64) * 0.5 * (sx + sy)
    return float(cx - size / 2.0), float(cy - size / 2.0), float(size)


def detect(params: dict[str, np.ndarray], gray: np.ndarray
           ) -> tuple[float, float, float]:
    """Full-resolution gray frame -> square face box (x0, y0, size)."""
    from lipreading_tpu_torch.oracle.roi import resize_frame

    head = forward(params, resize_frame(gray, INPUT))
    return decode_box(head, gray.shape[0], gray.shape[1])


def save_params(params: dict[str, np.ndarray], path) -> None:
    """Weights -> ``detector.npz`` (what ``load_params`` reads)."""
    np.savez_compressed(path, **params)


def load_params(path) -> dict[str, np.ndarray]:
    """``detector.npz`` -> {"conv1/w": HWIO, "conv1/b": [C], ...}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
