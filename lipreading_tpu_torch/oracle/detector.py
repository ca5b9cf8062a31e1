"""Face detector architecture constants (copy of ``lipreading_tpu/oracle/detector.py``).

Input 64x64 gray normalised to [-1, 1]; three 3x3 stride-2 convolutions with
relu (1->8->16->32 channels, 64->8 px) and a 1x1 head giving, per 8x8 cell,
(score, dx, dy, log_size). The argmax-score cell locates the face centre;
sigmoid offsets place it within the cell (stride 8 on the 64 px input) and
size = exp(log_size) * 32 px. ``init_detector`` draws a fresh detector's
weights and ``save_params`` writes them.
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


def save_params(params: dict[str, np.ndarray], path) -> None:
    """Weights -> ``detector.npz`` (what ``load_params`` reads)."""
    np.savez_compressed(path, **params)


def load_params(path) -> dict[str, np.ndarray]:
    """``detector.npz`` -> {"conv1/w": HWIO, "conv1/b": [C], ...}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
