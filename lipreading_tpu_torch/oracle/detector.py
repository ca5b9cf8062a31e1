"""Face detector architecture constants (copy of ``lipreading_tpu/oracle/detector.py``).

Input 64x64 gray normalised to [-1, 1]; three 3x3 stride-2 convolutions with
relu (1->8->16->32 channels, 64->8 px) and a 1x1 head giving, per 8x8 cell,
(score, dx, dy, log_size). The argmax-score cell locates the face centre;
sigmoid offsets place it within the cell (stride 8 on the 64 px input) and
size = exp(log_size) * 32 px.
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


def load_params(path) -> dict[str, np.ndarray]:
    """``detector.npz`` -> {"conv1/w": HWIO, "conv1/b": [C], ...}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
