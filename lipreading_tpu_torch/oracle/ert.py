"""Ensemble-of-regression-trees landmark model (copy of the container in
``lipreading_tpu/oracle/ert.py``).

A cascade of S stages; each gathers a pool of P pixels at positions anchored
to the current shape estimate (anchor landmark + box-normalised offset), then
K depth-D trees compare pool-pixel differences against thresholds and add
their leaves' 136-value shape increments. Shapes are stored normalised to the
square face box: pixel = origin + s * size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ERTModel:
    mean_shape: np.ndarray   # [68, 2] f32, box-normalized
    anchors: np.ndarray      # [S, P] i32, landmark index per pool pixel
    offsets: np.ndarray      # [S, P, 2] f32, box-normalized offset
    feat1: np.ndarray        # [S, K, Nn] i32, pool index (left operand)
    feat2: np.ndarray        # [S, K, Nn] i32, pool index (right operand)
    thresh: np.ndarray       # [S, K, Nn] f32, split threshold on pixel diff
    leaves: np.ndarray       # [S, K, Nl, 136] f32, boosted shape increments

    @classmethod
    def load(cls, path) -> "ERTModel":
        with np.load(path) as z:
            return cls(**{k: z[k] for k in z.files})
