"""Ensemble-of-regression-trees landmark model (copy of the container in
``lipreading_tpu/oracle/ert.py``).

A cascade of S stages; each gathers a pool of P pixels at positions anchored
to the current shape estimate (anchor landmark + box-normalised offset), then
K depth-D trees compare pool-pixel differences against thresholds and add
their leaves' 136-value shape increments. Shapes are stored normalised to the
square face box: pixel = origin + s * size. ``predict`` runs the cascade on
one frame in numpy (the per-frame oracle and the held-out metric of
``oracle/ert_train.py``), ``random_ert`` draws a valid cascade from a seed,
and ``save`` writes ``ert.npz``.
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

    @property
    def num_stages(self) -> int:
        return int(self.anchors.shape[0])

    @property
    def pool_size(self) -> int:
        return int(self.anchors.shape[1])

    @property
    def num_trees(self) -> int:
        return int(self.feat1.shape[1])

    @property
    def depth(self) -> int:
        return int(np.log2(self.feat1.shape[2] + 1))

    def save(self, path) -> None:
        np.savez_compressed(
            path,
            mean_shape=self.mean_shape,
            anchors=self.anchors,
            offsets=self.offsets,
            feat1=self.feat1,
            feat2=self.feat2,
            thresh=self.thresh,
            leaves=self.leaves,
        )

    @classmethod
    def load(cls, path) -> "ERTModel":
        with np.load(path) as z:
            return cls(**{k: z[k] for k in z.files})


def random_ert(
    seed: int,
    stages: int = 10,
    pool: int = 128,
    trees: int = 96,
    depth: int = 4,
    mean_shape: np.ndarray | None = None,
) -> ERTModel:
    """A structurally valid cascade with seeded random parameters, the same
    draw as the JAX package's for the same arguments (the parity tests hold
    the oracles to each other for any weights)."""
    rng = np.random.default_rng(np.random.SeedSequence([0xE27, seed]))
    nn = 2**depth - 1
    nl = 2**depth
    if mean_shape is None:
        # a rough face-box-normalised 68-point ring
        mean_shape = np.stack(
            [
                0.5 + 0.4 * np.cos(np.linspace(0, 2 * np.pi, 68, endpoint=False)),
                0.5 + 0.4 * np.sin(np.linspace(0, 2 * np.pi, 68, endpoint=False)),
            ],
            axis=1,
        ).astype(np.float32)
    return ERTModel(
        mean_shape=mean_shape.astype(np.float32),
        anchors=rng.integers(0, 68, size=(stages, pool)).astype(np.int32),
        offsets=rng.normal(0, 0.12, size=(stages, pool, 2)).astype(np.float32),
        feat1=rng.integers(0, pool, size=(stages, trees, nn)).astype(np.int32),
        feat2=rng.integers(0, pool, size=(stages, trees, nn)).astype(np.int32),
        thresh=rng.normal(0, 25.0, size=(stages, trees, nn)).astype(np.float32),
        leaves=rng.normal(0, 1e-3, size=(stages, trees, nl, 136)).astype(np.float32),
    )


def gather_pool(gray: np.ndarray, shape_norm: np.ndarray,
                box: tuple[float, float, float], anchors: np.ndarray,
                offsets: np.ndarray) -> np.ndarray:
    """The P pool intensities for the current shape estimate (nearest pixel
    by ``floor(x + 0.5)``, clamped into the frame)."""
    H, W = gray.shape
    x0, y0, size = box
    pos = (shape_norm[anchors] + offsets) * size
    px = np.floor(pos[:, 0] + x0 + 0.5).astype(np.int64)
    py = np.floor(pos[:, 1] + y0 + 0.5).astype(np.int64)
    px = np.clip(px, 0, W - 1)
    py = np.clip(py, 0, H - 1)
    return gray[py, px].astype(np.float32)


def traverse_trees(vals: np.ndarray, feat1: np.ndarray, feat2: np.ndarray,
                   thresh: np.ndarray) -> np.ndarray:
    """[P] pool intensities through all K heap-ordered trees at once ->
    leaf indices [K]; a node goes right when
    ``vals[f1] - vals[f2] > thresh``."""
    K, nn = feat1.shape
    depth = int(np.log2(nn + 1))
    ks = np.arange(K)
    node = np.zeros(K, dtype=np.int64)
    for _ in range(depth):
        f1 = feat1[ks, node]
        f2 = feat2[ks, node]
        th = thresh[ks, node]
        right = (vals[f1] - vals[f2]) > th
        node = 2 * node + 1 + right
    return node - nn


def predict(model: ERTModel, gray: np.ndarray,
            box: tuple[float, float, float]) -> np.ndarray:
    """The whole cascade on one gray frame and square face box -> [68, 2]
    landmarks in pixels."""
    x0, y0, size = (float(v) for v in box)
    shape = model.mean_shape.astype(np.float32).copy()
    ks = np.arange(model.num_trees)
    for s in range(model.num_stages):
        vals = gather_pool(gray, shape, (x0, y0, size), model.anchors[s],
                           model.offsets[s])
        leaf = traverse_trees(vals, model.feat1[s], model.feat2[s],
                              model.thresh[s])
        delta = model.leaves[s][ks, leaf].sum(axis=0)
        shape = shape + delta.reshape(68, 2)
    return shape * np.float32(size) + np.asarray([x0, y0], dtype=np.float32)
