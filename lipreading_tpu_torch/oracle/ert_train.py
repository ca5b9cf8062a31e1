"""Gradient boosting of the ERT landmark cascade (copy of
``lipreading_tpu/oracle/ert_train.py``): Kazemi and Sullivan's training ("One
Millisecond Face Alignment with an Ensemble of Regression Trees"), numpy on
the host, vectorised over the samples. Each stage gathers its pool once,
then fits its trees greedily on the running residual; a split compares two
pool pixels' difference with a threshold drawn from a random sample's
difference. The same seed gives the same bytes as the JAX package's.
"""

from __future__ import annotations

import numpy as np

from lipreading_tpu_torch.oracle.ert import ERTModel, predict


def _gather_all(imgs, img_idx, shapes, boxes, anchors, offsets):
    """Pool intensities for every training sample. -> [N, P] float32.

    imgs: [M, H, W]; img_idx: [N]; shapes: [N, 68, 2] box-normalized;
    boxes: [N, 3] (x0, y0, size).
    """
    H, W = imgs.shape[1:]
    size = boxes[:, 2][:, None, None]
    origin = boxes[:, :2][:, None, :]
    pos = (shapes[:, anchors] + offsets[None]) * size + origin      # [N, P, 2]
    px = np.clip(np.floor(pos[..., 0] + 0.5).astype(np.int64), 0, W - 1)
    py = np.clip(np.floor(pos[..., 1] + 0.5).astype(np.int64), 0, H - 1)
    return imgs[img_idx[:, None], py, px].astype(np.float32)


def _fit_tree(vals, residual, rng, depth, n_candidates, shrinkage):
    """Greedily fit one regression tree; mutates ``residual`` in place.

    vals: [N, P]; residual: [N, 136]. Returns (feat1, feat2, thresh, leaves)
    with heap-ordered nodes. Split score is the boosting objective
    sum_{sides} |sum r|^2 / n (maximized).
    """
    N, P = vals.shape
    nn = 2**depth - 1
    nl = 2**depth
    feat1 = np.zeros(nn, dtype=np.int32)
    feat2 = np.zeros(nn, dtype=np.int32)
    thresh = np.zeros(nn, dtype=np.float32)
    node_samples: list[np.ndarray | None] = [None] * (nn + nl)
    node_samples[0] = np.arange(N)

    for node in range(nn):
        samples = node_samples[node]
        if samples is None or len(samples) < 2:
            # degenerate node: arbitrary split, all samples (if any) go left
            node_samples[2 * node + 1] = samples
            node_samples[2 * node + 2] = np.empty(0, dtype=np.int64)
            thresh[node] = np.float32(np.inf)
            continue
        r = residual[samples]                                # [n, 136]
        v = vals[samples]                                    # [n, P]
        f1 = rng.integers(0, P, size=n_candidates)
        f2 = rng.integers(0, P, size=n_candidates)
        d = v[:, f1] - v[:, f2]                              # [n, C]
        # dlib-style thresholds: a random sample's diff value per candidate
        pick = rng.integers(0, len(samples), size=n_candidates)
        th = d[pick, np.arange(n_candidates)] + rng.normal(0, 1.0, n_candidates)
        right = d > th[None, :].astype(np.float32)           # [n, C]
        cnt_r = right.sum(axis=0)
        cnt_l = len(samples) - cnt_r
        sum_all = r.sum(axis=0)                              # [136]
        sum_r = right.T.astype(np.float32) @ r               # [C, 136]
        sum_l = sum_all[None] - sum_r
        with np.errstate(divide="ignore", invalid="ignore"):
            score = np.where(cnt_r > 0, (sum_r**2).sum(1) / cnt_r, 0.0) + np.where(
                cnt_l > 0, (sum_l**2).sum(1) / cnt_l, 0.0
            )
        best = int(np.argmax(score))
        feat1[node] = f1[best]
        feat2[node] = f2[best]
        thresh[node] = th[best]
        mask = right[:, best]
        node_samples[2 * node + 1] = samples[~mask]
        node_samples[2 * node + 2] = samples[mask]

    leaves = np.zeros((nl, residual.shape[1]), dtype=np.float32)
    for leaf in range(nl):
        samples = node_samples[nn + leaf]
        if samples is not None and len(samples) > 0:
            leaves[leaf] = shrinkage * residual[samples].mean(axis=0)
            residual[samples] -= leaves[leaf]
    return feat1, feat2, thresh, leaves


def train_ert(
    imgs: np.ndarray,          # [M, H, W] float32 gray frames (0..255)
    boxes: np.ndarray,         # [M, 3] square face box (x0, y0, size)
    shapes_px: np.ndarray,     # [M, 68, 2] ground-truth landmarks (pixels)
    seed: int = 0,
    stages: int = 10,
    pool: int = 128,
    trees: int = 96,
    depth: int = 4,
    n_candidates: int = 24,
    shrinkage: float = 0.1,
    oversample: int = 6,
    verbose: bool = False,
) -> ERTModel:
    rng = np.random.default_rng(np.random.SeedSequence([0xE27, 0x7124, seed]))
    M = imgs.shape[0]
    boxes = boxes.astype(np.float32)
    gt_norm = (shapes_px - boxes[:, None, :2]) / boxes[:, 2][:, None, None]
    mean_shape = gt_norm.mean(axis=0).astype(np.float32)

    # oversampled training set: each image seen from several jittered inits
    img_idx = np.repeat(np.arange(M), oversample)
    N = len(img_idx)
    scale = rng.uniform(0.90, 1.10, size=(N, 1, 1)).astype(np.float32)
    shift = rng.uniform(-0.06, 0.06, size=(N, 1, 2)).astype(np.float32)
    current = (mean_shape[None] - 0.5) * scale + 0.5 + shift     # [N, 68, 2]
    # a fraction of inits are other images' ground truths (dlib trick)
    n_swap = N // 4
    swap_to = rng.integers(0, M, size=n_swap)
    current[:n_swap] = gt_norm[swap_to]
    gt = gt_norm[img_idx].reshape(N, -1).astype(np.float32)
    current = current.reshape(N, -1).astype(np.float32)
    sample_boxes = boxes[img_idx]

    nn = 2**depth - 1
    nl = 2**depth
    anchors = np.zeros((stages, pool), dtype=np.int32)
    offsets = np.zeros((stages, pool, 2), dtype=np.float32)
    feat1 = np.zeros((stages, trees, nn), dtype=np.int32)
    feat2 = np.zeros((stages, trees, nn), dtype=np.int32)
    thresh = np.zeros((stages, trees, nn), dtype=np.float32)
    leaves = np.zeros((stages, trees, nl, 136), dtype=np.float32)

    for s in range(stages):
        sigma = 0.16 * (0.75**s) + 0.02
        anchors[s] = rng.integers(0, 68, size=pool)
        offsets[s] = rng.normal(0, sigma, size=(pool, 2)).astype(np.float32)
        vals = _gather_all(
            imgs, img_idx, current.reshape(N, 68, 2), sample_boxes,
            anchors[s], offsets[s],
        )
        residual = gt - current
        for k in range(trees):
            feat1[s, k], feat2[s, k], thresh[s, k], leaves[s, k] = _fit_tree(
                vals, residual, rng, depth, n_candidates, shrinkage
            )
        current = gt - residual
        if verbose:
            err = np.abs(gt - current).reshape(N, 68, 2)
            print(f"stage {s}: mean |err| = {err.mean():.5f} box units")

    return ERTModel(
        mean_shape=mean_shape,
        anchors=anchors,
        offsets=offsets,
        feat1=feat1,
        feat2=feat2,
        thresh=thresh,
        leaves=leaves,
    )


def landmark_error(model, imgs, boxes, shapes_px) -> float:
    """Mean per-landmark L2 error in box-normalized units over a set."""
    errs = []
    for i in range(imgs.shape[0]):
        pred = predict(model, imgs[i], tuple(boxes[i]))
        e = np.linalg.norm(pred - shapes_px[i], axis=1) / boxes[i, 2]
        errs.append(e.mean())
    return float(np.mean(errs))
