"""Training of the preprocessing models (counterpart of
``lipreading_tpu/preproc_training.py``), on the fixture corpus, whose face
boxes and landmarks are exact:

* ``train_detector``: the conv localizer (``ops.detector``) with a
  CenterNet objective: binary cross-entropy on the 8x8 score map (one-hot
  at the face centre's cell) plus half the L2 of the offset and size
  regressors at that cell;
* ``train_ert`` (``oracle.ert_train``): gradient boosting of the ERT
  cascade, numpy on the host;
* ``train_presence_head``: a two-layer face-presence head on the frozen
  detector trunk, full batch, with faceless frames as negatives;
* ``train_conv_landmarker``: the ERT distilled into the conv landmarker, on
  the ERT's own landmarks behind the detector's boxes (the teacher pass),
  with a mouth-weighted MSE, a mouth-box term and, with
  ``roi_loss_weight``, the MSE of the sub-pixel mouth ROIs the two sets of
  landmarks give.

Every weight starts from the JAX package's numpy draw for the same seed,
except the presence head's (JAX draws it from ``jax.random``; here a
``torch.Generator`` does, and ``fit_presence_head`` trains any start). The
batches are the same numpy indices. Each trainer runs on ``device`` (the
card unless the caller asks for the CPU) with float32 products and
convolutions in full float32. The teacher's face crops are launches of the
ROI kernel on the card; the ROI term needs a gradient, which the kernel
does not give, so it samples through the kernel's differentiable plain
version, as the JAX package samples through its XLA twin.

``train_all`` writes ``detector.npz``, ``ert.npz`` and ``presence.npz``;
``save_landmarker`` writes ``landmarker_conv.npz``. Both packages' loaders
read them.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from lipreading_tpu_torch.config import DataConfig, PreprocessConfig, TrainConfig
from lipreading_tpu_torch.fixtures import make_clips, render_faceless_frames
from lipreading_tpu_torch.io import ASSETS_DIR
from lipreading_tpu_torch.ops import detector as det_ops
from lipreading_tpu_torch.ops import ert as ert_ops
from lipreading_tpu_torch.ops import landmarker as lmk_ops
from lipreading_tpu_torch.ops import roi as roi_ops
from lipreading_tpu_torch.ops.preprocess import mouth_boxes_float
from lipreading_tpu_torch.oracle import detector as odet
from lipreading_tpu_torch.oracle.ert_train import landmark_error, train_ert
from lipreading_tpu_torch.oracle.roi import (
    grayscale,
    mouth_box_from_landmarks,
    round_box,
)
from lipreading_tpu_torch.train.optim import Adam

TEACHER_CHUNK = 512         # frames a teacher pass takes at once
PRESENCE_HIDDEN = 16


def _collect_frames(clips, stride=2):
    """Fixture clips -> (gray [N,H,W], square boxes [N,3], landmarks [N,68,2])."""
    imgs, boxes, lms = [], [], []
    for c in clips:
        for t in range(0, c.num_frames, stride):
            imgs.append(grayscale(c.frames[t]))
            x0, y0, w, h = c.boxes[t]
            s = max(w, h)
            boxes.append((x0 + w / 2 - s / 2, y0 + h / 2 - s / 2, s))
            lms.append(c.landmarks[t])
    return (
        np.stack(imgs).astype(np.float32),
        np.asarray(boxes, dtype=np.float32),
        np.stack(lms).astype(np.float32),
    )


def detector_targets(boxes: np.ndarray, frame_h: int, frame_w: int):
    """Square boxes [N, 3] -> (cell index [N], offset logits [N, 2],
    log size [N]): the inverse of the detector's decode on the 8x8 grid of
    its 64 px input."""
    sx, sy = frame_w / odet.INPUT, frame_h / odet.INPUT
    cx64 = (boxes[:, 0] + boxes[:, 2] / 2) / sx
    cy64 = (boxes[:, 1] + boxes[:, 2] / 2) / sy
    size64 = boxes[:, 2] / (0.5 * (sx + sy))
    cell_x = np.clip((cx64 / odet.STRIDE).astype(np.int32), 0, 7)
    cell_y = np.clip((cy64 / odet.STRIDE).astype(np.int32), 0, 7)
    dx = np.clip(cx64 / odet.STRIDE - cell_x, 1e-3, 1 - 1e-3)
    dy = np.clip(cy64 / odet.STRIDE - cell_y, 1e-3, 1 - 1e-3)
    cell = cell_y * 8 + cell_x
    logit = lambda p: np.log(p / (1 - p))  # noqa: E731
    return (
        cell.astype(np.int32),
        np.stack([logit(dx), logit(dy)], 1).astype(np.float32),
        np.log(size64 / odet.SIZE_ANCHOR).astype(np.float32),
    )


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, element by element, in its
    own formula: -y log sigmoid(x) - (1 - y) log sigmoid(-x)."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def _leaves(params: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=True) for k, v in params.items()}


def _numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def detector_loss(params: dict[str, torch.Tensor], g64: torch.Tensor,
                  cell: torch.Tensor, off: torch.Tensor,
                  log_size: torch.Tensor) -> torch.Tensor:
    """The CenterNet loss of a batch of 64 px frames [B, 64, 64]."""
    head = det_ops.forward(params, g64)                  # [B, 8, 8, 4]
    B = head.shape[0]
    flat = head.reshape(B, 64, 4)
    target = F.one_hot(cell.long(), 64).float()
    cls = sigmoid_bce(flat[..., 0], target).mean()
    sel = torch.gather(flat, 1, cell.long()[:, None, None].expand(B, 1, 4))[:, 0]
    reg = (((sel[:, 1:3] - off) ** 2).mean()
           + ((sel[:, 3] - log_size) ** 2).mean())
    return cls + 0.5 * reg


def train_detector(
    gray: np.ndarray,
    boxes: np.ndarray,
    seed: int = 0,
    steps: int = 1500,
    batch: int = 64,
    lr: float = 3e-3,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Train the conv localizer on (gray frames [N, H, W], square boxes
    [N, 3]) from ``init_detector(seed)``, plain Adam at ``lr``, batches of
    ``default_rng(seed)``'s indices. Returns the numpy weights."""
    H, W = gray.shape[1:]
    gray64 = roi_ops.resize_frames(torch.as_tensor(gray, device=device),
                                   odet.INPUT)
    cell, off_logits, log_size = (torch.as_tensor(a, device=device) for a in
                                  detector_targets(boxes, H, W))
    params = _leaves(odet.init_detector(seed), device)
    opt = Adam(params, lr)
    rng = np.random.default_rng(seed)
    n = gray64.shape[0]
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, size=batch), device=device)
        with roi_ops.full_float32():
            detector_loss(params, gray64[idx], cell[idx], off_logits[idx],
                          log_size[idx]).backward()
        opt.update()
    return _numpy(params)


def detector_box_error(params, gray: np.ndarray, gt_boxes: np.ndarray,
                       device: str | torch.device = "cuda") -> float:
    """Mean |predicted - true| box coordinate in pixels over a set."""
    det = det_ops.params_to_torch(params, device)
    with torch.no_grad():
        pred = det_ops.detect(det, torch.as_tensor(gray, device=device))
    return float(np.abs(pred.cpu().numpy() - gt_boxes).mean())


def train_all(
    seed: int = 0,
    n_clips: int = 40,
    data_cfg: DataConfig | None = None,
    pre_cfg: PreprocessConfig | None = None,
    det_steps: int = 1500,
    out_dir: str | None = None,
    verbose: bool = True,
    device: str | torch.device = "cuda",
):
    """Train the detector, the ERT and the presence head on fixture clips,
    report the held-out errors and write ``detector.npz``, ``ert.npz`` and
    ``presence.npz`` to ``out_dir`` (default: the shipped assets).
    Returns (detector weights, ERTModel, {"det_err_px", "ert_err"})."""
    data_cfg = data_cfg or DataConfig()
    pre_cfg = pre_cfg or PreprocessConfig()
    out_dir = out_dir or ASSETS_DIR
    os.makedirs(out_dir, exist_ok=True)

    clips = make_clips(seed + 1, n_clips, data_cfg)
    gray, boxes, lms = _collect_frames(clips)
    if verbose:
        print(f"training set: {gray.shape[0]} frames from {n_clips} clips")

    det_params = train_detector(gray, boxes, seed=seed, steps=det_steps,
                                device=device)
    ert_model = train_ert(
        gray, boxes, lms, seed=seed,
        stages=pre_cfg.ert_cascades, pool=pre_cfg.ert_pool,
        trees=pre_cfg.ert_trees, depth=pre_cfg.ert_depth,
        verbose=verbose,
    )

    test = make_clips(seed + 777_001, 6, data_cfg)
    tg, tb, tl = _collect_frames(test, stride=4)
    det_err = detector_box_error(det_params, tg, tb, device)
    ert_err = landmark_error(ert_model, tg, tb, tl)
    if verbose:
        print(f"held-out detector box error: {det_err:.3f} px")
        print(f"held-out landmark error: {ert_err:.5f} box units")

    odet.save_params(det_params, os.path.join(out_dir, "detector.npz"))
    ert_model.save(os.path.join(out_dir, "ert.npz"))

    # the presence head on the frozen trunk, with faceless negatives, so
    # that a fresh asset build serves the tracked path too
    rng = np.random.default_rng(seed)
    H, W = gray.shape[1:]
    neg = np.concatenate(
        [grayscale(f) for i in range(6)
         for f in render_faceless_frames(seed + 900 + i, 5)]
    ).reshape(-1, H, W)
    extremes = np.stack([
        np.zeros((H, W), np.float32),
        np.full((H, W), 255.0, np.float32),
        np.full((H, W), 215.0, np.float32),
        rng.normal(128, 40, (H, W)).clip(0, 255).astype(np.float32),
    ])
    neg = np.concatenate([neg, np.repeat(extremes, 4, axis=0)])
    presence = train_presence_head(det_params, gray, neg, boxes, seed=seed,
                                   device=device)
    save_presence(presence, os.path.join(out_dir, "presence.npz"))
    return det_params, ert_model, {"det_err_px": det_err, "ert_err": ert_err}


def presence_features(det_params, pos_gray: np.ndarray, neg_gray: np.ndarray,
                      pos_boxes: np.ndarray,
                      device: str | torch.device = "cuda"):
    """The frozen trunk's features of the face and faceless frames and their
    per-cell targets -> (feats [N+M, 8, 8, C], y [N+M, 8, 8]): 1 at the cell
    of the face centre, 0 elsewhere and on every faceless frame."""
    H, W = pos_gray.shape[1:]
    det = det_ops.params_to_torch(det_params, device)
    with torch.no_grad():
        feats = [det_ops.forward_features(det, roi_ops.resize_frames(
            torch.as_tensor(g, device=device), odet.INPUT))[0]
            for g in (pos_gray, neg_gray)]
    cell, _, _ = detector_targets(np.asarray(pos_boxes)[:, :3], H, W)
    y_p = F.one_hot(torch.as_tensor(cell, device=device).long(),
                    64).float().reshape(-1, 8, 8)
    y_n = torch.zeros((feats[1].shape[0], 8, 8), device=device)
    return torch.cat(feats), torch.cat([y_p, y_n])


def init_presence_head(channels: int, seed: int = 0) -> dict[str, np.ndarray]:
    """He-normal ``w1`` [C, 16], ``w2`` [16], zero biases, drawn by a
    ``torch.Generator`` seeded with ``seed`` on the host (the same start for
    every device)."""
    gen = torch.Generator().manual_seed(seed)
    hd = PRESENCE_HIDDEN
    return {
        "w1": (torch.randn((channels, hd), generator=gen)
               * np.sqrt(2.0 / channels)).numpy(),
        "b1": np.zeros((hd,), np.float32),
        "w2": (torch.randn((hd,), generator=gen) * np.sqrt(1.0 / hd)).numpy(),
        "b2": np.zeros((), np.float32),
    }


def presence_loss(params: dict[str, torch.Tensor], feats: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Per-cell binary cross-entropy, the positive cells weighted 32 (one
    positive against 63 negatives a face frame)."""
    logits = det_ops.presence_logits(params, feats)
    w = torch.where(y > 0, 32.0, 1.0)
    return (sigmoid_bce(logits, y) * w).mean()


def fit_presence_head(params: dict[str, np.ndarray], feats: torch.Tensor,
                      y: torch.Tensor, steps: int = 600, lr: float = 5e-2
                      ) -> dict[str, np.ndarray]:
    """Full-batch plain Adam on the presence head from ``params`` over
    ``feats`` and ``y`` (``presence_features``) -> numpy weights."""
    p = _leaves(params, feats.device)
    opt = Adam(p, lr)
    for _ in range(steps):
        with roi_ops.full_float32():
            presence_loss(p, feats, y).backward()
        opt.update()
    return _numpy(p)


def train_presence_head(
    det_params,
    pos_gray: np.ndarray,
    neg_gray: np.ndarray,
    pos_boxes: np.ndarray,
    seed: int = 0,
    steps: int = 600,
    lr: float = 5e-2,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """The face-presence head on the frozen detector trunk: face frames
    ``pos_gray`` [N, H, W] with boxes [N, 3+] and faceless frames
    ``neg_gray`` [M, H, W] -> {"w1", "b1", "w2", "b2"}. The detector's own
    score is trained only on frames with a face and is uncalibrated on
    faceless ones; this head gives the tracking its confidence."""
    feats, y = presence_features(det_params, pos_gray, neg_gray, pos_boxes,
                                 device)
    init = init_presence_head(feats.shape[-1], seed)
    return fit_presence_head(init, feats, y, steps, lr)


def _mouth_box(lm: torch.Tensor, margin: float = 0.30) -> torch.Tensor:
    """[B, 68, 2] in box units -> [B, 3] (cx, cy, size) of the mouth box.
    ``amin``/``amax`` split the gradient evenly over tied points, as JAX's
    reductions do."""
    pts = lm[:, 48:68]
    mn, mx = pts.amin(dim=1), pts.amax(dim=1)
    size = (mx - mn).amax(dim=-1) * (1.0 + margin)
    return torch.cat([(mn + mx) / 2.0, size[:, None]], dim=-1)


def roi_term_rois(lm: torch.Tensor, gray_b: torch.Tensor, org_b: torch.Tensor,
                  sz_b: torch.Tensor, margin: float, size: int) -> torch.Tensor:
    """Landmarks in box units -> the normalised sub-pixel mouth ROIs they
    give, through the differentiable plain version of the ROI sampler."""
    fl = lm * sz_b[:, None, None] + org_b[:, None, :]
    return roi_ops.sample_rois_reference(
        gray_b, mouth_boxes_float(fl, margin), size, subpixel=True)


def teacher_pass(det_params, ert_model, gray: np.ndarray,
                 device: str | torch.device = "cuda"):
    """Detector boxes -> ERT landmarks on every frame, in chunks of
    ``TEACHER_CHUNK`` -> (face crops [N, 64, 64] on ``device``, targets in
    box units [N, 68, 2], crop origins [N, 2], sizes [N]; numpy). Each
    chunk's crop is one launch of the ROI kernel on the card."""
    H, W = gray.shape[1:]
    det = det_ops.params_to_torch(det_params, device)
    ert = ert_ops.model_to_torch(ert_model, device)
    crops, targets, origins, sizes = [], [], [], []
    with torch.no_grad():
        for lo in range(0, gray.shape[0], TEACHER_CHUNK):
            g = torch.as_tensor(gray[lo:lo + TEACHER_CHUNK], device=device)
            b = det_ops.detect(det, g)
            t_lm = ert_ops.predict_batch(ert, g, b).cpu().numpy()
            ib = lmk_ops.round_face_boxes(b, H, W)
            crops.append(roi_ops.sample_rois(g.contiguous(), ib, lmk_ops.CROP,
                                             normalize=False))
            ib = ib.cpu().numpy()
            origin = np.asarray(ib[:, :2], np.float32)[:, None, :]
            size = np.asarray(ib[:, 2], np.float32)[:, None, None]
            targets.append((t_lm - origin) / size)
            origins.append(origin[:, 0, :])
            sizes.append(size[:, 0, 0])
    return (torch.cat(crops), np.concatenate(targets).astype(np.float32),
            np.concatenate(origins), np.concatenate(sizes))


def train_conv_landmarker(
    det_params,
    ert_model,
    clips,
    seed: int = 0,
    steps: int = 4000,
    batch: int = 64,
    lr: float = 2e-3,
    verbose: bool = True,
    mouth_weight: float = 4.0,
    box_weight: float = 1.0,
    roi_loss_weight: float = 0.0,
    roi_size: int = 96,
    roi_margin: float = 0.30,
    width: float = 1.0,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Distil the ERT into the conv landmarker. The targets are the ERT's
    own landmarks behind the detector's boxes (the deployment of the "ert"
    preprocessing), so the conv path copies the shipped landmarker, biases
    included. The loss: the landmark MSE with the mouth points (48-67, the
    only ones the mouth crop reads) weighted ``mouth_weight`` times (weights
    normalised to mean 1), plus ``box_weight`` times the MSE of the mouth
    box (centre and size in box units), plus, with ``roi_loss_weight``, that
    weight times the MSE of the normalised sub-pixel mouth ROIs of the
    student's and the teacher's landmarks. Plain Adam on a warmup-cosine
    schedule (warmup 100, to 0.05 ``lr`` at ``max(steps, 101)``).
    Returns the numpy weights (``landmarker_conv.npz``'s layout)."""
    gray = np.stack([grayscale(c.frames[t]) for c in clips
                     for t in range(c.num_frames)]).astype(np.float32)
    crops, targets, origins, sizes = teacher_pass(det_params, ert_model,
                                                  gray, device)
    params = {k: v.requires_grad_() for k, v in lmk_ops.params_to_torch(
        lmk_ops.init_landmarker(seed, mean_shape=targets.mean(axis=0),
                                width=width), device).items()}
    opt = Adam(params, TrainConfig(learning_rate=lr, warmup_steps=100,
                                   total_steps=max(steps, 101)))

    w_pts = np.ones((68,), np.float32)
    w_pts[48:68] = mouth_weight
    w_pts /= w_pts.mean()
    w_pts = torch.as_tensor(w_pts, device=device)[None, :, None]
    gray_t, targets_t, origins_t, sizes_t = (
        torch.as_tensor(a, device=device)
        for a in (gray, targets, origins, sizes))

    rng = np.random.default_rng(seed)
    n = crops.shape[0]
    for i in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, size=batch), device=device)
        t_b = targets_t[idx]
        with roi_ops.full_float32():
            pred = lmk_ops.forward(params, crops[idx])
            mse = (((pred - t_b) ** 2) * w_pts).mean()
            box = ((_mouth_box(pred) - _mouth_box(t_b)) ** 2).mean()
            loss = mse + box_weight * box
            if roi_loss_weight:
                frame = (gray_t[idx], origins_t[idx], sizes_t[idx],
                         roi_margin, roi_size)
                loss = loss + roi_loss_weight * (
                    (roi_term_rois(pred, *frame)
                     - roi_term_rois(t_b, *frame)) ** 2).mean()
            loss.backward()
        opt.update()
        if verbose and (i + 1) % max(steps // 8, 1) == 0:
            print(f"  landmarker step {i+1}/{steps} loss {loss.item():.6f}")
    return lmk_ops.params_to_numpy(params)


def _gate_landmarks(lm_params, det_params, ert_model, clips, device):
    """Per clip: (gray [T, H, W] numpy, the ERT's landmarks, the conv
    landmarker's), both behind the detector's boxes."""
    det = det_ops.params_to_torch(det_params, device)
    ert = ert_ops.model_to_torch(ert_model, device)
    lmk = lmk_ops.params_to_torch(lm_params, device)
    with torch.no_grad():
        for c in clips:
            g_np = np.stack([grayscale(c.frames[t])
                             for t in range(c.num_frames)]).astype(np.float32)
            g = torch.as_tensor(g_np, device=device)
            b = det_ops.detect(det, g)
            yield (g_np, ert_ops.predict_batch(ert, g, b),
                   lmk_ops.predict_batch_conv(lmk, g, b))


def conv_landmarker_error(lm_params, det_params, ert_model, clips,
                          device: str | torch.device = "cuda") -> float:
    """Mean |conv - ERT| landmark distance in pixels over the clips (the
    distillation's gate metric)."""
    errs = [float(torch.linalg.norm(got - ref, dim=-1).mean())
            for _, ref, got in _gate_landmarks(lm_params, det_params,
                                               ert_model, clips, device)]
    return float(np.mean(errs))


def conv_box_agreement(lm_params, det_params, ert_model, clips,
                       pre_cfg: PreprocessConfig | None = None,
                       device: str | torch.device = "cuda") -> float:
    """Share of frames whose rounded mouth box (the integer crop) is the
    same behind the conv and the ERT landmarks: a flipped box is what turns
    sub-pixel landmark error into shifted ROI pixels."""
    cfg = pre_cfg or PreprocessConfig()
    same = total = 0
    for g_np, ref, got in _gate_landmarks(lm_params, det_params, ert_model,
                                          clips, device):
        ref, got = ref.cpu().numpy(), got.cpu().numpy()
        H, W = g_np.shape[1:]
        for t in range(ref.shape[0]):
            br = round_box(mouth_box_from_landmarks(ref[t], cfg.roi_margin),
                           H, W)
            bg = round_box(mouth_box_from_landmarks(got[t], cfg.roi_margin),
                           H, W)
            same += int(br == bg)
            total += 1
    return same / max(total, 1)


def report_time(name: str, t0: float, device) -> None:
    """Print an entry's wall seconds since ``t0`` and where it ran."""
    where = (torch.cuda.get_device_name(torch.device(device))
             if torch.device(device).type == "cuda" else "cpu")
    print(f"{name}: {time.perf_counter() - t0:.2f} s on {where}")


def save_landmarker(params: dict, path) -> None:
    """Conv landmarker weights -> ``landmarker_conv.npz``."""
    np.savez_compressed(path, **params)


def save_presence(params: dict, path) -> None:
    """Presence head weights -> ``presence.npz``."""
    np.savez_compressed(path, **params)
