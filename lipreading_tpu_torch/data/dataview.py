"""Cached ROI dataviews (counterpart of ``lipreading_tpu/data/dataview.py``,
with the same files, so that each package reads the other's views).

A dataview directory holds one ``.npz`` per supervision sample and an
``index.json``:

    sample.npz: roi_u8 [T, R, R] uint8   mouth ROIs before normalisation
                (normalised on the device: a quarter of the bytes to store
                and copy), frame_valid [T] bool in tracked builds that keep
                their faceless frames
    index.json: {"meta": {roi_size, normalize_mean, normalize_std, fps},
                 "samples": [{"file", "text", "num_frames"[, "num_valid"]}]}

``build_fixture_dataview`` renders fixture clips, preprocesses each on the
device it is given (``ops.preprocess.preprocess_padded`` or its tracked
variant, one call a clip; the fixture's own landmarks with
``use_ground_truth_landmarks``, through the ROI kernel on a CUDA device)
and cuts the cue-aligned samples. The seeds are the JAX package's, so both
packages build the same samples from the same arguments.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from lipreading_tpu_torch.config import DataConfig, PreprocessConfig
from lipreading_tpu_torch.vtt import align_cues_to_frames, parse_vtt


def roi_to_u8(roi_norm: np.ndarray, cfg: PreprocessConfig) -> np.ndarray:
    """Normalised float32 ROIs -> the uint8 gray they store (round half
    up)."""
    g = (roi_norm * cfg.normalize_std + cfg.normalize_mean) * 255.0
    return np.clip(np.floor(g + 0.5), 0, 255).astype(np.uint8)


def u8_to_roi(roi_u8: np.ndarray, cfg: PreprocessConfig) -> np.ndarray:
    """Stored uint8 gray -> normalised float32 ROIs (on the host)."""
    return (((roi_u8.astype(np.float32) / 255.0) - cfg.normalize_mean)
            / cfg.normalize_std)


class DataviewWriter:
    """Writes samples into ``out_dir``; ``finalize`` writes the index."""

    def __init__(self, out_dir: str, data_cfg: DataConfig,
                 pre_cfg: PreprocessConfig):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.entries: list[dict] = []
        self.meta = {
            "roi_size": pre_cfg.roi_size,
            "normalize_mean": pre_cfg.normalize_mean,
            "normalize_std": pre_cfg.normalize_std,
            "fps": data_cfg.fps,
        }

    def add(self, sample_id: str, roi_u8: np.ndarray, text: str,
            frame_valid: np.ndarray | None = None) -> None:
        """``frame_valid`` (bool [T]) flags the frames with a confident face
        (tracked builds); None trusts every frame."""
        fname = f"{sample_id}.npz"
        arrays = {"roi_u8": roi_u8.astype(np.uint8)}
        entry = {"file": fname, "text": text,
                 "num_frames": int(roi_u8.shape[0])}
        if frame_valid is not None:
            arrays["frame_valid"] = np.asarray(frame_valid, bool)
            entry["num_valid"] = int(arrays["frame_valid"].sum())
        np.savez_compressed(os.path.join(self.out_dir, fname), **arrays)
        self.entries.append(entry)

    def finalize(self) -> None:
        with open(os.path.join(self.out_dir, "index.json"), "w") as f:
            json.dump({"meta": self.meta, "samples": self.entries}, f,
                      indent=1)


class Dataview:
    """Reader over a dataview directory."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "index.json")) as f:
            idx = json.load(f)
        self.meta = idx["meta"]
        self.samples = idx["samples"]

    def __len__(self) -> int:
        return len(self.samples)

    def text(self, i: int) -> str:
        return self.samples[i]["text"]

    def num_frames(self, i: int) -> int:
        return self.samples[i]["num_frames"]

    def _load(self, i: int):
        return np.load(os.path.join(self.path, self.samples[i]["file"]))

    def roi_u8(self, i: int) -> np.ndarray:
        with self._load(i) as z:
            return z["roi_u8"]

    def frame_valid(self, i: int) -> np.ndarray:
        """[T] bool: the frames with a confident face (all for untracked
        builds)."""
        with self._load(i) as z:
            if "frame_valid" in z:
                return z["frame_valid"]
        return np.ones((self.samples[i]["num_frames"],), bool)

    def num_valid(self, i: int) -> int:
        """The count of confident frames, from the index alone."""
        s = self.samples[i]
        return int(s.get("num_valid", s["num_frames"]))

    def roi_u8_compact(self, i: int) -> np.ndarray:
        """The ROI stack without its faceless frames (the skip-frame
        semantics of builds that keep them), one file read."""
        with self._load(i) as z:
            roi = z["roi_u8"]
            if "frame_valid" in z:
                roi = roi[z["frame_valid"]]
        return roi


def _variation_of(variation, seed: int, c: int) -> float:
    """Clip ``c``'s appearance level: ``variation`` itself, or for a (lo,
    hi) pair a draw in [lo, hi) fixed by the seed and the clip."""
    if isinstance(variation, (tuple, list)):
        lo, hi = variation
        u = np.random.default_rng(
            np.random.SeedSequence([0x7A12, seed, c])).random()
        return float(lo + (hi - lo) * u)
    return float(variation)


def _gt_rois(clip_frames, landmarks, pre_cfg: PreprocessConfig,
             batch_frames: int, device) -> np.ndarray:
    """ROIs of a clip from its own landmarks: the integer mouth boxes and
    the ROI sampler, ``batch_frames`` frames a call."""
    import torch

    from lipreading_tpu_torch.ops import roi as roi_ops
    from lipreading_tpu_torch.ops.preprocess import mouth_boxes_from_landmarks

    H, W = clip_frames.shape[1:3]
    rois = []
    with torch.inference_mode():
        for lo in range(0, clip_frames.shape[0], batch_frames):
            chunk = torch.as_tensor(clip_frames[lo:lo + batch_frames],
                                    device=device)
            gray = roi_ops.grayscale(chunk)
            mb = mouth_boxes_from_landmarks(
                torch.as_tensor(landmarks[lo:lo + batch_frames],
                                device=device),
                pre_cfg.roi_margin, H, W)
            r = roi_ops.sample_rois(gray, mb, pre_cfg.roi_size,
                                    mean=pre_cfg.normalize_mean,
                                    std=pre_cfg.normalize_std)
            rois.append(r.cpu().numpy())
    return np.concatenate(rois, axis=0)


def build_fixture_dataview(
    out_dir: str,
    n_clips: int,
    seed: int = 0,
    data_cfg: DataConfig | None = None,
    pre_cfg: PreprocessConfig | None = None,
    use_ground_truth_landmarks: bool = False,
    batch_frames: int = 256,
    variation=0.0,
    assets_variant: str = "default",
    tracked: bool = False,
    keep_invalid: bool = False,
    frame_transform=None,
    device="cuda",
) -> Dataview:
    """Render ``n_clips`` fixture clips, preprocess them on ``device`` and
    write their cue-aligned samples (one a word, one for the whole clip).

    ``use_ground_truth_landmarks`` takes the fixture's landmarks in place
    of the detector and landmarker. ``variation`` (a float, or a (lo, hi)
    pair drawn per clip) styles the clips; ``assets_variant`` picks the
    preprocessing weights. ``pre_cfg.landmarker`` is the ERT or the conv
    landmarker. ``tracked`` runs the tracked preprocessing and drops each
    sample's faceless frames, or with ``keep_invalid`` keeps them and
    stores the ``frame_valid`` mask. ``frame_transform(clip_index, frames)
    -> frames`` alters a clip's frames before preprocessing (tests blank
    some out)."""
    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.ops.preprocess import (
        preprocess_padded,
        preprocess_padded_tracked,
    )

    data_cfg = data_cfg or DataConfig()
    pre_cfg = pre_cfg or PreprocessConfig()
    if tracked and use_ground_truth_landmarks:
        raise ValueError("tracked builds need the real detector stack")
    writer = DataviewWriter(out_dir, data_cfg, pre_cfg)
    if not use_ground_truth_landmarks:
        from lipreading_tpu_torch.io import load_preprocessors

        det, lmk, presence = load_preprocessors(
            pre_cfg.landmarker, assets_variant, tracked, device)

    for c in range(n_clips):
        clip = make_clip(seed * 1_000_000 + c, data_cfg,
                         variation=_variation_of(variation, seed, c))
        frames = (clip.frames if frame_transform is None
                  else frame_transform(c, clip.frames))
        valid = None
        if use_ground_truth_landmarks:
            roi_norm = _gt_rois(frames, clip.landmarks, pre_cfg,
                                batch_frames, device)
        elif tracked:
            roi_norm, valid = preprocess_padded_tracked(
                det, presence, lmk, frames, pre_cfg)
        else:
            roi_norm = preprocess_padded(det, lmk, frames, pre_cfg)
        roi_u8 = roi_to_u8(roi_norm, pre_cfg)

        def cut(first, last):
            """A sample's frames (and mask), faceless frames dropped
            unless ``keep_invalid``."""
            if valid is None:
                return roi_u8[first:last], None
            v = valid[first:last]
            if keep_invalid:
                return roi_u8[first:last], v
            return roi_u8[first:last][v], None

        cues = parse_vtt(clip.vtt)
        for j, (first, last, text) in enumerate(
                align_cues_to_frames(cues, clip.fps, clip.num_frames)):
            frames_j, valid_j = cut(first, last)
            if frames_j.shape[0]:
                writer.add(f"clip{c:05d}_cue{j:02d}", frames_j, text,
                           frame_valid=valid_j)
        frames_full, valid_full = cut(0, clip.num_frames)
        if frames_full.shape[0]:
            writer.add(f"clip{c:05d}_full", frames_full, clip.text,
                       frame_valid=valid_full)

    writer.finalize()
    return Dataview(out_dir)


def clip_id_of(sample: dict) -> str:
    """An index entry -> the id of its clip (the sample id's prefix)."""
    return sample["file"].rsplit("_", 1)[0]


def merge_dataviews(out_dir: str, paths: list[str]) -> Dataview:
    """Several dataviews as one: each source's files hard-linked (copied
    across file systems) under a ``dNN_`` prefix, so clip ids stay apart.
    The metas must agree on the ROI size and the normalisation. Files of an
    earlier merge into ``out_dir`` are replaced."""
    if not paths:
        raise ValueError("merge_dataviews needs at least one source view")
    os.makedirs(out_dir, exist_ok=True)
    views = [Dataview(p) for p in paths]
    meta = dict(views[0].meta)
    entries = []
    for vi, v in enumerate(views):
        for key in ("roi_size", "normalize_mean", "normalize_std"):
            if v.meta[key] != meta[key]:
                raise ValueError(f"dataview {paths[vi]!r} meta {key}="
                                 f"{v.meta[key]} != {meta[key]} of "
                                 f"{paths[0]!r}")
        for s in v.samples:
            fname = f"d{vi:02d}_{s['file']}"
            src = os.path.join(v.path, s["file"])
            dst = os.path.join(out_dir, fname)
            if os.path.exists(dst):
                os.unlink(dst)
            try:
                os.link(src, dst)
            except OSError:
                shutil.copyfile(src, dst)
            entries.append(dict(s, file=fname))
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump({"meta": meta, "samples": entries}, f, indent=1)
    return Dataview(out_dir)


def split_by_clip(view: Dataview, fractions: dict[str, float],
                  seed: int = 0) -> dict[str, list[int]]:
    """Sample indices into named splits by clip, so that no clip's samples
    straddle two splits; ``fractions`` (e.g. {"train": 0.9, "val": 0.1})
    sum to about 1."""
    clips = sorted({clip_id_of(s) for s in view.samples})
    rng = np.random.default_rng(np.random.SeedSequence([0x5B117, seed]))
    order = [clips[i] for i in rng.permutation(len(clips))]
    bounds = []
    lo = 0.0
    for name, frac in fractions.items():
        bounds.append((name, lo, lo + frac))
        lo += frac
    assignment = {}
    for j, c in enumerate(order):
        u = (j + 0.5) / len(order)
        for name, a, b in bounds:
            if a <= u < b or (name == bounds[-1][0] and u >= b):
                assignment[c] = name
                break
    return {name: [i for i, s in enumerate(view.samples)
                   if assignment.get(clip_id_of(s)) == name]
            for name, _, _ in bounds}
