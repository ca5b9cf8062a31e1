"""Raw-frame batches for fused-preprocessing training (counterpart of
``VideoBatch``, ``FixtureVideoDataset``, ``VideoBatchIterator`` and
``video_batch_to_device`` in ``lipreading_tpu/data/pipeline.py``).

The host renders fixture clips, cuts them into per-word cue samples, and
pads batches of uint8 frames into time buckets; detection, landmarks and
ROIs run on the device inside the train step (``train/loop.FusedTrainer``).
The same seeds give the same batches, in the same order, as the JAX package.
The video-file decode pool and the prefetcher belong to the serving loop, a
later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lipreading_tpu_torch.config import DataConfig
from lipreading_tpu_torch.text import Vocab


@dataclass
class VideoBatch:
    """Raw-frame batch for fused-preprocessing training."""

    frames: np.ndarray          # [B, T, H, W, 3] uint8
    frame_lengths: np.ndarray   # [B]
    targets: np.ndarray         # [B, L]
    target_lengths: np.ndarray  # [B]
    ctc_labels: np.ndarray      # [B, Lc]
    ctc_lengths: np.ndarray     # [B]
    texts: list[str]


class FixtureVideoDataset:
    """In-memory corpus of rendered fixture clips cut into cue samples: one
    sample per caption cue (word) and one for the whole clip."""

    def __init__(self, n_clips: int, seed: int, cfg: DataConfig,
                 vocab: Vocab | None = None):
        from lipreading_tpu_torch.fixtures import make_clip
        from lipreading_tpu_torch.vtt import align_cues_to_frames, parse_vtt

        self.cfg = cfg
        self.vocab = vocab or Vocab()
        self.samples: list[tuple[np.ndarray, str]] = []
        for c in range(n_clips):
            clip = make_clip(seed * 131_071 + c, cfg)
            cues = parse_vtt(clip.vtt)
            for first, last, text in align_cues_to_frames(
                    cues, clip.fps, clip.num_frames):
                self.samples.append((clip.frames[first:last], text))
            self.samples.append((clip.frames, clip.text))

    def __len__(self):
        return len(self.samples)

    def batch(self, indices: list[int], time_bucket: int) -> VideoBatch:
        B = len(indices)
        cfg = self.cfg
        H, W = cfg.frame_height, cfg.frame_width
        L = cfg.max_chars
        frames = np.zeros((B, time_bucket, H, W, 3), np.uint8)
        fl = np.zeros((B,), np.int32)
        targets = np.zeros((B, L), np.int32)
        tl = np.zeros((B,), np.int32)
        ctc = np.zeros((B, L), np.int32)
        cl = np.zeros((B,), np.int32)
        texts = []
        for k, i in enumerate(indices):
            f, text = self.samples[i]
            t = min(f.shape[0], time_bucket)
            frames[k, :t] = f[:t]
            fl[k] = t
            ids = self.vocab.encode(text)[: L - 2]
            text = self.vocab.decode(ids)
            targets[k], tl[k] = self.vocab.encode_target(text, L)
            ctc[k, : len(ids)] = ids
            cl[k] = len(ids)
            texts.append(text)
        return VideoBatch(frames, fl, targets, tl, ctc, cl, texts)


class VideoBatchIterator:
    """Deterministic, resumable iterator over raw-frame batches: per epoch, a
    seeded permutation of the samples, grouped by time bucket into full
    batches, the batches shuffled."""

    def __init__(self, dataset: FixtureVideoDataset, batch_size: int,
                 seed: int = 0, epoch: int = 0, pos: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = epoch
        self.pos = pos
        self.buckets = tuple(sorted(dataset.cfg.time_buckets))
        self._plan = self._make_plan(epoch)

    @classmethod
    def from_state(cls, dataset: FixtureVideoDataset, batch_size: int,
                   state: dict) -> "VideoBatchIterator":
        """Resume at a saved ``state`` (epoch, position, seed)."""
        return cls(dataset, batch_size, seed=state["seed"],
                   epoch=state["epoch"], pos=state["pos"])

    def _bucket_for(self, t: int) -> int:
        for b in self.buckets:
            if t <= b:
                return b
        return self.buckets[-1]

    def _make_plan(self, epoch):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 0x71DE0]))
        order = rng.permutation(len(self.ds))
        plan = []
        for b in self.buckets:
            members = [
                int(i) for i in order
                if self._bucket_for(self.ds.samples[i][0].shape[0]) == b
            ]
            for lo in range(0, len(members) - self.batch_size + 1,
                            self.batch_size):
                plan.append((b, members[lo:lo + self.batch_size]))
        rng.shuffle(plan)
        return plan

    @property
    def state(self):
        return {"epoch": self.epoch, "pos": self.pos, "seed": self.seed}

    def __iter__(self):
        return self

    def __next__(self) -> VideoBatch:
        if self.pos >= len(self._plan):
            self.epoch += 1
            self.pos = 0
            self._plan = self._make_plan(self.epoch)
            if not self._plan:
                raise RuntimeError("dataset too small for batch size")
        bucket, idx = self._plan[self.pos]
        self.pos += 1
        return self.ds.batch(idx, bucket)


def video_batch_to_device(batch: VideoBatch,
                          device: str | torch.device) -> dict:
    """VideoBatch -> dict of tensors on ``device`` (frames stay uint8; the
    train step preprocesses them there)."""
    def put(x):
        return torch.as_tensor(x).to(device)

    return {
        "frames": put(batch.frames),
        "frame_lengths": put(batch.frame_lengths),
        "targets": put(batch.targets),
        "target_lengths": put(batch.target_lengths),
        "ctc_labels": put(batch.ctc_labels),
        "ctc_lengths": put(batch.ctc_lengths),
    }
