"""Bucketed, padded, resumable batches of a dataview (counterpart of
``lipreading_tpu/data/dataset.py``).

* Each batch is padded to a time bucket (``cfg.time_buckets``) and to
  ``max_chars``, so the model sees a few shapes.
* The plan of an epoch is a function of (seed, epoch) alone, and the
  iterator's state is (epoch, position): a checkpoint of it resumes
  exactly. The seeds are the JAX package's, so both give the same batches.
* A sample longer than the largest bucket keeps its first frames, and its
  CTC labels are cut to what those frames can align.
* ``batch_to_device`` normalises the uint8 ROIs on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lipreading_tpu_torch.config import DataConfig
from lipreading_tpu_torch.data.dataview import Dataview
from lipreading_tpu_torch.text import Vocab


@dataclass
class Batch:
    """A host batch of stored ROIs; the fields of ``compute_loss``'s batch,
    with the ROIs still uint8."""

    rois_u8: np.ndarray         # [B, Tb, R, R] uint8
    frame_lengths: np.ndarray   # [B] int32
    targets: np.ndarray         # [B, L] int32, sos-framed
    target_lengths: np.ndarray  # [B] int32 (sos and eos included)
    ctc_labels: np.ndarray      # [B, Lc] int32
    ctc_lengths: np.ndarray     # [B] int32
    texts: list[str]

    @property
    def size(self) -> int:
        return int(self.rois_u8.shape[0])


class BucketedDataset:
    """The samples of a dataview (or of a split of it, ``indices``), each
    assigned the smallest time bucket that holds its confident frames."""

    def __init__(self, view: Dataview, cfg: DataConfig,
                 vocab: Vocab | None = None, max_chars: int | None = None,
                 indices: list[int] | None = None):
        self.view = view
        self.cfg = cfg
        self.vocab = vocab or Vocab()
        self.max_chars = max_chars or cfg.max_chars
        self.buckets = tuple(sorted(cfg.time_buckets))
        self.indices = (list(indices) if indices is not None
                        else list(range(len(view))))
        # a build that keeps faceless frames buckets by the confident ones:
        # make_batch drops the others
        self.sample_bucket = np.asarray(
            [self._bucket_for(view.num_valid(i)) for i in self.indices])

    def _bucket_for(self, t: int) -> int:
        for b in self.buckets:
            if t <= b:
                return b
        return self.buckets[-1]

    def __len__(self) -> int:
        return len(self.indices)

    def make_batch(self, indices: list[int]) -> Batch:
        """A batch of the samples at ``indices`` (positions in this
        dataset), padded to the largest of their buckets."""
        tb = int(max(self.sample_bucket[i] for i in indices))
        B = len(indices)
        R = self.view.meta["roi_size"]
        L = self.max_chars
        rois = np.zeros((B, tb, R, R), np.uint8)
        fl = np.zeros((B,), np.int32)
        targets = np.zeros((B, L), np.int32)
        tl = np.zeros((B,), np.int32)
        ctc = np.zeros((B, L), np.int32)
        cl = np.zeros((B,), np.int32)
        texts = []
        for k, i in enumerate(indices):
            vi = self.indices[i]
            roi = self.view.roi_u8_compact(vi)
            t = min(roi.shape[0], tb)
            rois[k, :t] = roi[:t]
            fl[k] = t
            # (t - 1) // 2 labels always admit a path in t frames, even
            # with every label repeated: a head-cut sample would otherwise
            # keep an infeasible caption (nll ~1e30, no gradient)
            ids = self.vocab.encode(self.view.text(vi))[: L - 2]
            ids = ids[:max((t - 1) // 2, 1)]
            text = self.vocab.decode(ids)
            targets[k], tl[k] = self.vocab.encode_target(text, L)
            ctc[k, : len(ids)] = ids
            cl[k] = len(ids)
            texts.append(text)
        return Batch(rois, fl, targets, tl, ctc, cl, texts)


class BatchIterator:
    """Endless epochs of full batches: per epoch a seeded permutation,
    grouped by bucket into batches (a ragged remainder is dropped), the
    batches shuffled; ``state`` resumes it. ``shard=(index, count)`` yields
    part ``index`` of each global batch of ``batch_size`` (a data rank's
    rows, in the one-device order; the counterpart of
    ``shard_host_local_batch``'s per-host input)."""

    def __init__(self, dataset: BucketedDataset, batch_size: int,
                 seed: int = 0, epoch: int = 0, pos: int = 0,
                 shard: tuple[int, int] = (0, 1)):
        index, count = shard
        if batch_size % count or not 0 <= index < count:
            raise ValueError(f"a batch of {batch_size} does not split into "
                             f"part {index} of {count}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.seed = seed
        self.epoch = epoch
        self.pos = pos
        self._plan = self._make_plan(epoch)

    def _rows(self, members: list[int]) -> list[int]:
        """This part's rows of a global batch: the ``index``-th of
        ``count`` equal runs, in order."""
        index, count = self.shard
        n = len(members) // count
        return members[index * n:(index + 1) * n]

    def _make_plan(self, epoch: int) -> list[list[int]]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 0xDA7A]))
        order = rng.permutation(len(self.ds))
        plan = []
        for b in self.ds.buckets:
            members = [int(i) for i in order if self.ds.sample_bucket[i] == b]
            for lo in range(0, len(members) - self.batch_size + 1,
                            self.batch_size):
                plan.append(members[lo:lo + self.batch_size])
        rng.shuffle(plan)
        return plan

    @property
    def state(self) -> dict:
        return {"epoch": self.epoch, "pos": self.pos, "seed": self.seed}

    @classmethod
    def from_state(cls, dataset: BucketedDataset, batch_size: int,
                   state: dict, shard: tuple[int, int] = (0, 1)
                   ) -> "BatchIterator":
        """Resume at a saved ``state`` (epoch, position, seed)."""
        return cls(dataset, batch_size, seed=state["seed"],
                   epoch=state["epoch"], pos=state["pos"], shard=shard)

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        if self.pos >= len(self._plan):
            self.epoch += 1
            self.pos = 0
            self._plan = self._make_plan(self.epoch)
            if not self._plan:
                raise RuntimeError(
                    f"dataset too small for batch_size={self.batch_size}")
        batch = self.ds.make_batch(self._rows(self._plan[self.pos]))
        self.pos += 1
        return batch


def batch_to_device(batch: Batch, mean: float, std: float, device) -> dict:
    """A host ``Batch`` -> the dict of tensors on ``device`` that
    ``compute_loss`` takes, the ROIs normalised there: ((u8 / 255) - mean)
    / std, each division correctly rounded as the JAX package's."""
    import torch

    from lipreading_tpu_torch.ops.roi import true_div

    def put(x):
        return torch.as_tensor(x).to(device)

    rois = put(batch.rois_u8).float()
    return {
        "rois": true_div(true_div(rois, 255.0) - mean, std),
        "frame_lengths": put(batch.frame_lengths),
        "targets": put(batch.targets),
        "target_lengths": put(batch.target_lengths),
        "ctc_labels": put(batch.ctc_labels),
        "ctc_lengths": put(batch.ctc_lengths),
    }
