"""Training loop (counterpart of ``Trainer`` and ``FusedTrainer`` in
``lipreading_tpu/train/loop.py``), on one device or over a mesh of ranks.

``Trainer`` owns the model (float32 parameters), the optimizer
(``train.optim.AdamW``, optax's semantics), the step, checkpoints, the
JSONL metrics and the held-out evaluation. Its step takes a dataview batch
(``data.dataset.Batch``: uint8 ROIs, normalised on the device by
``batch_to_device``) or a dict of normalised ROIs. One step: the model's
loss (``models.lipreader.compute_loss`` with dropout and the ROI jitter
drawn from the step's generator), its gradients, the global norm of the
unclipped gradients, one optimizer update. The step's generator is seeded
from ``(cfg.train.seed, step)`` alone, so a restored run replays the same
dropout masks. ``fit`` evaluates on held-out batches every
``train.eval_every`` steps: ``infer.transcribe`` at ``train.beam_width``
(the joint CTC/attention beam for the hybrid decoder), CER and WER, and one
sample decode, in the metrics log.

``FusedTrainer`` takes raw uint8 frame batches (``data.pipeline.VideoBatch``)
and runs the preprocessing on the device inside the step, without
gradients, as the JAX step takes none through it: untracked (detector, ERT
or conv landmarker, ROI kernel), or tracked (presence head, ``track_boxes``)
with each sample's faceless frames compacted away and a sample with none
left weighted out of the loss. On a CUDA device the step's CTC loss runs the
lattice kernels.

Over a mesh (``parallel/mesh.py``: one process a rank, ``torch.distributed``
initialised, ``cfg.mesh`` read) each rank steps on its rows of the global
batch and the step equals the one-device step on that batch:

* each loss divides by its global denominator (``compute_loss`` with the
  mesh), and ``reduce_gradients`` sums the gradients over the data axis;
* over the model axis, a gradient is summed only where a rank holds a part
  of it (``model_reduced``): under sequence parallelism the frontend and
  the encoder (each rank saw its time block), under pipeline parallelism
  the encoder's layers (each lives on its stage); what runs identically on
  every model rank (heads, decoder, under pipeline parallelism the
  frontend, ``proj``, ``pos`` and ``ln_out``) is not summed, nor are
  tensor-parallel parts (each rank owns its own);
* under tensor parallelism (``model_parallel`` > 1 without sequence or
  pipeline parallelism) the transformer layers hold this rank's columns
  and rows, the optimizer's clipping norm is the whole tree's, and
  ``save``, ``evaluate``, ``restore`` and ``warm_start`` gather or cut
  them; checkpoints are the one-device files, byte for byte.

Only global rank 0 writes ``config.json``, the metrics log and checkpoints.
Every rank evaluates on the whole held-out batches with whole parameters.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from lipreading_tpu_torch import profiling
from lipreading_tpu_torch.config import Config
from lipreading_tpu_torch.data.dataset import Batch, batch_to_device
from lipreading_tpu_torch.io import from_jax_params, to_jax_params
from lipreading_tpu_torch.models.lipreader import (
    LipReader,
    compute_loss,
    init_model,
)
from lipreading_tpu_torch.parallel import comm
from lipreading_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_host_local_batch,
    shard_params_,
)
from lipreading_tpu_torch.text import Vocab
from lipreading_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from lipreading_tpu_torch.train.metrics_log import MetricsLogger
from lipreading_tpu_torch.train.optim import AdamW

def step_seed(seed: int, step: int, data_index: int | None = None) -> int:
    """The seed of the generator of training step ``step`` (on data rank
    ``data_index`` when the batch splits over several: each draws its own
    rows' dropout masks and jitter)."""
    entropy = [seed, 0x0D0, step] + ([] if data_index is None
                                     else [data_index])
    return int(np.random.SeedSequence(entropy)
               .generate_state(1, np.uint64)[0] >> 1)


def model_reduced(names, cfg: Config, mp: int) -> list[str]:
    """The parameters whose gradients are summed over the model axis: each
    model rank holds a part of them (the module doc)."""
    if mp == 1:
        return []
    if cfg.mesh.sequence_parallel:
        return [n for n in names if n.startswith(("frontend.", "encoder."))]
    if cfg.mesh.pipeline_parallel:
        return [n for n in names if n.startswith("encoder.layers.")]
    return []


def _sum_flat(tensors: list[torch.Tensor], axis: comm.Axis) -> None:
    """Sum the tensors over ``axis`` in place, as one flat all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    comm.all_reduce_(flat, axis)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


@torch.no_grad()
def reduce_gradients(model: torch.nn.Module, mesh, cfg: Config) -> None:
    """Every parameter's gradient (None counts as zero) summed as the module
    doc sets out: over the model axis for ``model_reduced``, then over the
    data axis."""
    named = dict(model.named_parameters())
    for p in named.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    over_model = model_reduced(named, cfg, mesh.mp)
    if over_model:
        _sum_flat([named[n].grad for n in over_model], mesh.model)
    if mesh.data.group is not None:
        _sum_flat([p.grad for p in named.values()], mesh.data)


class _Silent:
    """The metrics log of a rank other than 0."""

    def log(self, *a, **k) -> None:
        pass

    log_text = log


def _no_mark(stage: str) -> None:
    pass


def _batch_dims(batch):
    """(B, T, valid frames, longest target) of a Batch, VideoBatch or
    dict."""
    if isinstance(batch, dict):
        B, T = batch["rois"].shape[:2]
        fl, tl = batch["frame_lengths"], batch["target_lengths"]
    else:
        x = batch.rois_u8 if isinstance(batch, Batch) else batch.frames
        B, T = x.shape[:2]
        fl, tl = batch.frame_lengths, batch.target_lengths
    return B, T, int(np.asarray(fl).sum()), int(np.asarray(tl).max())


class Trainer:
    """Owns the model, the optimizer state, the step, checkpoints and the
    evaluation.

    ``train_step`` takes a ``data.dataset.Batch``, or a model batch: a dict
    of ``rois`` (normalised float32 [B, T, R, R]), ``frame_lengths``,
    ``targets``, ``target_lengths``, ``ctc_labels`` and ``ctc_lengths``
    (numpy or tensors)."""

    def __init__(self, cfg: Config, workdir: str,
                 device: str | torch.device = "cuda", mesh=None):
        self.cfg = cfg
        self.workdir = workdir
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh)
        self.chief = self.mesh.rank == 0
        if self.chief:
            os.makedirs(workdir, exist_ok=True)
            with open(os.path.join(workdir, "config.json"), "w") as f:
                json.dump(cfg.to_dict(), f, indent=1, default=str)
        self.vocab = Vocab()
        self.logger = (MetricsLogger(os.path.join(workdir, "logs"))
                       if self.chief else _Silent())
        sp, pp = cfg.mesh.sequence_parallel, cfg.mesh.pipeline_parallel
        if (sp or pp) and cfg.encoder != "transformer":
            raise ValueError(
                "mesh.sequence_parallel/pipeline_parallel need "
                "encoder='transformer'")
        gen = torch.Generator().manual_seed(cfg.train.seed)
        self.model = replicate(init_model(cfg, gen, self.device), self.mesh)
        self.tp = (shard_params_(self.model, self.mesh)
                   if self.mesh.mp > 1 and not (sp or pp) else None)
        self.opt = AdamW(self.model, cfg.train, tp=self.tp)
        self.step = 0

    # --- one step ------------------------------------------------------------

    def step_generator(self) -> torch.Generator:
        """The generator of the current step's dropout and ROI jitter."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(
            self.cfg.train.seed, self.step,
            self.mesh.data_index if self.mesh.dp > 1 else None))
        return gen

    def _update(self, model_batch: dict, gen, mark) -> dict:
        for p in self.model.parameters():
            p.grad = None
        mesh = self.mesh if self.mesh.distributed else None
        loss, metrics = compute_loss(self.model, self.cfg, model_batch,
                                     train=True, gen=gen, mesh=mesh)
        mark("forward")
        loss.backward()
        profiling.backward_done()
        mark("backward")
        if mesh is not None:
            reduce_gradients(self.model, mesh, self.cfg)
            mark("reduce")
        metrics["grad_norm"] = self.opt.update()
        mark("optimizer")
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None and mesh.data.group is not None:
            # each rank's losses are its shares of the global means
            keys = [k for k in metrics if k != "grad_norm"]
            total = comm.all_reduce_(torch.stack([metrics[k] for k in keys]),
                                     mesh.data)
            metrics.update(zip(keys, total))
        return metrics

    def check_rows(self, batch):
        """A rank's batch of a global batch split over several data ranks
        must hold ``data.batch_size / dp`` rows."""
        if self.mesh.dp > 1:
            shard_host_local_batch(batch, self.mesh, self.cfg.data.batch_size)
        return batch

    def device_batch(self, batch) -> dict:
        """A Batch (normalised on the device) or a dict -> the model batch
        on the trainer's device."""
        if isinstance(batch, Batch):
            p = self.cfg.preprocess
            return batch_to_device(batch, p.normalize_mean, p.normalize_std,
                                   self.device)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items() if k != "texts"}

    def train_step(self, batch, stage_ms: dict | None = None) -> dict:
        """One update from a Batch or a model batch dict (over a mesh, this
        rank's rows); returns the step's metrics as tensors (loss, ctc_loss,
        att_loss, grad_norm; over a mesh the global batch's).
        ``stage_ms``, if given, receives each stage's synchronised host
        milliseconds, and the step is traced
        (``profiling.unit("train.step")``)."""
        with self._traced(stage_ms) as mark:
            dev = self.device_batch(self.check_rows(batch))
            mark("host_to_device")
            metrics = self._update(dev, self.step_generator(), mark)
            self.step += 1
        return metrics

    @contextlib.contextmanager
    def _traced(self, stage_ms: dict | None):
        """A step traced from entry to return, yielding the mark of its
        stage clock (``profiling.StageClock`` over the whole device), where
        ``stage_ms`` is given; else untraced, with a mark that does
        nothing."""
        if stage_ms is None:
            mark, traced = _no_mark, None
        else:
            mark = profiling.StageClock(self.device, stage_ms,
                                        whole_device=True).mark
            traced = self.device
        with profiling.unit("train.step", traced):
            yield mark

    # --- the loop ------------------------------------------------------------

    def fit(self, iterator, steps: int | None = None,
            eval_batches: list | None = None) -> dict:
        """``steps`` updates (default ``train.total_steps``) from
        ``iterator``, logging every ``log_every``, evaluating on
        ``eval_batches`` every ``eval_every`` and checkpointing every
        ``checkpoint_every`` steps. Over a mesh the logged frames/s and
        TFLOP/s are the global batch's (the data ranks' summed) and the MFU
        is against the peak of one card a rank."""
        t_cfg = self.cfg.train
        steps = steps if steps is not None else t_cfg.total_steps
        from lipreading_tpu_torch.flops import (
            device_peak_flops,
            train_step_flops,
        )

        peak = (device_peak_flops(self.cfg.model.dtype)
                if self.device.type == "cuda" else None)
        if peak and self.mesh.distributed:
            peak *= self.mesh.devices
        last = {}
        t0 = time.perf_counter()
        window_frames = 0
        window_flops = 0.0
        for _ in range(steps):
            batch = next(iterator)
            metrics = self.train_step(batch)
            B, T, frames, L = _batch_dims(batch)
            window_frames += frames
            crop = batch["rois"].shape[-1] if isinstance(batch, dict) else None
            window_flops += train_step_flops(self.cfg, B, T, L, crop)
            if self.step % t_cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                if self.mesh.data.group is not None:
                    window_frames, window_flops = comm.all_reduce_(
                        torch.tensor([window_frames, window_flops],
                                     dtype=torch.float64, device=self.device),
                        self.mesh.data).tolist()
                dt = time.perf_counter() - t0
                m["frames_per_sec"] = window_frames / dt if dt > 0 else 0.0
                m["tflops_per_sec"] = (window_flops / dt / 1e12
                                       if dt > 0 else 0.0)
                if peak and dt > 0:
                    m["mfu"] = window_flops / dt / peak
                m["epoch"] = iterator.epoch
                self.logger.log(self.step, **m)
                last = m
                t0 = time.perf_counter()
                window_frames = 0
                window_flops = 0.0
            if (t_cfg.eval_every and self.step % t_cfg.eval_every == 0
                    and eval_batches):
                last.update(self.evaluate(eval_batches))
            if (t_cfg.checkpoint_every
                    and self.step % t_cfg.checkpoint_every == 0):
                self.save(iterator)
        return last

    # --- evaluation ----------------------------------------------------------

    def eval_inputs(self, batch):
        """A held-out batch -> (ROIs [B, T, R, R], lengths [B]) on the
        device."""
        dev = self.device_batch(batch)
        return dev["rois"], dev["frame_lengths"]

    def evaluate(self, batches, beam: int | None = None) -> dict:
        """CER and WER of ``transcribe`` (beam ``train.beam_width`` unless
        ``beam``) on held-out batches (each with ``texts``); logs them and
        the first sample's decode."""
        from lipreading_tpu_torch.infer import transcribe
        from lipreading_tpu_torch.metrics import corpus_cer, corpus_wer

        model = self.whole_model()
        hyps, refs = [], []
        for b in batches:
            with torch.inference_mode():
                rois, lengths = self.eval_inputs(b)
            hyps.extend(transcribe(model, self.cfg, rois, lengths,
                                   beam=beam, vocab=self.vocab))
            refs.extend(b["texts"] if isinstance(b, dict) else b.texts)
        m = {"eval_cer": corpus_cer(hyps, refs),
             "eval_wer": corpus_wer(hyps, refs)}
        self.logger.log(self.step, **m)
        self.logger.log_text(self.step, "sample_decode",
                             f"hyp={hyps[0]!r} ref={refs[0]!r}")
        return m

    def whole_state_dict(self) -> dict:
        """The model's parameters whole (under tensor parallelism gathered
        from every model rank: all of them call it)."""
        sd = self.model.state_dict()
        return sd if self.tp is None else self.tp.full_state(sd)

    def whole_model(self) -> LipReader:
        """The model with whole parameters and no model axis: this one, or
        under tensor parallelism a copy gathered from the model ranks (which
        all call it), so a decode runs no collective."""
        if self.tp is None:
            return self.model
        whole = LipReader(self.cfg).to(self.device)
        whole.load_state_dict(self.whole_state_dict())
        return whole.eval()

    # --- checkpointing -------------------------------------------------------

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.workdir, "ckpt")

    def save(self, iterator=None) -> str:
        """Write a checkpoint of the whole parameters and optimizer state
        (global rank 0 writes; every rank calls it and waits for it)."""
        params = to_jax_params(self.whole_state_dict())
        opt_state = self.opt.state_tree()
        path = os.path.join(self.ckpt_dir, f"ckpt_{self.step:08d}.msgpack")
        if self.chief:
            path = save_checkpoint(
                self.ckpt_dir, self.step, params, opt_state,
                iterator_state=iterator.state if iterator else None,
                extra={"config": self.cfg.name})
        if self.mesh.distributed:
            self.mesh.barrier()
        return path

    def _load_params(self, tree) -> None:
        sd = from_jax_params(tree, self.cfg)
        with torch.no_grad():
            for k, p in self.model.state_dict().items():
                if k not in sd:
                    raise KeyError(f"parameter {k} missing from the tree")
                src = sd[k] if self.tp is None else self.tp.local(k, sd[k])
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"parameter {k}: shape "
                                     f"{tuple(src.shape)}, want "
                                     f"{tuple(p.shape)}")
                p.copy_(src)
        extra = set(sd) - set(self.model.state_dict())
        if extra:
            raise KeyError(f"the tree holds parameters this model lacks: "
                           f"{sorted(extra)[:5]}")

    def warm_start(self, params) -> None:
        """Parameters only, from a tree (a release or a checkpoint's
        params): fresh optimizer state, step 0."""
        self._load_params(params)
        self.opt = AdamW(self.model, self.cfg.train, tp=self.tp)
        self.step = 0

    def restore(self, path: str | None = None) -> dict:
        """Resume from a checkpoint (the latest in ``ckpt_dir`` if None);
        returns the saved iterator state ({} when there is none)."""
        path = path or latest_checkpoint(self.ckpt_dir)
        if path is None:
            return {}
        step, params, opt_state, it_state, _ = load_checkpoint(path)
        self._load_params(params)
        self.opt = AdamW(self.model, self.cfg.train, tp=self.tp)
        if opt_state is not None:
            self.opt.load_state_tree(opt_state)
        self.step = step
        return it_state


class FusedTrainer(Trainer):
    """Trainer whose step runs video -> ROI preprocessing on the device ahead
    of the model. ``det_params``, ``landmarker`` and ``presence`` come from
    ``io.load_preprocessors`` on the trainer's device: the landmarker is the
    ERT or the conv landmarker (``cfg.preprocess.landmarker``), and
    ``tracked=True`` (which needs the presence head) runs the tracked
    preprocessing and compacts each sample's confident frames to its front
    (``ops.tracking.compact_valid_frames``) before the model."""

    def __init__(self, cfg: Config, workdir: str, det_params, landmarker,
                 device: str | torch.device = "cuda", presence=None,
                 tracked: bool = False, mesh=None):
        if tracked and presence is None:
            raise ValueError("tracked=True requires the presence head")
        super().__init__(cfg, workdir, device=device, mesh=mesh)
        self._det = det_params
        self._lmk = landmarker
        self._presence = presence
        self._tracked = tracked

    def preprocess(self, frames: torch.Tensor, lengths: torch.Tensor):
        """uint8 frames [B, T, H, W, 3] and lengths on the device -> (ROIs,
        lengths): tracked, the confident frames compacted and the lengths
        counting them."""
        from lipreading_tpu_torch.ops.preprocess import (
            preprocess_clips,
            preprocess_clips_tracked,
        )
        from lipreading_tpu_torch.ops.tracking import compact_valid_frames

        pre = self.cfg.preprocess
        if not self._tracked:
            return preprocess_clips(self._det, self._lmk, frames, pre), lengths
        rois, valid = preprocess_clips_tracked(self._det, self._presence,
                                               self._lmk, frames, pre)
        return compact_valid_frames(rois, valid, lengths)

    def model_batch(self, dev: dict) -> dict:
        """Device batch with uint8 ``frames`` -> the model batch with
        ``rois`` (no gradients through preprocessing). Tracked, the CTC
        labels are cut to what the confident frames can align, as the
        dataview batches' are, and a sample left with no frame weighs
        nothing (its lengths are clamped to 1 for the shapes' sake)."""
        with torch.no_grad():
            rois, new_len = self.preprocess(dev["frames"],
                                            dev["frame_lengths"])
        mb = dict(dev, rois=rois)
        del mb["frames"]
        if self._tracked:
            mb["ctc_lengths"] = torch.minimum(
                dev["ctc_lengths"], torch.clamp((new_len - 1) // 2, min=1))
            mb["sample_weight"] = (new_len > 0).float()
            mb["frame_lengths"] = torch.clamp(new_len, min=1)
        return mb

    def train_step(self, batch, stage_ms: dict | None = None) -> dict:
        """One update from a ``VideoBatch``; see ``Trainer.train_step``."""
        from lipreading_tpu_torch.data.pipeline import video_batch_to_device

        with self._traced(stage_ms) as mark:
            dev = video_batch_to_device(self.check_rows(batch), self.device)
            mark("host_to_device")
            gen = self.step_generator()
            mb = self.model_batch(dev)
            mark("preprocess")
            metrics = self._update(mb, gen, mark)
            self.step += 1
        return metrics

    def eval_inputs(self, batch):
        """A held-out ``VideoBatch`` -> the ROIs and lengths the model
        reads: the whole batch preprocessed, then (tracked) compacted."""
        frames = torch.as_tensor(batch.frames, device=self.device)
        lengths = torch.as_tensor(batch.frame_lengths, device=self.device)
        return self.preprocess(frames, lengths)
