"""Training loop (counterpart of ``Trainer`` and ``FusedTrainer`` in
``lipreading_tpu/train/loop.py``), on one device, without a mesh.

``Trainer`` owns the model (float32 parameters), the optimizer
(``train.optim.AdamW``, optax's semantics), the step, checkpoints and the
JSONL metrics. One step: the hybrid loss (``models.lipreader.compute_loss``
with dropout and the ROI jitter drawn from the step's generator), its
gradients, the global norm of the unclipped gradients, one optimizer update.
The step's generator is seeded from ``(cfg.train.seed, step)`` alone, so a
restored run replays the same dropout masks.

``FusedTrainer`` takes raw uint8 frame batches (``data.pipeline.VideoBatch``)
and runs the untracked preprocessing (detector, ERT, ROI kernel) on the
device inside the step, without gradients, as the JAX step takes none
through it; on a CUDA device the step's CTC loss runs the lattice kernels.

Later slices: the dataview batches (``data/dataset.py``), the tracked fused
step, ``remat`` and ``evaluate`` (a held-out eval on the joint beam).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from lipreading_tpu_torch.config import Config
from lipreading_tpu_torch.io import from_jax_params, to_jax_params
from lipreading_tpu_torch.models.lipreader import compute_loss, init_model
from lipreading_tpu_torch.text import Vocab
from lipreading_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from lipreading_tpu_torch.train.metrics_log import MetricsLogger
from lipreading_tpu_torch.train.optim import AdamW

EVAL_SLICE = ("evaluate (the held-out eval on the joint CTC/attention beam, "
              "infer.transcribe at beam_width 8) is ROADMAP queue 1 item 9, "
              "step 4, a later slice of the port")


def eval_falls(step: int, steps: int, eval_every: int) -> bool:
    """Whether a run of ``steps`` updates from ``step`` reaches a multiple of
    ``eval_every`` (0 = never)."""
    return bool(eval_every) and (step + steps) // eval_every > step // eval_every


def step_seed(seed: int, step: int) -> int:
    """The seed of the generator of training step ``step``."""
    return int(np.random.SeedSequence([seed, 0x0D0, step])
               .generate_state(1, np.uint64)[0] >> 1)


class _StageClock:
    """Host-clock milliseconds of a step's stages, each closed by a
    synchronise of the device (off unless a dict is given)."""

    def __init__(self, out: dict | None, device: torch.device):
        self.out, self.device = out, device
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + (now - self.t) * 1e3
        self.t = now


def _batch_dims(batch):
    """(B, T, valid frames, longest target) of a VideoBatch or a dict."""
    if isinstance(batch, dict):
        B, T = batch["rois"].shape[:2]
        fl, tl = batch["frame_lengths"], batch["target_lengths"]
    else:
        B, T = batch.frames.shape[:2]
        fl, tl = batch.frame_lengths, batch.target_lengths
    return B, T, int(np.asarray(fl).sum()), int(np.asarray(tl).max())


class Trainer:
    """Owns the model, the optimizer state, the step and checkpoints.

    ``train_step`` takes a model batch: a dict of ``rois`` (normalised
    float32 [B, T, R, R]), ``frame_lengths``, ``targets``,
    ``target_lengths``, ``ctc_labels`` and ``ctc_lengths`` (numpy or
    tensors)."""

    def __init__(self, cfg: Config, workdir: str,
                 device: str | torch.device = "cuda"):
        if cfg.train.remat:
            raise NotImplementedError(
                "train.remat: recomputing the frontend in the backward is a "
                "later slice of the port (ROADMAP queue 1 item 9)")
        self.cfg = cfg
        self.workdir = workdir
        self.device = torch.device(device)
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=1, default=str)
        self.vocab = Vocab()
        self.logger = MetricsLogger(os.path.join(workdir, "logs"))
        gen = torch.Generator().manual_seed(cfg.train.seed)
        self.model = init_model(cfg, gen, self.device)
        self.opt = AdamW(self.model, cfg.train)
        self.step = 0

    # --- one step ------------------------------------------------------------

    def step_generator(self) -> torch.Generator:
        """The generator of the current step's dropout and ROI jitter."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.cfg.train.seed, self.step))
        return gen

    def _update(self, model_batch: dict, gen, clock: _StageClock) -> dict:
        for p in self.model.parameters():
            p.grad = None
        loss, metrics = compute_loss(self.model, self.cfg, model_batch,
                                     train=True, gen=gen)
        clock.mark("forward")
        loss.backward()
        clock.mark("backward")
        metrics["grad_norm"] = self.opt.update()
        clock.mark("optimizer")
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch: dict, stage_ms: dict | None = None) -> dict:
        """One update from a model batch; returns the step's metrics as
        tensors (loss, ctc_loss, att_loss, grad_norm). ``stage_ms``, if
        given, receives each stage's synchronised host milliseconds."""
        clock = _StageClock(stage_ms, self.device)
        dev = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        clock.mark("host_to_device")
        metrics = self._update(dev, self.step_generator(), clock)
        self.step += 1
        return metrics

    # --- the loop ------------------------------------------------------------

    def fit(self, iterator, steps: int | None = None) -> dict:
        """``steps`` updates (default ``train.total_steps``) from
        ``iterator``, logging every ``log_every`` and checkpointing every
        ``checkpoint_every`` steps. Refuses before its first step when the
        run reaches ``train.eval_every``: ``evaluate`` is not ported yet."""
        t_cfg = self.cfg.train
        steps = steps if steps is not None else t_cfg.total_steps
        if eval_falls(self.step, steps, t_cfg.eval_every):
            raise NotImplementedError(
                f"fit: steps {self.step + 1}..{self.step + steps} reach "
                f"train.eval_every={t_cfg.eval_every}, but {EVAL_SLICE}; run "
                "fewer steps or set train.eval_every=0")
        from lipreading_tpu_torch.flops import (
            device_peak_flops,
            train_step_flops,
        )

        peak = (device_peak_flops(self.cfg.model.dtype)
                if self.device.type == "cuda" else None)
        last = {}
        t0 = time.perf_counter()
        window_frames = 0
        window_flops = 0.0
        for _ in range(steps):
            batch = next(iterator)
            metrics = self.train_step(batch)
            B, T, frames, L = _batch_dims(batch)
            window_frames += frames
            window_flops += train_step_flops(self.cfg, B, T, L)
            if self.step % t_cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
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
            if (t_cfg.checkpoint_every
                    and self.step % t_cfg.checkpoint_every == 0):
                self.save(iterator)
        return last

    def evaluate(self, batches, beam=None) -> dict:
        raise NotImplementedError(EVAL_SLICE)

    # --- checkpointing -------------------------------------------------------

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.workdir, "ckpt")

    def save(self, iterator=None) -> str:
        return save_checkpoint(
            self.ckpt_dir, self.step, to_jax_params(self.model.state_dict()),
            self.opt.state_tree(),
            iterator_state=iterator.state if iterator else None,
            extra={"config": self.cfg.name})

    def _load_params(self, tree) -> None:
        sd = from_jax_params(tree, self.cfg)
        with torch.no_grad():
            for k, p in self.model.state_dict().items():
                if k not in sd:
                    raise KeyError(f"parameter {k} missing from the tree")
                if tuple(sd[k].shape) != tuple(p.shape):
                    raise ValueError(f"parameter {k}: shape "
                                     f"{tuple(sd[k].shape)}, want "
                                     f"{tuple(p.shape)}")
                p.copy_(sd[k])
        extra = set(sd) - set(self.model.state_dict())
        if extra:
            raise KeyError(f"the tree holds parameters this model lacks: "
                           f"{sorted(extra)[:5]}")

    def warm_start(self, params) -> None:
        """Parameters only, from a tree (a release or a checkpoint's
        params): fresh optimizer state, step 0."""
        self._load_params(params)
        self.opt = AdamW(self.model, self.cfg.train)
        self.step = 0

    def restore(self, path: str | None = None) -> dict:
        """Resume from a checkpoint (the latest in ``ckpt_dir`` if None);
        returns the saved iterator state ({} when there is none)."""
        path = path or latest_checkpoint(self.ckpt_dir)
        if path is None:
            return {}
        step, params, opt_state, it_state, _ = load_checkpoint(path)
        self._load_params(params)
        self.opt = AdamW(self.model, self.cfg.train)
        if opt_state is not None:
            self.opt.load_state_tree(opt_state)
        self.step = step
        return it_state


class FusedTrainer(Trainer):
    """Trainer whose step runs video -> ROI preprocessing on the device ahead
    of the model. ``det_params`` and ``ert_model`` come from
    ``ops.detector.params_to_torch`` and ``ops.ert.model_to_torch`` on the
    trainer's device."""

    def __init__(self, cfg: Config, workdir: str, det_params, ert_model,
                 device: str | torch.device = "cuda"):
        if cfg.preprocess.landmarker != "ert":
            raise NotImplementedError(
                f"landmarker {cfg.preprocess.landmarker!r}: training with "
                "the conv landmarker comes with the tracked fused step, a "
                "later slice of the port (ROADMAP queue 1 item 9, step 2)")
        super().__init__(cfg, workdir, device=device)
        self._det = det_params
        self._ert = ert_model

    def model_batch(self, dev: dict) -> dict:
        """Device batch with uint8 ``frames`` -> the model batch with
        ``rois`` (no gradients through preprocessing)."""
        from lipreading_tpu_torch.ops.preprocess import preprocess_clips

        with torch.no_grad():
            rois = preprocess_clips(self._det, self._ert, dev["frames"],
                                    self.cfg.preprocess)
        mb = dict(dev, rois=rois)
        del mb["frames"]
        return mb

    def train_step(self, batch, stage_ms: dict | None = None) -> dict:
        """One update from a ``VideoBatch``; see ``Trainer.train_step``."""
        from lipreading_tpu_torch.data.pipeline import video_batch_to_device

        clock = _StageClock(stage_ms, self.device)
        dev = video_batch_to_device(batch, self.device)
        clock.mark("host_to_device")
        gen = self.step_generator()
        mb = self.model_batch(dev)
        clock.mark("preprocess")
        metrics = self._update(mb, gen, clock)
        self.step += 1
        return metrics
