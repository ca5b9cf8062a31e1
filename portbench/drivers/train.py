"""Fine-tuning through the program's training step
(``lipreading_tpu_torch.train.loop.Trainer.train_step``), warm-started from
the release (``Trainer.warm_start``): a closed loop of steps.

Traffic parameters (``traffic/<mix>.json``): ``B`` rows a batch of
``bucket`` frames of ``roi`` x ``roi`` uint8 ROIs, drawn from ``--seed`` on
the card and normalised there as ``data/dataset.batch_to_device`` does
(zero past each row's length, as a dataview batch is); transcripts from the
frozen ``sample_text`` (a pool of ``B`` drawn from ``text_seed``, the same
for every seed, so every batch has the same lengths; each batch takes them
in an order drawn from ``--seed``), ``frames_per_char`` frames a character
up to the bucket; targets and CTC labels as the dataview batches build them
(``frozen/text.labels``); ``distinct`` batches cycled through.

Set-up builds the trainer, warm-starts it, and runs the first three steps
on batches 0, 1 and 2 (they warm up every shape and are the steps the
comparison follows; dropout and the ROI jitter on, as the release trains,
and the reference draws each step's masks and jitter again from the
step's seed): each step's losses, the first gradient as the
optimizer holds it (its first moment after one step over 1 - beta1), and
the parameters' change over the three steps are kept. The window steps on
through the batches with one step in flight: a step counts where it was
done (its completion read by the host) before the window's end.
``--trace 1`` passes ``stage_ms`` to each step (the program's synchronised
stage clock), then profiles a few unmarked steps."""

from __future__ import annotations

import json
import math
import tempfile
import time

import numpy as np
import torch

from portbench.frozen import flops as FL
from portbench.frozen import roofline as RF
from portbench.frozen import text as tx
from portbench.frozen.fixtures import sample_text

B1 = 0.9


class Driver:
    def __init__(self, cell, seed, device, assets_dir, log):
        self.cell, self.seed, self.device = cell, seed, device
        self.assets_dir, self.log = assets_dir, log
        self.tr = cell.traffic
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7A1]))

    # --- inputs ------------------------------------------------------------

    def _batches(self):
        tr, cfg = self.tr, self.cell.conf["config"]
        B, T, R = tr["B"], tr["bucket"], tr["roi"]
        trng = np.random.default_rng(np.random.SeedSequence(
            [0x7E47, tr["text_seed"]]))
        texts = [sample_text(trng) for _ in range(B)]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.rng.integers(0, 2 ** 62)))
        L = cfg["data"]["max_chars"]
        self.batches = []
        for _ in range(tr["distinct"]):
            rows = [texts[i] for i in self.rng.permutation(B)]
            fl = np.asarray([min(tr["frames_per_char"] * len(t), T)
                             for t in rows], np.int32)
            tg = np.zeros((B, L), np.int32)
            tl = np.zeros((B,), np.int32)
            cl = np.zeros((B, L), np.int32)
            cn = np.zeros((B,), np.int32)
            for k, t in enumerate(rows):
                tg[k], tl[k], ids = tx.labels(t, int(fl[k]), L)
                cl[k, :len(ids)] = ids
                cn[k] = len(ids)
            u8 = torch.randint(0, 256, (B, T, R, R), generator=gen,
                               device=self.device, dtype=torch.uint8)
            live = (torch.arange(T, device=self.device)[None]
                    < torch.from_numpy(fl).to(self.device)[:, None])
            u8 = u8 * live[:, :, None, None].to(torch.uint8)
            host = {"frame_lengths": fl, "targets": tg, "target_lengths": tl,
                    "ctc_labels": cl, "ctc_lengths": cn}
            dev = {k: torch.from_numpy(v).to(self.device)
                   for k, v in host.items()}
            self.batches.append({"u8": u8, "host": host, "dev": dev})

    def model_batch(self, j: int) -> dict:
        """Batch ``j`` as the dict ``train_step`` takes: the ROIs
        normalised on the card, ((u8 / 255) - mean) / std, each division
        correctly rounded."""
        pre = self.cell.conf["config"]["preprocess"]
        b = self.batches[j]

        def div(x, d):
            return x / torch.tensor(d, dtype=x.dtype, device=x.device)

        rois = div(div(b["u8"].float(), 255.0) - pre["normalize_mean"],
                   pre["normalize_std"])
        return {"rois": rois, **b["dev"]}

    # --- set-up ------------------------------------------------------------

    def setup(self):
        from lipreading_tpu_torch import io
        from lipreading_tpu_torch.train.loop import Trainer

        conf = self.cell.conf
        tree, cfg = io.load_release(conf["release"], self.assets_dir)
        if json.loads(json.dumps(cfg.to_dict())) != conf["config"]:
            raise RuntimeError("the release's configuration is not the "
                               "configuration file's")
        self.work = tempfile.TemporaryDirectory()
        self._batches()
        tr = Trainer(cfg, self.work.name, self.device)
        tr.warm_start(tree)
        self.trainer = tr
        self.p0 = {k: p.detach().cpu().clone()
                   for k, p in tr.model.named_parameters()}
        self.losses = []
        for j in range(3):
            m = tr.train_step(self.model_batch(j))
            self.losses.append((float(m["ctc_loss"]), float(m["att_loss"])))
            if j == 0:
                self.g1 = {k: (v / (1 - B1)).cpu()
                           for k, v in tr.opt.mu.items()}
        self.p3 = {k: p.detach().cpu().clone()
                   for k, p in tr.model.named_parameters()}
        self.next = 3

    # --- the window --------------------------------------------------------

    def _step(self, stage_ms=None):
        j = self.next % len(self.batches)
        self.next += 1
        self.trainer.train_step(self.model_batch(j), stage_ms=stage_ms)
        return int(self.batches[j]["host"]["frame_lengths"].sum())

    def _sync_point(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def window(self, seconds: float, marked: bool) -> dict:
        spans: dict[str, float] = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        start = time.perf_counter()
        deadline, end = start + seconds, start
        frames = steps = attempted = 0
        pending, unit_s = None, []
        while True:
            launching = time.perf_counter() < deadline
            if launching:
                stage = {} if marked else None
                n = self._step(stage)
                attempted += 1
                if stage:
                    for s, ms in stage.items():
                        spans[s] = spans.get(s, 0.0) + ms
                mine = (self._sync_point(), n)
            if pending is not None:
                if pending[0] is not None:
                    pending[0].synchronize()
                t = time.perf_counter()
                if t <= deadline:
                    unit_s.append(t - end)
                    end, frames, steps = t, frames + pending[1], steps + 1
            if not launching:
                break
            pending = mine
        self.step_s = (end - start) / steps if steps else None
        return {"start": start, "seconds": end - start, "frames": frames,
                "units": steps, "attempted": attempted, "failed": 0,
                "spans_ms": spans, "span_units": attempted if marked else 0,
                "unit_s": unit_s}

    def profile(self) -> dict:
        from portbench.harness import profiled

        step_s = self.step_s or 1.0
        k = min(10, max(3, math.ceil(1.0 / step_s)))
        js = [(self.next + i) % len(self.batches) for i in range(k)]
        cfg = self.cell.conf["config"]
        flops, ctc = 0.0, []
        for j in js:
            h = self.batches[j]["host"]
            B, T = self.tr["B"], self.tr["bucket"]
            flops += FL.train_step_flops(cfg, B, T,
                                         int(h["target_lengths"].max()))
            ctc.append(RF.ctc_work(h["frame_lengths"], h["ctc_labels"],
                                   h["ctc_lengths"], T))

        def steps():
            for _ in js:
                self._step()

        _, summary = profiled(steps, self.log, gaps_fn=self._step)
        summary.update(units=k, flops=flops, ctc_launches=ctc)
        return summary

    # --- the comparison ----------------------------------------------------

    def release(self):
        del self.trainer
        self.work.cleanup()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec=None, rows=None):
        """-> (the release's parameters, the reference's first three
        steps from them on batches 0, 1 and 2: ``ref/train.run_steps``)."""
        from portbench.ref import model as M
        from portbench.ref import train as RT
        from portbench.ref import weights as W

        conf = self.cell.conf
        Pn, _ = W.load_release(self.assets_dir, conf["release"])
        P0 = {k: torch.from_numpy(v.copy()).to(self.device)
              for k, v in Pn.items()}
        batches = [self.model_batch(j) for j in range(3)]
        return P0, RT.run_steps(P0, conf["config"], batches,
                                prec or M.Prec(), rows)

    def check(self) -> dict:
        _, ref = self.reference()
        return compare(self.losses, self.g1, self.p0, self.p3, *ref)


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    """Largest |norm(prog leaf) - norm(ref leaf)| over the leaves ``keys``,
    each against the larger of its reference norm and the median leaf's."""
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
               for k in keys)


def compare(losses_p, g1_p, p0, p3, losses_r, g1_r, dp_r) -> dict:
    """The training comparison: the largest relative gap of the three
    steps' CTC and attention losses, and by the worst leaf, the first
    gradient's norm and the parameters' change over the three steps. A
    leaf whose reference gradient norm is below a thousandth of the median
    leaf's is left out (its moves are round-off under Adam)."""
    loss = max(abs(a - b) / abs(b) for lp, lr in zip(losses_p, losses_r)
               for a, b in zip(lp, lr))
    g1_r = {k: v.cpu() for k, v in g1_r.items()}
    norms = {k: float(v.double().norm()) for k, v in g1_r.items()}
    med = float(np.median(list(norms.values())))
    keys = [k for k in g1_r if norms[k] >= 1e-3 * med]
    dp_p = {k: p3[k] - p0[k] for k in p0}
    dp_r = {k: v.cpu() for k, v in dp_r.items()}
    out = {"loss_gap": loss, "grad_gap": leaf_gap(g1_p, g1_r, keys),
           "update_gap": leaf_gap(dp_p, dp_r, keys)}
    return {k: (v if math.isfinite(v) else float("nan"))
            for k, v in out.items()}
