"""Training from the seed (no release): a model built by the program's
``Trainer`` from the configuration's ``train.seed`` steps through
``Trainer.train_step`` in a closed loop, on length-sorted batches of
clips of many lengths. The interface is ``drivers/train.py``'s.

Traffic parameters (``traffic/<mix>.json``): ``clips`` clip lengths drawn
from ``--seed`` uniform in [``min_frames``, ``max_frames``], sorted and
split into ``clips / B`` batches of ``B`` (length-sorted batching, as the
recipe's loader does it); each batch padded to its longest clip rounded up
to a multiple of ``pad_to`` (at most ``bucket``). The uint8 ``roi`` x
``roi`` ROIs are drawn from the seed on the card, each clip cut to a
``crop`` x ``crop`` window at an offset drawn from the seed, normalised
there as ``drivers/train.py`` does and then set to 0 past its length (the
recipe's collate pads the normalised clips with 0). Each clip
carries one token a ``frames_per_token`` real frames, ids uniform in
[``token_lo``, ``token_hi``] (CTC labels bare; decoder targets framed by
sos = eos = vocab_size - 1, 0 after). The batches are cycled in an order
drawn from the seed, with the longest batch among the first three.

Set-up builds the trainer, copies its initial parameters and BatchNorm
statistics, runs the first three steps of the order (the steps the
comparison follows; dropout on, the reference draws each step's masks
again from its seed), then one step of every other batch shape. The
comparison (``compare``) is ``drivers/train.py``'s, with the BatchNorm
running statistics among the leaves of ``update_gap``; the reference is
``ref/conformer.run_steps`` from the initial state.

``python3 -m portbench.drivers.train_seeded --workload <cell> --seeds ...``
runs ``control.py``'s readings of a cell of this driver: ``control.py``
takes ``drivers/train.py``'s ``Driver`` and ``compare`` by name, and this
points them here first. ``python3 portbench/control.py`` on such a cell
fails in the release driver's set-up (the configuration has no
``release``); this entry refuses a cell of any other driver."""

from __future__ import annotations

import json
import math
import sys
import tempfile

import numpy as np
import torch

from portbench.drivers import train as base
from portbench.frozen import flops_conformer as FC
from portbench.frozen import roofline as RF

_train_compare = base.compare


class Driver(base.Driver):

    # --- inputs ------------------------------------------------------------

    def _batches(self):
        tr, cfg = self.tr, self.cell.conf["config"]
        B, R, C = tr["B"], tr["roi"], tr["crop"]
        V = cfg["model"]["vocab_size"]
        n = tr["clips"] // B
        lens = np.sort(self.rng.integers(
            tr["min_frames"], tr["max_frames"] + 1, size=n * B))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.rng.integers(0, 2 ** 62)))
        self.batches = []
        for i in range(n):
            fl = lens[i * B:(i + 1) * B].astype(np.int32)
            fl = fl[self.rng.permutation(B)]
            T = min(-(-int(fl.max()) // tr["pad_to"]) * tr["pad_to"],
                    tr["bucket"])
            fl = np.minimum(fl, T)
            cn = np.maximum(fl // tr["frames_per_token"], 1).astype(np.int32)
            ids = [self.rng.integers(tr["token_lo"], tr["token_hi"] + 1,
                                     size=k) for k in cn]
            cl = np.zeros((B, int(cn.max())), np.int32)
            tg = np.zeros((B, int(cn.max()) + 2), np.int32)
            for k, t in enumerate(ids):
                cl[k, :len(t)] = t
                tg[k, 0], tg[k, 1:len(t) + 1], tg[k, len(t) + 1] = V - 1, t, \
                    V - 1
            u8 = torch.randint(0, 256, (B, T, R, R), generator=gen,
                               device=self.device, dtype=torch.uint8)
            off = self.rng.integers(0, R - C + 1, size=(B, 2))
            u8 = torch.stack([u8[k, :, y:y + C, x:x + C]
                              for k, (y, x) in enumerate(off)])
            live = (torch.arange(T, device=self.device)[None]
                    < torch.from_numpy(fl).to(self.device)[:, None])
            host = {"frame_lengths": fl, "targets": tg,
                    "target_lengths": (cn + 2).astype(np.int32),
                    "ctc_labels": cl, "ctc_lengths": cn}
            dev = {k: torch.from_numpy(v).to(self.device)
                   for k, v in host.items()}
            self.batches.append({"u8": u8, "live": live, "host": host,
                                 "dev": dev, "T": T})
        order = self.rng.permutation(n)
        at = int(np.flatnonzero(order == n - 1)[0])
        if at >= 3:
            swap = int(self.rng.integers(0, 3))
            order[at], order[swap] = order[swap], order[at]
        self.order = [int(j) for j in order]

    def _config(self):
        from lipreading_tpu_torch.config import from_dict

        conf = self.cell.conf["config"]
        cfg = from_dict(conf)
        if json.loads(json.dumps(cfg.to_dict())) != conf:
            raise RuntimeError("the program's reading of the configuration "
                               "is not the configuration file's")
        return cfg

    def model_batch(self, j: int) -> dict:
        """``drivers/train.py``'s batch, the normalised ROIs 0 past each
        clip's length."""
        b = super().model_batch(j)
        live = self.batches[j]["live"]
        return {**b, "rois": b["rois"] * live[:, :, None, None]}

    @staticmethod
    def _state(model) -> dict:
        return {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}

    # --- set-up ------------------------------------------------------------

    def setup(self):
        from lipreading_tpu_torch.train.loop import Trainer

        cfg = self._config()
        self.work = tempfile.TemporaryDirectory()
        self._batches()
        tr = Trainer(cfg, self.work.name, self.device)
        self.trainer = tr
        self.p0 = self._state(tr.model)
        self.losses = []
        for j in self.order[:3]:
            m = tr.train_step(self.model_batch(j))
            self.losses.append((float(m["ctc_loss"]), float(m["att_loss"])))
            if len(self.losses) == 1:
                self.g1 = {k: (v / (1 - base.B1)).cpu()
                           for k, v in tr.opt.mu.items()}
        self.p3 = self._state(tr.model)
        for j in sorted(set(range(len(self.batches))) - set(self.order[:3])):
            tr.train_step(self.model_batch(j))
        self.next = 3

    # --- the window --------------------------------------------------------

    def _step(self, stage_ms=None):
        j = self.order[self.next % len(self.order)]
        self.next += 1
        self.trainer.train_step(self.model_batch(j), stage_ms=stage_ms)
        return int(self.batches[j]["host"]["frame_lengths"].sum())

    def profile(self) -> dict:
        from portbench.harness import profiled

        step_s = self.step_s or 1.0
        k = min(10, max(3, math.ceil(1.0 / step_s)))
        js = [self.order[(self.next + i) % len(self.order)] for i in range(k)]
        cfg = self.cell.conf["config"]
        flops, ctc = 0.0, []
        for j in js:
            b = self.batches[j]
            h = b["host"]
            flops += FC.train_step_flops(cfg, self.tr["B"], b["T"],
                                         h["targets"].shape[1] - 1,
                                         self.tr["crop"])
            ctc.append(RF.ctc_work(h["frame_lengths"], h["ctc_labels"],
                                   h["ctc_lengths"], b["T"]))

        def steps():
            for _ in js:
                self._step()

        _, summary = profiled(steps, self.log, gaps_fn=self._step)
        summary.update(units=k, flops=flops, ctc_launches=ctc)
        return summary

    # --- the comparison ----------------------------------------------------

    def reference(self, prec=None, rows=None):
        """-> (the initial parameters and statistics, the reference's first
        three steps from them: ``ref/conformer.run_steps``). Without a
        set-up, the initial state is the program's model built from the
        seed on the CPU."""
        from portbench.ref import conformer as RC
        from portbench.ref import model as M

        if not hasattr(self, "p0"):
            from lipreading_tpu_torch.models.lipreader import init_model

            self.p0 = self._state(init_model(self._config(), device="cpu"))
        P0 = {k: v.to(self.device) for k, v in self.p0.items()}
        batches = [self.model_batch(j) for j in self.order[:3]]
        return P0, RC.run_steps(P0, self.cell.conf["config"], batches,
                                prec or M.Prec(), rows)

    def check(self) -> dict:
        _, ref = self.reference()
        return compare(self.losses, self.g1, self.p0, self.p3, *ref)


def compare(losses_p, g1_p, p0, p3, losses_r, g1_r, dp_r) -> dict:
    """``drivers/train.compare``, with the BatchNorm running statistics
    (the leaves of ``dp_r`` without a gradient) among the leaves of
    ``update_gap``."""
    out = _train_compare(losses_p, g1_p, p0, p3, losses_r, g1_r, dp_r)
    g1 = {k: v.cpu() for k, v in g1_r.items()}
    norms = {k: float(v.double().norm()) for k, v in g1.items()}
    med = float(np.median(list(norms.values())))
    keys = [k for k in g1 if norms[k] >= 1e-3 * med]
    keys += [k for k in dp_r if k not in g1]
    dp_p = {k: p3[k] - p0[k] for k in p0}
    gap = base.leaf_gap(dp_p, {k: v.cpu() for k, v in dp_r.items()}, keys)
    out["update_gap"] = gap if math.isfinite(gap) else float("nan")
    return out


def main(argv=None) -> int:
    import argparse

    from portbench import control, harness

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", required=True)
    name = ap.parse_known_args(argv)[0].workload
    driver = harness.load_cell(name).traffic["driver"]
    if driver != "train_seeded":
        raise SystemExit(f"{name} is a cell of drivers/{driver}.py: run "
                         "python3 portbench/control.py for it")
    base.Driver, base.compare = Driver, compare
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
