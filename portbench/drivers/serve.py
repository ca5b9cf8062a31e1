"""Bulk transcription through the program's serving path
(``lipreading_tpu_torch.serve``): a closed loop of batches, each served by
``serve.serve_batch`` as soon as the last one returned.

Traffic parameters (``traffic/<mix>.json``): ``B`` clips a batch, padded
to ``bucket`` frames (zero frames past a clip's length, as the program's
``iter_batches`` pads); a pool of ``pool`` fixture clips (``pool_seed +
i``, at ``variation``) and ``check_clips`` clips drawn from ``--seed``,
rendered in ``render_workers`` worker processes during set-up; ``beam``,
``lm_weight``, ``margin`` (the cascade's), and the server's ``landmarker``
and ``tracked``. Set-up packs two host batches once: the pool's first
``B`` clips in an order drawn from the seed, and the check batch, that
order with ``check_clips`` rows, at places drawn from the seed, holding the
seed's clips. The set-up batch and every batch of the window but the
first are the pool's, so every seed and every batch after the first asks
for the same work; the window's first batch is the check batch. Batches
reach the card through the program's ``PinnedPrefetcher`` (page-locked
staging, a copy on a side stream, two batches ahead), which is handed
the packed arrays themselves.

Set-up loads the server (``serve.load_server``), warms every rescore shape
(``serve.warm_up``) and serves the first batch. The window serves batches
back to back; a batch counts where it returned before the window's end.
``--trace 1`` passes the program's stage clock (``serve.StageClock``) to
each batch of the window, then profiles one unmarked batch with the ROI
and greedy kernels' launches recorded for their rooflines.

The comparison holds the window's first batch, the check batch, against
``ref/serve.py``: its ROIs and valid mask (taken as ``serve_batch`` makes
them), the greedy leg's CTC log-probabilities (as the greedy kernel gets
them), its transcripts, the cascade's flags and the clips decoded by shot."""

from __future__ import annotations

import multiprocessing as mp
import os
import time

import numpy as np
import torch

from portbench.frozen import flops as FL
from portbench.frozen.fixtures import render


class Driver:
    def __init__(self, cell, seed, device, assets_dir, log):
        self.cell, self.seed, self.device = cell, seed, device
        self.assets_dir, self.log = assets_dir, log
        self.tr = cell.traffic
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5E7E]))

    # --- set-up ------------------------------------------------------------

    def _render(self, jobs):
        n = max(1, min(self.tr["render_workers"], (os.cpu_count() or 2) - 1))
        pool = mp.get_context("spawn").Pool(n)
        try:
            return pool.map(render, jobs, chunksize=1)
        finally:
            pool.close()
            pool.join()

    def _pack(self, clips):
        T = self.tr["bucket"]
        H, W = clips[0][0].shape[1:3]
        frames = np.zeros((len(clips), T, H, W, 3), np.uint8)
        lens = np.zeros((len(clips),), np.int32)
        for i, (f, _) in enumerate(clips):
            n = min(len(f), T)
            frames[i, :n] = f[:n]
            lens[i] = n
        return frames, lens

    def check_ids(self):
        """The fixture seeds of the check batch's clips, drawn from
        ``--seed`` above the pool's."""
        k = self.tr["check_clips"]
        return [int(x) for x in 2 ** 40 + self.rng.choice(2 ** 40, k,
                                                           replace=False)]

    def render_batches(self):
        """Render the pool and the seed's clips, and pack the pool's batch
        and the check batch (``self.batch``, ``self.check_batch``: each
        (frames, lens, clip seeds))."""
        tr = self.tr
        ids = [tr["pool_seed"] + i for i in range(tr["pool"])]
        extra = self.check_ids()
        clips = self._render([(i, tr["variation"]) for i in ids + extra])
        order = self.rng.permutation(tr["pool"])[:tr["B"]]
        frames, lens = self._pack([clips[i] for i in order])
        self.batch = (frames, lens, [ids[i] for i in order])
        at = np.sort(self.rng.choice(tr["B"], len(extra), replace=False))
        rows = list(order)
        for j, k in enumerate(at):
            rows[k] = len(ids) + j
        frames, lens = self._pack([clips[i] for i in rows])
        self.check_batch = (frames, lens, [(ids + extra)[i] for i in rows])

    def _batches(self):
        yield self.batch
        yield self.check_batch
        while True:
            yield self.batch

    def setup(self):
        from lipreading_tpu_torch.data.pipeline import PinnedPrefetcher

        self.render_batches()
        self.load_server()
        self.pf = PinnedPrefetcher(self._batches(), self.device)
        (frames, lens), _, _ = next(self.pf)
        self.warm(frames, lens)

    def load_server(self, srv=None):
        """The program's server for the configuration's release (or
        ``srv``, one already loaded)."""
        from lipreading_tpu_torch import serve

        tr = self.tr
        self.serve = serve
        self.srv = srv or serve.load_server(self.cell.conf["release"],
                                            tr["landmarker"], tr["tracked"],
                                            self.device)

    def warm(self, frames, lens):
        """Warm every rescore shape (``serve.warm_up``) and serve the
        batch once."""
        tr = self.tr
        self.serve.warm_up(self.srv, frames, lens, tr["beam"],
                           tr["lm_weight"])
        self._serve(frames, lens)

    def _serve(self, frames, lens, mark=None):
        tr = self.tr
        return self.serve.serve_batch(self.srv, frames, lens, tr["beam"],
                                      tr["lm_weight"], tr["margin"],
                                      mark=mark)

    # --- the window --------------------------------------------------------

    def serve_checked(self, frames, lens, mark=None):
        """Serve the check batch, keeping what the comparison reads: the
        ROIs and valid mask ``preprocess_batch`` made, the log-probabilities
        the greedy kernel got first, and the served texts, flags and
        clips decoded by shot."""
        from lipreading_tpu_torch import infer

        serve = self.serve
        orig, orig_greedy = serve.preprocess_batch, infer.ctc_greedy_ids

        def keep(srv, f, mark=None):
            self.rois_valid = orig(srv, f, mark)
            return self.rois_valid

        def keep_logp(logp, lengths, *a, **kw):
            if self.logp is None:
                self.logp = logp
            return orig_greedy(logp, lengths, *a, **kw)

        self.logp = None
        serve.preprocess_batch, infer.ctc_greedy_ids = keep, keep_logp
        try:
            texts, flags, seg = self._serve(frames, lens, mark)
        finally:
            serve.preprocess_batch, infer.ctc_greedy_ids = orig, orig_greedy
        self.served = {"texts": texts, "flags": flags, "seg": seg}
        return texts, flags, seg

    def window(self, seconds: float, marked: bool) -> dict:
        serve = self.serve
        spans: dict[str, float] = {}
        frames_done = clips = rescored = segmented = batches = 0
        unit_s = []
        start = time.perf_counter()
        deadline, end = start + seconds, start
        k = 0
        while time.perf_counter() < deadline:
            (frames, lens), _, (_, lens_np, _) = next(self.pf)
            clock = serve.StageClock(self.device) if marked else None
            if k == 0:
                texts, flags, seg = self.serve_checked(
                    frames, lens, clock.mark if clock else None)
            else:
                texts, flags, seg = self._serve(
                    frames, lens, clock.mark if clock else None)
            t = time.perf_counter()
            k += 1
            if t > deadline:
                break
            unit_s.append(t - end)
            end = t
            batches += 1
            clips += len(texts)
            frames_done += int(lens_np.sum())
            rescored += int(np.sum(flags))
            segmented += int(np.sum(seg))
            if clock:
                for s, ms in clock.ms.items():
                    spans[s] = spans.get(s, 0.0) + ms
        return {"start": start, "seconds": end - start, "frames": frames_done,
                "units": batches, "attempted": clips, "failed": 0,
                "spans_ms": spans, "span_units": batches if marked else 0,
                "unit_s": unit_s, "clips": clips,
                "rescored": rescored,
                "segmented": segmented}

    def profile(self) -> dict:
        """One unmarked batch under torch.profiler, the ROI and greedy
        kernels' launches recorded; the idle gaps named over it once more
        with the host's events (a batch's launches make tens of seconds of
        profiling already)."""
        from lipreading_tpu_torch import infer
        from lipreading_tpu_torch.ops import roi as roi_ops

        from portbench.harness import profiled

        rois, greedy = [], []
        orig_roi, orig_greedy = roi_ops.sample_rois, infer.ctc_greedy_ids

        def roi_rec(gray, boxes, out_size=96, *a, **kw):
            sub = kw.get("subpixel", a[3] if len(a) > 3 else False)
            rois.append((boxes.clone(), bool(sub), gray.shape, out_size))
            return orig_roi(gray, boxes, out_size, *a, **kw)

        def greedy_rec(logits, lengths, *a, **kw):
            greedy.append((logits.shape, lengths.clone()))
            return orig_greedy(logits, lengths, *a, **kw)

        (frames, lens), _, (_, lens_np, _) = next(self.pf)
        flops = FL.serve_batch_flops(self.cell.conf["config"], lens_np)

        def one():
            rois.clear()
            greedy.clear()
            self._serve(frames, lens)

        def again():
            n_roi, n_greedy = len(rois), len(greedy)
            self._serve(frames, lens)
            del rois[n_roi:], greedy[n_greedy:]

        # the wrapper counts its launches on the module's name, so the
        # recorder carries the count while it stands in
        roi_rec.launches = orig_roi.launches
        roi_ops.sample_rois, infer.ctc_greedy_ids = roi_rec, greedy_rec
        try:
            _, summary = profiled(one, self.log, gaps_fn=again)
        finally:
            roi_ops.sample_rois, infer.ctc_greedy_ids = orig_roi, orig_greedy
            orig_roi.launches = roi_rec.launches
        summary.update(units=1, flops=flops, roi_launches=rois,
                       greedy_launches=greedy)
        return summary

    # --- the comparison ----------------------------------------------------

    def release(self):
        self.pf.close()
        del self.srv, self.pf
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec_pre=None, prec_model=None) -> dict:
        """The reference's check batch (``ref/serve.reference_batch``), in
        the given precisions (float32 by default)."""
        from portbench.ref import decode as D
        from portbench.ref import preprocess as RP
        from portbench.ref import serve as RS
        from portbench.ref import weights as W

        conf = self.cell.conf
        Pn, _ = W.load_release(self.assets_dir, conf["release"])
        cfg = conf["config"]
        self.P = {k: torch.from_numpy(v.copy()).to(self.device)
                  for k, v in Pn.items()}
        assets = RP.load_assets(self.assets_dir, self.device)
        self.lm = D.load_lm(os.path.join(self.assets_dir, "char_lm.npz"),
                            self.device)
        frames = torch.from_numpy(self.check_batch[0]).to(self.device)
        lens = torch.from_numpy(self.check_batch[1]).to(self.device)
        return RS.reference_batch(frames, lens, assets, self.P, cfg, self.lm,
                                  self.tr, cfg["preprocess"], prec_pre,
                                  prec_model)

    def judge(self, served: dict, ref: dict) -> dict:
        from portbench.ref import serve as RS

        return RS.judge(served, ref, self.P, self.cell.conf["config"],
                        self.lm, self.tr)

    def served_batch(self) -> dict:
        """What the program served of the check batch, as ``judge`` reads
        it."""
        rois, valid = self.rois_valid
        return dict(self.served, rois=rois, valid=valid, logp=self.logp)

    def check(self) -> dict:
        return self.judge(self.served_batch(), self.reference())
