"""Each cell's driver run end to end on the CPU against a tiny model of its
release's family (the shipped preprocessing weights, a freshly drawn lip
reader at small widths in float32, written as a release both sides read),
with the harness's look for a card skipped: the comparison with the plain
reference passes; and, with the timed path broken underneath, it fails:
once for each fault the cell can have."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CONF = {"serve": "portbench/configs/universal4.json",
        "train": "portbench/configs/universal4.json",
        "train_hybrid": "portbench/configs/hybrid.json"}
SMALL = {"serve": {"B": 3, "pool": 3, "check_clips": 1, "render_workers": 1,
                   "bucket": 64},
         "train": {"B": 4, "bucket": 32, "distinct": 3}}
SEED = 2 ** 40 + 17
# the tiny model runs in float32 on both sides, so its sound readings are
# rounding (under 1e-5); the cells' own limits are set for bfloat16 on the
# card
TIGHT = {"roi_max_abs": 1e-4, "valid_mismatch": 0.0, "ctc_kl": 1e-5,
         "transcript_gap": 1e-3,
         "loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}


def run(tmp_path, monkeypatch, cell, seconds=3.0, trace=False):
    kind = cell.split(".")[0]
    conf_key = kind + ("_hybrid" if cell.endswith("hybrid") else "")
    d, conf = tiny.make_assets(tmp_path, CONF[conf_key])
    tiny.point_program_at(monkeypatch, d)
    return harness.run_cell(cell, SEED, seconds, trace, time.perf_counter(),
                            device="cpu", assets_dir=d,
                            overrides={"conf": conf,
                                       "traffic": SMALL[kind],
                                       "limits": TIGHT})


@pytest.mark.parametrize("cell", ["serve.universal4", "train.universal4",
                                  "train.hybrid"])
def test_cell_runs_and_is_correct(tmp_path, monkeypatch, cell):
    r = run(tmp_path, monkeypatch, cell)
    assert r["correct"], r["checks"]
    assert "setup_s" in r["metrics"]
    fps = "serve_fps" if cell.startswith("serve") else "train_fps"
    assert r["metrics"][fps]["value"] > 0
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", ["serve.universal4", "train.hybrid"])
def test_traced_run_reports_per_layer_metrics(tmp_path, monkeypatch, cell):
    r = run(tmp_path, monkeypatch, cell, seconds=10.0, trace=True)
    assert r["correct"], r["checks"]
    spans = ("serve.preprocess_ms" if cell.startswith("serve")
             else "train.backward_ms")
    assert r["metrics"][spans]["value"] > 0
    assert "setup_s" not in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


# --- serving faults ----------------------------------------------------------


def _break_serving(monkeypatch, fault):
    from lipreading_tpu_torch import serve

    orig = serve.serve_batch
    last = {}

    def broken(srv, frames, lens, *a, **kw):
        texts, flags, seg = orig(srv, frames, lens, *a, **kw)
        texts = list(texts)
        if fault == "half_batch":
            half = len(texts) // 2
            texts[half:] = [""] * (len(texts) - half)
        elif fault == "token":
            t = texts[0] or "a"
            texts[0] = t[:-1] + ("e" if t[-1] != "e" else "o")
        elif fault == "stale":
            prev = last.get("texts")
            last["texts"] = list(texts)
            if prev is not None:
                texts = prev[::-1]
        return texts, flags, seg

    monkeypatch.setattr(serve, "serve_batch", broken)


@pytest.mark.parametrize("fault", ["half_batch", "token", "stale"])
def test_serving_fault_is_caught(tmp_path, monkeypatch, fault):
    _break_serving(monkeypatch, fault)
    r = run(tmp_path, monkeypatch, "serve.universal4")
    assert not r["correct"], r["checks"]


# --- training faults ---------------------------------------------------------


def _break_training(monkeypatch, fault):
    from lipreading_tpu_torch.train import loop, optim

    if fault == "unchanged":
        monkeypatch.setattr(optim.AdamW, "update",
                            lambda self: torch.zeros(()))
    elif fault == "half_batch":
        orig = loop.compute_loss

        def half(model, cfg, batch, *a, **kw):
            n = batch["rois"].shape[0] // 2
            return orig(model, cfg, {k: v[:n] for k, v in batch.items()},
                        *a, **kw)

        monkeypatch.setattr(loop, "compute_loss", half)
    elif fault == "leaf_skipped":
        orig = optim.AdamW.update

        def skip_one(self):
            k = next(iter(self.params))
            p = self.params[k]
            keep = p.detach().clone()
            norm = orig(self)
            with torch.no_grad():
                p.copy_(keep)
            return norm

        monkeypatch.setattr(optim.AdamW, "update", skip_one)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "leaf_skipped"])
def test_training_fault_is_caught(tmp_path, monkeypatch, fault):
    _break_training(monkeypatch, fault)
    r = run(tmp_path, monkeypatch, "train.universal4")
    assert not r["correct"], r["checks"]


def test_leaf_gap_reads_one_for_an_unmoved_leaf():
    from portbench.drivers.train import leaf_gap

    ref = {"a": torch.ones(3), "b": torch.full((4,), 2.0)}
    prog = {"a": torch.zeros(3), "b": torch.full((4,), 2.0)}
    med = (np.sqrt(3) + 4.0) / 2
    med = (np.sqrt(3) + 4.0) / 2
    assert leaf_gap(prog, ref, ["a", "b"]) == pytest.approx(np.sqrt(3) / med)
    assert leaf_gap(prog, ref, ["a"]) == pytest.approx(1.0)
