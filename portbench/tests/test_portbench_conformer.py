"""The Auto-AVSR cell on the CPU: the frozen FLOP count equals the
program's, the benchmark's reference equals the program's oracle, and the
cell runs through the unchanged harness against a tiny model of the family
(drawn from the seed, float32 on both sides) and comes out correct, while
the control (float8 products) and a step on half of each batch do not."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from portbench import control, harness
from portbench.frozen import flops_conformer as FC

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "train.autoavsr_vsr"
SEED = 2 ** 40 + 29
TINY_MODEL = {"tf_dim": 32, "tf_heads": 2, "tf_mlp": 64, "tf_layers": 2,
              "tf_dec_layers": 1, "vocab_size": 40, "dtype": "float32"}
TINY_TRAFFIC = {"B": 4, "clips": 8, "min_frames": 12, "max_frames": 20,
                "pad_to": 4, "bucket": 24, "roi": 36, "crop": 32,
                "token_hi": 37}
# float32 on both sides: the sound readings are rounding
TIGHT = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}


def tiny_conf() -> dict:
    with open(os.path.join(ROOT, "portbench/configs/autoavsr_vsr.json")) as f:
        conf = json.load(f)
    c = conf["config"]
    c["model"].update(TINY_MODEL)
    return conf


def test_flops_equal_program():
    from lipreading_tpu_torch import flops
    from lipreading_tpu_torch.config import from_dict

    for d in (harness.load_cell(CELL).conf["config"], tiny_conf()["config"]):
        cfg = from_dict(d)
        for B, T, L, crop in ((32, 256, 43, 88), (32, 64, 12, None),
                              (4, 20, 5, 32)):
            assert FC.train_step_flops(d, B, T, L, crop) == \
                flops.train_step_flops(cfg, B, T, L, crop)
            assert FC.model_fwd_flops(d, T, L, crop) == \
                flops.model_fwd_flops(cfg, T, L, crop)


def test_reference_equals_program_oracle():
    """The benchmark's copy and the program's oracle: the same losses,
    gradients and BatchNorm statistics, dropout on."""
    from lipreading_tpu_torch.config import from_dict
    from lipreading_tpu_torch.models.lipreader import init_model
    from lipreading_tpu_torch.oracle import conformer as O
    from portbench.ref import conformer as R

    d = tiny_conf()["config"]
    model = init_model(from_dict(d), device="cpu")
    names = [k for k, _ in model.named_parameters()]
    g = torch.Generator().manual_seed(3)
    B, T = 3, 14
    batch = {"rois": torch.randn(B, T, 32, 32, generator=g),
             "frame_lengths": torch.tensor([14, 9, 11]),
             "targets": torch.tensor([[39, 4, 5, 39], [39, 6, 39, 0],
                                      [39, 7, 39, 0]]),
             "target_lengths": torch.tensor([4, 3, 3]),
             "ctc_labels": torch.tensor([[4, 5], [6, 0], [7, 0]]),
             "ctc_lengths": torch.tensor([2, 1, 1])}
    outs = []
    for mod in (O, R):
        P = {k: v.detach().clone().requires_grad_(k in names)
             for k, v in model.state_dict().items()}
        draws = mod.Draws(torch.Generator().manual_seed(5), 0.1, B)
        loss, lc, la, stats = mod.losses(P, d, batch, None, None, draws)
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        outs.append((loss.detach(), grads, stats))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    for k in outs[0][2]:
        assert torch.equal(outs[0][2][k], outs[1][2][k])


def run(seconds=8.0, trace=False):
    return harness.run_cell(CELL, SEED, seconds, trace, time.perf_counter(),
                            device="cpu",
                            overrides={"conf": tiny_conf(),
                                       "traffic": TINY_TRAFFIC,
                                       "limits": TIGHT})


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(trace):
    r = run(trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    if trace:
        assert r["metrics"]["train.forward_ms"]["value"] > 0
        assert r["device"]["window_s"] > 0
    else:
        assert r["metrics"]["train_fps"]["value"] > 0
        assert "setup_s" in r["metrics"]


def test_control_and_half_batch_are_not_correct(monkeypatch):
    from portbench.drivers import train as base
    from portbench.drivers import train_seeded

    c = harness.load_cell(CELL)
    c.conf = tiny_conf()
    c.traffic = {**c.traffic, **TINY_TRAFFIC}
    # what ``python3 -m portbench.drivers.train_seeded`` does for control.py
    monkeypatch.setattr(base, "Driver", train_seeded.Driver)
    monkeypatch.setattr(base, "compare", train_seeded.compare)
    r = control.readings(c, SEED, torch.device("cpu"),
                         str(harness.ROOT / "assets"), log=lambda s: None)
    assert set(r) == {"control", "half_batch"}
    for name, nums in r.items():
        checks, correct = harness.decide(nums, c.limits)
        assert not correct, (name, checks)
