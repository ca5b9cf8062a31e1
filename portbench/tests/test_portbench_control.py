"""The comparison's control, at a size a test run holds: the plain
reference put in the program's place one precision step below what the
configuration states (float8 products and convolutions where the
releases state bfloat16; TF32, which the CPU ignores, in the
preprocessing), on the shipped releases, comes out not correct by the
harness's own decision with the cell's limits, and so does a training
step on half of each batch. ``control.py`` reads the same numbers on the
card at the cells' own sizes."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness

SMALL = {"serve": {"B": 16, "pool": 16, "check_clips": 4, "render_workers": 2},
         "train": {"B": 8, "bucket": 32, "distinct": 3}}


@pytest.mark.parametrize("cell", ["serve.universal4", "train.universal4",
                                  "train.hybrid"])
def test_control_is_not_correct(cell):
    c = harness.load_cell(cell)
    c.traffic = {**c.traffic, **SMALL[c.traffic["driver"]]}
    r = control.readings(c, 2 ** 35 + 3, torch.device("cpu"),
                         str(harness.ROOT / "assets"), log=lambda s: None)
    assert set(r) == ({"control"} if cell.startswith("serve")
                      else {"control", "half_batch"})
    for name, nums in r.items():
        checks, correct = harness.decide(nums, c.limits)
        assert not correct, (name, checks)
