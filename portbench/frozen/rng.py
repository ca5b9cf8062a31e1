"""Frozen copy of the seed of a fine-tuning step's generator
(``train/loop.step_seed`` of the program): the training step draws its ROI
jitter and dropout masks from a generator on the device seeded with it.
``tests/test_portbench_frozen.py`` holds it equal to the program's."""

from __future__ import annotations

import numpy as np


def step_seed(seed: int, step: int) -> int:
    """The seed of training step ``step`` of a run seeded ``seed`` (one
    data rank)."""
    return int(np.random.SeedSequence([seed, 0x0D0, step])
               .generate_state(1, np.uint64)[0] >> 1)
