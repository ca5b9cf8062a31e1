"""The port's tracing and timing helpers (``lipreading_tpu_torch/
profiling.py``) on the CPU: ``Timer`` counts its calls and returns seconds
a call, ``capture`` writes a Chrome trace that names a ``span``, and
``device_memory_stats`` is empty without a CUDA device."""

import json
import time

import pytest
import torch

from lipreading_tpu_torch import profiling
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")


def test_timer_returns_seconds_a_call_after_warmup():
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.01)
        return {"y": [torch.ones(2) * x]}

    s = profiling.Timer(fn, warmup=3).measure(2.0, reps=5)
    assert len(calls) == 8 and calls == [2.0] * 8
    assert 0.009 <= s < 1.0


def test_capture_writes_a_trace_naming_an_annotated_region(tmp_path):
    with profiling.capture(str(tmp_path / "trace")) as path:
        with profiling.span("roi_stage"):
            with profiling.span("inner_matmul"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert path.startswith(str(tmp_path / "trace"))
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"roi_stage", "inner_matmul"} <= names


def test_device_memory_stats_is_empty_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CPU case does not apply")
    assert profiling.device_memory_stats() == {}
