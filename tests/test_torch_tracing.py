"""The port's tracer (``lipreading_tpu_torch/profiling.py``) on the CPU, on
the tiny release of ``portbench/tests/tiny.py``: off, a span is the shared
null context and a batch or step records nothing and makes no event, hook,
synchronise or profiler region; on, spans nest and fold into per-unit
totals; under ``torch.profiler`` an untraced unit's spans enclose their
operators; the merged stage clock keeps its keys; the benchmark's nine
readers of the tracer return numbers (the two device-event ones None off a
card), and the counters agree with what the serving path did."""

import time

import numpy as np
import pytest
import torch

from lipreading_tpu_torch import profiling
from lipreading_tpu_torch.ops import decode
from portbench import harness
from portbench.tests import tiny
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

SERVE_STAGES = {"detect", "track", "landmarks", "roi", "greedy", "rescore",
                "segmented"}
TRAIN_STAGES = {"host_to_device", "forward", "backward", "optimizer"}
SERVE_READERS = ("serve.cascade_calls", "serve.encode_ms", "serve.beam_steps",
                 "serve.beam_step_ms", "serve.rescore_pad_frac",
                 "serve.sync_wait_ms")
TRAIN_READERS = ("train.launch_ms",)
DEVICE_READERS = ("train.stem_ms", "train.stem_backward_ms")


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """The tiny universal4 release's server, a batch of two clips (the
    second with four black frames inside its length, so it is decoded by
    shot), its trainer and a training batch."""
    from lipreading_tpu_torch import infer, io, serve
    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.train.loop import Trainer
    from portbench.frozen import text as tx
    from portbench.frozen.fixtures import sample_text

    tmp = tmp_path_factory.mktemp("tracing")
    d, conf = tiny.make_assets(tmp, "portbench/configs/universal4.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(io, "ASSETS_DIR", d)
        mp.setattr(infer, "ASSETS_DIR", d)
        infer._LM_CACHE.clear()
        srv = serve.load_server(conf["release"], "conv", True, "cpu")
        T = 48
        frames = np.zeros((2, T, 160, 160, 3), np.uint8)
        lens = np.zeros((2,), np.int32)
        for i, seed in enumerate((3, 4)):
            f = make_clip(seed).frames[:T]
            frames[i, :len(f)] = f
            lens[i] = len(f)
        frames[1, 10:14] = 0
        tree, cfg = io.load_release(conf["release"], d)
        trainer = Trainer(cfg, str(tmp / "work"), "cpu")
        trainer.warm_start(tree)
        B, Tt, R, L = 2, 16, cfg.preprocess.roi_size, cfg.data.max_chars
        rng = np.random.default_rng(0)
        tg = np.zeros((B, L), np.int32)
        tl = np.zeros((B,), np.int32)
        cl = np.zeros((B, L), np.int32)
        cn = np.zeros((B,), np.int32)
        for k in range(B):
            tg[k], tl[k], ids = tx.labels(sample_text(rng)[:6], Tt, L)
            cl[k, :len(ids)] = ids
            cn[k] = len(ids)
        batch = {"rois": torch.from_numpy(
                     rng.standard_normal((B, Tt, R, R)).astype(np.float32)),
                 "frame_lengths": np.full((B,), Tt, np.int32),
                 "targets": tg, "target_lengths": tl, "ctc_labels": cl,
                 "ctc_lengths": cn}
        yield {"serve": serve, "srv": srv,
               "frames": torch.from_numpy(frames),
               "lens": torch.from_numpy(lens), "trainer": trainer,
               "batch": batch}
        infer._LM_CACHE.clear()


def serve_batch(rig, mark=None):
    return rig["serve"].serve_batch(rig["srv"], rig["frames"], rig["lens"],
                                    4, 0.4, 8.0, mark=mark)


@pytest.fixture
def fresh_trace(monkeypatch):
    """The tracer's totals emptied for the test (others in the process
    trace units too)."""
    monkeypatch.setattr(profiling, "_spans", {})
    monkeypatch.setattr(profiling, "_counters", {})
    monkeypatch.setattr(profiling, "_units", 0)
    monkeypatch.setattr(profiling, "_last", None)


class FakeEvent:
    """A CUDA event's part the tracer uses, on the CPU: its time is the
    host clock's when recorded; ``reached`` False plays an event the
    device has not reached."""

    reached = True

    def __init__(self):
        self.t = time.perf_counter()

    def query(self):
        return self.reached

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


# --- off ---------------------------------------------------------------------


def test_span_is_the_shared_null_context_when_off():
    assert profiling._unit is None
    a, b = profiling.span("a"), profiling.span("b", device=True)
    assert a is b is profiling._NULL
    before = profiling.trace_totals()
    with a:
        profiling.count("c")
    assert profiling.trace_totals() == before


@pytest.mark.parametrize("path", ["serve", "train"])
def test_untraced_unit_records_and_touches_nothing(rig, monkeypatch, path):
    calls = {"event": 0, "hook": 0, "sync": 0, "region": 0}

    def counted(key, fn=None):
        def f(*a, **k):
            calls[key] += 1
            return fn(*a, **k) if fn else None
        return f

    monkeypatch.setattr(profiling, "_event", counted("event"))
    monkeypatch.setattr(torch.cuda, "Event", counted("event"))
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        counted("hook", torch.Tensor.register_hook))
    monkeypatch.setattr(torch.cuda, "synchronize", counted("sync"))
    monkeypatch.setattr(torch.cuda, "current_stream", counted("sync"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counted("region", torch.profiler.record_function))
    monkeypatch.setattr(profiling, "_region",
                        counted("region", profiling._region))
    before, last = profiling.trace_totals(), profiling._last
    if path == "serve":
        serve_batch(rig)
    else:
        rig["trainer"].train_step(rig["batch"])
    assert profiling.trace_totals() == before
    assert profiling._last is last and profiling._unit is None
    assert calls == {"event": 0, "hook": 0, "sync": 0, "region": 0}


# --- on ----------------------------------------------------------------------


def test_spans_nest_and_fold_into_per_unit_totals(fresh_trace):
    for _ in range(2):
        with profiling.unit("root", "cpu"):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    time.sleep(0.002)
                profiling.count("n", 3)
                with profiling.span("inner"):
                    pass
            profiling.count("m")
        spans, counters = profiling.last_unit()
        assert counters == {"n": 3, "m": 1}
        root, outer, in1, in2 = spans
        assert [s.name for s in spans] == ["root", "outer", "inner", "inner"]
        assert root.parent is None and outer.parent is root
        assert in1.parent is outer and in2.parent is outer
        assert outer.self_ms == pytest.approx(
            outer.host_ms - in1.host_ms - in2.host_ms, abs=1e-9)
        assert root.self_ms == pytest.approx(root.host_ms - outer.host_ms,
                                             abs=1e-9)
        assert in1.self_ms == in1.host_ms >= 2.0
    t = profiling.trace_totals()
    assert t["units"] == 2 and t["counters"] == {"n": 6, "m": 2}
    assert t["spans"]["inner"]["n"] == 4 and t["spans"]["root"]["n"] == 2
    assert t["spans"]["inner"]["device_ms"] is None
    assert t["spans"]["outer"]["self_ms"] == pytest.approx(
        t["spans"]["outer"]["host_ms"] - t["spans"]["inner"]["host_ms"])


def test_device_spans_resolve_at_the_unit_end(fresh_trace, monkeypatch):
    """A CUDA unit played with host-clock events: a span's pair resolves
    where the device reached its end event, a hook's backward span closes
    after the backward, and none resolves for an event not reached."""
    monkeypatch.setattr(profiling, "_event", lambda device: FakeEvent())
    x = torch.ones(3, requires_grad=True)
    with profiling.unit("root", "cuda"):
        with profiling.span("dev", device=True):
            time.sleep(0.002)
            y = x * 2
        profiling.backward_span(y, "bw")
        y.sum().backward()
        profiling.backward_done()
    spans, _ = profiling.last_unit()
    dev, bw = spans[1], spans[2]
    assert dev.name == "dev" and dev.device_ms >= 2.0
    assert bw.name == "bw" and bw.parent is spans[0]
    assert bw.device_ms is not None and bw.device_ms >= 0
    t = profiling.trace_totals()
    assert t["spans"]["dev"]["device_ms"] == pytest.approx(dev.device_ms)
    assert t["spans"]["root"]["device_ms"] is None

    monkeypatch.setattr(FakeEvent, "reached", False)
    with profiling.unit("root", "cuda"):
        with profiling.span("dev", device=True):
            pass
    assert profiling.last_unit()[0][1].device_ms is None
    assert (profiling.trace_totals()["spans"]["dev"]["device_ms"]
            == pytest.approx(dev.device_ms))


def test_untraced_spans_enclose_their_operators_under_the_profiler(rig):
    from torch.profiler import ProfilerActivity, profile

    before = profiling.trace_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rig["trainer"].train_step(rig["batch"])
    assert profiling.trace_totals() == before
    ev = [(e.name(), e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()]
    (s0, e0), = [(s, e) for n, s, e in ev if n == "train.step"]
    encode = [(s, e) for n, s, e in ev if n == "model.encode"]
    stem = [(s, e) for n, s, e in ev if n == "model.stem"]
    assert len(encode) == 1 and len(stem) == 1
    (s1, e1), (s2, e2) = encode[0], stem[0]
    assert s0 <= s1 <= s2 <= e2 <= e1 <= e0
    ops = [n for n, s, e in ev
           if n.startswith("aten::") and s2 <= s <= e <= e2]
    assert ops, "no operator inside the model.stem span"


def test_stage_clock_keys_are_unchanged(rig, fresh_trace):
    clock = rig["serve"].StageClock(torch.device("cpu"))
    serve_batch(rig, clock.mark)
    assert set(clock.ms) == SERVE_STAGES
    assert all(v > 0 for v in clock.ms.values())
    stage_ms = {}
    rig["trainer"].train_step(rig["batch"], stage_ms=stage_ms)
    assert set(stage_ms) == TRAIN_STAGES
    assert profiling.trace_totals()["units"] == 2


def test_serving_counters_follow_the_work(rig, fresh_trace):
    steps = decode.early_exit_scan.steps
    clock = rig["serve"].StageClock(torch.device("cpu"))
    _, flags, seg = serve_batch(rig, clock.mark)
    spans, counters = profiling.last_unit()
    assert seg.sum() >= 1
    assert counters["cascade.calls"] == 1 + seg.sum()
    assert counters["beam.steps"] == decode.early_exit_scan.steps - steps > 0
    assert 0 <= counters["beam.pad_rows"] < counters["beam.rows"]
    assert counters["beam.rows"] % 8 == 0
    names = [s.name for s in spans]
    assert names[0] == "serve.batch" and names.count("serve.clip") == seg.sum()
    assert names.count("cascade") == counters["cascade.calls"]
    assert names.count("beam.step") == counters["beam.steps"]
    assert {"wait.lengths", "wait.valid", "wait.conf", "wait.texts",
            "wait.beam", "model.encode", "model.stem"} <= set(names)
    assert "model.stem_backward" not in names


def test_training_step_traces_the_stem_backward(rig, fresh_trace,
                                                monkeypatch):
    hooks = []
    orig = torch.Tensor.register_hook

    def counted(self, fn):
        hooks.append(fn)
        return orig(self, fn)

    monkeypatch.setattr(torch.Tensor, "register_hook", counted)
    rig["trainer"].train_step(rig["batch"], stage_ms={})
    spans, _ = profiling.last_unit()
    assert len(hooks) == 1
    by = {s.name: s for s in spans}
    assert spans[0].name == "train.step"
    assert by["model.stem"].parent is by["model.encode"]
    assert by["model.stem_backward"].parent is spans[0]
    assert by["model.stem_backward"].device_ms is None      # no card


@pytest.mark.parametrize("path", ["serve", "train"])
def test_readers_return_numbers_on_a_cpu_run(rig, fresh_trace, path):
    if path == "serve":
        serve_batch(rig, rig["serve"].StageClock(torch.device("cpu")).mark)
        names = SERVE_READERS
    else:
        rig["trainer"].train_step(rig["batch"], stage_ms={})
        names = TRAIN_READERS
    for name in names:
        v = harness.reader(name).read(None)
        assert isinstance(v, float) and v >= 0, (name, v)
    if path == "serve":
        c = profiling.trace_totals()["counters"]
        assert (harness.reader("serve.cascade_calls").read(None)
                == c["cascade.calls"])
        assert (harness.reader("serve.rescore_pad_frac").read(None)
                == c["beam.pad_rows"] / c["beam.rows"])
    else:
        for name in DEVICE_READERS:
            assert harness.reader(name).read(None) is None


def test_readers_return_none_without_traced_units(fresh_trace):
    for name in SERVE_READERS + TRAIN_READERS + DEVICE_READERS:
        assert harness.reader(name).read(None) is None
