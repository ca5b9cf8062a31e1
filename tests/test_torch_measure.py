"""The port's measurement entries on the CPU at tiny sizes
(``lipreading_tpu_torch/{microbench, bench_flash, roofline_preprocess,
profile_train, bench_stem, profile_decode, bench_decode_knee,
bench_ingest}.py``) and ``flops.preprocess_flops``:

* ``preprocess_flops`` equal to the JAX function, exactly;
* each entry's rows or keys equal to the JAX script's, in its order, under
  the port's names (``_pallas`` -> ``_kernel``; ``_xla`` and ``_scan`` ->
  ``_plain``; one ``ert`` row for ``ert_take`` / ``ert_matmul``), each name
  listed here beside its ``scripts/`` line; every time and rate finite and
  above 0 (the decode profile's residual, a difference, finite), no kernel
  launched on the CPU, and without a card and without ``device=cpu`` the
  entry raises;
* the roofline's bytes and FLOPs models equal the formulas of
  ``scripts/roofline_preprocess.py:131-166``, written out here; its shares
  use the card's peaks by the card's name, and on another card none is
  printed;
* ``bench_ingest`` with OpenCV hidden: the codec keys null, the null rings
  measured.
"""

import math
import sys

import pytest
import torch

from lipreading_tpu import flops as jflops
from lipreading_tpu.config import PreprocessConfig as JPre
from lipreading_tpu_torch import (
    bench_decode_knee,
    bench_flash,
    bench_ingest,
    bench_stem,
    microbench,
    profile_decode,
    profile_train,
    roofline_preprocess,
)
from lipreading_tpu_torch import flops as tflops
from lipreading_tpu_torch.config import PreprocessConfig
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

H100 = "NVIDIA H100 80GB HBM3"
TINY_TRAIN = ["model.tf_dim=32", "model.tf_heads=2", "model.tf_mlp=64",
              "model.frontend_dim=24", "model.frontend_channels=4,8,12",
              "model.tf_layers=1", "model.tf_dec_layers=1"]


@pytest.mark.parametrize("hw,over", [
    ((160, 160), {}),
    ((120, 200), {"roi_size": 64, "ert_cascades": 6, "ert_trees": 40,
                  "ert_depth": 3, "ert_pool": 96}),
])
def test_preprocess_flops_equals_jax(hw, over):
    got = tflops.preprocess_flops(PreprocessConfig(**over), *hw)
    assert got == jflops.preprocess_flops(JPre(**over), *hw)


def _names(rows, key):
    return [r[key] for r in rows]


def _finite_pos(*vals):
    return all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
               for v in vals)


# each entry: (argv at a tiny size, the check of what main returns)
def _microbench(out):
    # scripts/microbench.py:62-84 (the preprocess and CTC rows), :104-109
    want = ["grayscale", "detector", "ert_cascade", "roi_kernel",
            "roi_plain", "preprocess_full", "ctc_fwd_plain",
            "ctc_fwd_kernel", "ctc_grad_plain", "ctc_grad_kernel",
            "ctc_decode_plain", "ctc_decode_kernel"]
    for T in (128, 512, 1024):
        want += [f"attn_plain_T{T}", f"attn_flash_T{T}"]
    assert _names(out, "op") == want
    assert all(_finite_pos(r["ms"], r["items_per_s"]) for r in out)
    return [r["launches"] for r in out], want


def _bench_flash(out):
    # scripts/bench_flash.py:37-63: T x bwd (blocks dropped)
    want = [(T, b) for T in (16, 32) for b in ("pallas", "fused", "xla")]
    assert [(r["T"], r["bwd"]) for r in out] == want
    assert all(_finite_pos(r["fwd_ms"], r["fwd_bwd_ms"]) for r in out)
    return ([r["launches"] for r in out],
            [f"{T:6d} {b:>7s}" for T, b in want])


def _roofline(out):
    # scripts/roofline_preprocess.py:201-218 (stages), :235, :239 (bounds)
    want = ["grayscale", "detector", "ert", "roi_kernel", "roi_plain",
            "full_ert"]
    assert _names(out["rows"], "stage") == want
    for r in out["rows"]:
        assert _finite_pos(r["ms"], r["fps"]), r
        assert ("gbs" in r) == (r["stage"] != "full_ert")
        assert "bw_pct" not in r and "f32_pct" not in r     # no card peaks
    assert _finite_pos(*out["gather10"].values())
    assert _finite_pos(*out["copy"].values())
    assert out["peaks"] is None and out["device"] == "cpu"
    return [r["launches"] for r in out["rows"]], want + ["gather10", "copy"]


def _profile_train(out):
    # scripts/profile_train.py:129, 153, 168, 183, 197, 210 and 220
    want = list(profile_train.ROWS)
    assert _names(out["rows"], "name") == want
    assert all(_finite_pos(r["ms"], r["share_pct"]) for r in out["rows"])
    assert all(r["mfu_pct"] == 0.0 for r in out["rows"])  # no card peak
    assert _finite_pos(out["sum_ms"], out["sum_pct"])
    return [r["launches"] for r in out["rows"]], want + ["sum of parts"]


def _bench_stem(out):
    # scripts/bench_stem.py:74 (the keys), :85 (the stems)
    keys = ["stem", "ms_per_step", "fps", "mfu", "loss", "params_m"]
    assert [r["stem"] for r in out] == ["conv3d", "patchify"]
    for r in out:
        assert [k for k in r if k != "launches"] == keys
        assert _finite_pos(r["ms_per_step"], r["fps"], r["loss"],
                           r["params_m"])
        assert r["mfu"] is None                             # no card peak
    return [r["launches"] for r in out], ["conv3d", "patchify"]


def _profile_decode(out):
    # scripts/profile_decode.py:85, 89, 96, 124, 151, 154
    want = ["encode", "greedy+conf", "beam@48", "beam@32", "beam@24",
            "att-steps x48", "ctc-scores x48", "topk+gather+lm (residual)"]
    assert _names(out["rows"], "name") == want
    assert all(_finite_pos(r["ms"]) for r in out["rows"][:-1])
    assert math.isfinite(out["rows"][-1]["ms"])
    return [r["launches"] for r in out["rows"]], want


def _knee(out):
    # scripts/bench_decode_knee.py:87, 107, 141
    want = [("flagship", 1), ("cascade", 1), ("greedy", 1)]
    assert [(r["section"], r["B"]) for r in out] == want
    for r in out:
        keys = ["section", "B", "ms_per_call", "fps"]
        if r["section"] == "cascade":
            keys.append("rescored_frac")
            assert 0.0 <= r["rescored_frac"] <= 1.0
        assert [k for k in r if k not in ("device", "launches")] == keys
        assert r["device"] == "cpu"
        assert _finite_pos(r["ms_per_call"], r["fps"])
    return [r["launches"] for r in out], ['"section": "flagship"',
                                          '"section": "cascade"',
                                          '"section": "greedy"']


def _ingest(out):
    # scripts/bench_ingest.py:76, 83, 93, 105, 116 and 131
    want = ["host_decode_fps", "pool_decode_fps@1", "null_ipc_fps@1",
            "shm_decode_fps@1", "shm_decode_view_fps@1", "null_shm_fps@1",
            "null_shm_view_fps@1"]
    assert list(out["rates"]) == want
    if out["no_codec"] is None:
        assert _finite_pos(*out["rates"].values())
    return [], want + ["# model: pool(k)"]


ENTRIES = {
    "microbench": (microbench, ["frames=4", "reps=1"], _microbench),
    "bench_flash": (bench_flash, ["T=16,32", "reps=1",
                                  "bwd=pallas,fused,xla"], _bench_flash),
    "roofline_preprocess": (roofline_preprocess, ["frames=4", "reps=1"],
                            _roofline),
    "profile_train": (profile_train, ["B=2", "T=8", "L=3", "reps=1",
                                      *TINY_TRAIN], _profile_train),
    "bench_stem": (bench_stem, ["B=1", "T=8", "L=2", "K=1"], _bench_stem),
    "profile_decode": (profile_decode, ["B=1", "T=12", "beam=2", "reps=1"],
                       _profile_decode),
    "bench_decode_knee": (bench_decode_knee, ["Bs=1", "clips=1", "reps=1"],
                          _knee),
    "bench_ingest": (bench_ingest, ["n=2", "T=8", "workers=1"], _ingest),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_entry_prints_the_jax_rows(name, capsys):
    mod, argv, check = ENTRIES[name]
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(argv)
    out = mod.main(argv + ["device=cpu"])
    launches, printed = check(out)
    assert all(not n for n in launches), launches    # plain versions only
    text = capsys.readouterr().out
    assert "device=cpu" in text or '"device": "cpu"' in text
    assert "H100" not in text
    pos = 0
    for p in printed:                    # each row printed, in the order
        pos = text.index(p, pos) + len(p)


def test_roofline_models_equal_the_jax_formulas():
    for pre, H, W, n in ((PreprocessConfig(), 160, 160, 2048),
                         (PreprocessConfig(roi_size=64, ert_cascades=6,
                                           ert_trees=40, ert_depth=3,
                                           ert_pool=96), 120, 200, 96)):
        R = pre.roi_size
        S, P = pre.ert_cascades, pre.ert_pool
        K, nl = pre.ert_trees, 2 ** pre.ert_depth
        by, fl = roofline_preprocess.stage_models(pre, H, W, n)
        # scripts/roofline_preprocess.py:133-155
        assert by == {
            "grayscale": H * W * 3 + H * W * 4.0,
            "detector": H * W * 4.0 + (64 * 64 + 32 * 32 * 8 + 16 * 16 * 16
                                       + 8 * 8 * 32 + 4) * 4.0,
            "ert": S * (P * 32.0 + (2 * K * (nl - 1) + K * nl + 136 + P)
                        * 4.0) + S * K * nl * 136 * 4.0 / n,
            "roi_kernel": H * W * 4.0 + R * R * 4.0,
            "roi_plain": H * W * 4.0 + R * R * 4.0 + (R * H + R * W) * 4.0,
        }
        # :156-166
        assert fl == {
            "grayscale": H * W * 5.0,
            "detector": 2.0 * 64 * H * W + 2.0 * 64 * W * 64
            + 2.0 * 32 * 32 * 9 * 8 + 2.0 * 16 * 16 * 9 * 8 * 16
            + 2.0 * 8 * 8 * 9 * 16 * 32 + 2.0 * 8 * 8 * 32 * 4,
            "ert": S * (2.0 * K * nl * 136),
            "roi_kernel": 2.0 * R * H * W + 2.0 * R * W * R,
            "roi_plain": 2.0 * R * H * W + 2.0 * R * W * R,
        }


def test_roofline_shares_use_the_cards_peaks():
    by, fl = roofline_preprocess.stage_models(PreprocessConfig(), 160, 160,
                                              2048)
    peaks = tflops.card_peaks(H100)
    assert peaks == {"bytes": 3.35e12, "float32": 67e12}
    assert tflops.card_peaks("NVIDIA H100 PCIe") == {"bytes": 2.0e12,
                                                      "float32": 51e12}
    sec, n = 2e-3, 2048
    r = roofline_preprocess.stage_row("ert", sec, n, by["ert"], fl["ert"],
                                      peaks)
    fps = n / sec
    assert r["gbs"] == fps * by["ert"] / 1e9
    assert r["bw_pct"] == 100 * r["gbs"] * 1e9 / 3.35e12
    assert r["f32_pct"] == 100 * (fps * fl["ert"] / 1e9) * 1e9 / 67e12
    assert "% BW" in roofline_preprocess.format_row(r)
    for other in ("NVIDIA A100-SXM4-80GB", "cpu"):
        assert tflops.card_peaks(other) is None
        r = roofline_preprocess.stage_row("ert", sec, n, by["ert"],
                                          fl["ert"], None)
        assert "bw_pct" not in r and "f32_pct" not in r
        assert "%" not in roofline_preprocess.format_row(r)


def test_bench_ingest_without_opencv(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 fails
    res = bench_ingest.bench_ingest(n=2, T=8, workers=(1,))
    assert res["no_codec"] == bench_ingest.NO_CODEC
    rates = res["rates"]
    assert list(rates) == bench_ingest.keys((1,))
    codec = [k for k in rates if not k.startswith("null_")]
    assert codec == ["host_decode_fps", "pool_decode_fps@1",
                     "shm_decode_fps@1", "shm_decode_view_fps@1"]
    assert all(rates[k] is None for k in codec)
    assert _finite_pos(*(rates[k] for k in rates if k.startswith("null_")))
    lines = bench_ingest.report(res)
    assert any("null" in ln and "host_decode_fps" in ln for ln in lines)
    assert any(ln.startswith("# model: pool(k)") for ln in lines)


def test_entry_helpers_on_the_cpu():
    from lipreading_tpu_torch import profiling
    from lipreading_tpu_torch.ops import roi

    with pytest.raises(SystemExit, match="no CUDA device"):
        profiling.entry_device("cuda")
    assert profiling.entry_device("cpu") == torch.device("cpu")
    assert profiling.device_label("cpu") == "cpu"
    for args in ((torch.ones(2),), ()):
        with pytest.raises(ValueError, match="CUDA device"):
            profiling.cuda_ms(lambda *a: None, *args)
    with pytest.raises(ValueError, match="CUDA device"):
        profiling.device_kernels(lambda: None)
    counts = profiling.launch_counts()
    assert list(counts) == ["roi_sampler", "ctc_greedy", "ctc_lattice_fwd",
                            "ctc_lattice_bwd", "flash_fwd", "flash_bwd_fused",
                            "flash_bwd_dq", "flash_bwd_dkv", "conv3d_dgrad"]
    before = roi.sample_rois.launches
    try:
        roi.sample_rois.launches += 2
        assert profiling.launches_since(counts) == {"roi_sampler": 2}
    finally:
        roi.sample_rois.launches = before
    # the plain version runs on a CPU tensor, and counts no launch
    roi.sample_rois(torch.zeros(1, 16, 16), torch.tensor([[0, 0, 8]],
                                                         dtype=torch.int32), 4)
    assert profiling.launches_since(counts) == {}
