"""The port's dataviews and dataview batches on the CPU, against the JAX
package: ``roi_to_u8`` / ``u8_to_roi``, the files each package writes and
the other reads, ``split_by_clip``, ``merge_dataviews``,
``build_fixture_dataview`` in five modes, ``BucketedDataset``,
``BatchIterator`` and ``batch_to_device``, and the
``generate_dataview`` entry.

Tolerances, each with its reason:
* exact: the index, the masks, the splits, the batch fields, the plans and
  ``batch_to_device``'s normalised ROIs (the same float32 divisions);
* the stored bytes (the boundary rule): the port's float ROIs agree with
  the JAX package's within the ROI tolerance of the preprocessing tests
  (1e-5 for the fixture landmarks and the ERT, 1e-4 for the conv
  landmarker, whose sub-pixel box moves with one float32 ulp of a
  landmark). ``roi_to_u8`` rounds g = (roi * std + mean) * 255 half up, so
  a byte may differ, by 1, only where JAX's g lies within that tolerance
  x std x 255 (plus 2 float32 ulps of 255) of a .5 boundary. No other
  byte may differ.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from lipreading_tpu.config import DataConfig as JData
from lipreading_tpu.config import PreprocessConfig as JPre
from lipreading_tpu.data import dataset as jds
from lipreading_tpu.data import dataview as jdv
from lipreading_tpu_torch.config import DataConfig, PreprocessConfig
from lipreading_tpu_torch.data import dataset as tds
from lipreading_tpu_torch.data import dataview as tdv
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

PRE = PreprocessConfig()
ROI_TOL = {"gt": 1e-5, "ert": 1e-5, "conv": 1e-4}
MODES = {
    "gt": dict(use_ground_truth_landmarks=True),
    "ert": dict(),
    "tracked_keep": dict(tracked=True, keep_invalid=True),
    "tracked_drop": dict(tracked=True),
    "conv": dict(landmarker="conv"),
}
SEED = 5


def _boundary_rule(j_rois, t_rois, roi_tol, j_u8, t_u8):
    """The stored bytes of one clip: equal, or 1 apart where JAX's value
    sits within the tolerance of a rounding boundary."""
    np.testing.assert_allclose(t_rois, j_rois, rtol=0, atol=roi_tol)
    g = (j_rois * PRE.normalize_std + PRE.normalize_mean) * 255.0
    near = (np.abs(g - np.floor(g) - 0.5)
            <= roi_tol * PRE.normalize_std * 255.0
            + 2 * np.spacing(np.float32(255)))
    diff = j_u8.astype(int) - t_u8.astype(int)
    assert np.abs(diff).max() <= 1
    assert not (diff != 0)[~near].any(), "a byte away from a boundary moved"


def _recorder(module):
    """Patch ``module.roi_to_u8`` to keep each clip's float ROIs."""
    seen = []
    real = module.roi_to_u8

    def rec(r, cfg):
        seen.append(np.array(r))
        return real(r, cfg)

    return seen, mock.patch.object(module, "roi_to_u8", rec)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """One clip in each mode, built by both packages: name -> (JAX view,
    port view, JAX float ROIs, port float ROIs)."""
    root = tmp_path_factory.mktemp("views")
    out = {}
    for name, kw in MODES.items():
        kw = dict(kw)
        lm = kw.pop("landmarker", "ert")
        if name == "tracked_keep":
            # two faceless frames inside the first cue
            kw["frame_transform"] = _blank_frames
        jseen, jpatch = _recorder(jdv)
        tseen, tpatch = _recorder(tdv)
        with jpatch:
            jv = jdv.build_fixture_dataview(str(root / f"j_{name}"), 1,
                                            seed=SEED,
                                            pre_cfg=JPre(landmarker=lm), **kw)
        with tpatch:
            tv = tdv.build_fixture_dataview(
                str(root / f"t_{name}"), 1, seed=SEED,
                pre_cfg=PreprocessConfig(landmarker=lm), device="cpu", **kw)
        out[name] = (jv, tv, jseen[0], tseen[0])
    return out


def _blank_frames(c, frames):
    out = frames.copy()
    out[5:7] = 0
    return out


def test_roi_to_u8_and_back_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (4, 96, 96)).astype(np.float32)
    # values whose g sits exactly on .5 boundaries, and past 0 and 255
    g = np.arange(-3, 260, dtype=np.float32) + np.float32(0.5)
    edge = ((g / np.float32(255.0)) - PRE.normalize_mean) / PRE.normalize_std
    for r in (x, edge.astype(np.float32)):
        want = jdv.roi_to_u8(r, JPre())
        got = tdv.roi_to_u8(r, PRE)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        back = tdv.u8_to_roi(got, PRE)
        assert back.dtype == np.float32
        assert np.array_equal(back, jdv.u8_to_roi(want, JPre()))


@pytest.mark.parametrize("mode", list(MODES))
def test_build_fixture_dataview_matches_jax(views, mode):
    jv, tv, jr, tr = views[mode]
    assert tv.samples == jv.samples and tv.meta == jv.meta
    lm = MODES[mode].get("landmarker", "gt" if mode == "gt" else "ert")
    _boundary_rule(jr, tr, ROI_TOL[lm], jdv.roi_to_u8(jr, JPre()),
                   tdv.roi_to_u8(tr, PRE))
    for i in range(len(jv)):
        assert tv.num_valid(i) == jv.num_valid(i)
        assert np.array_equal(tv.frame_valid(i), jv.frame_valid(i))
        a, b = jv.roi_u8(i), tv.roi_u8(i)
        assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1
    if mode == "tracked_keep":
        full = [i for i, s in enumerate(tv.samples)
                if s["file"].endswith("_full.npz")][0]
        v = tv.frame_valid(full)
        assert not v[5] and not v[6] and v.sum() < v.shape[0]


def test_views_read_across_packages(views, tmp_path):
    """A view written by either package reads in the other, with the same
    index and arrays; the same for a mask-keeping view."""
    for name in ("gt", "tracked_keep"):
        jv, tv, _, _ = views[name]
        for src, reader in ((jv, tdv.Dataview), (tv, jdv.Dataview)):
            other = reader(src.path)
            assert other.samples == src.samples and other.meta == src.meta
            for i in range(len(src)):
                assert np.array_equal(other.roi_u8(i), src.roi_u8(i))
                assert np.array_equal(other.frame_valid(i),
                                      src.frame_valid(i))
                assert np.array_equal(other.roi_u8_compact(i),
                                      src.roi_u8_compact(i))
    # the writer's files, byte for byte the layout JAX reads
    w = tdv.DataviewWriter(str(tmp_path / "w"), DataConfig(), PRE)
    w.add("a_cue00", np.arange(2 * 96 * 96).reshape(2, 96, 96) % 256, "x",
          frame_valid=np.array([True, False]))
    w.finalize()
    with open(tmp_path / "w" / "index.json") as f:
        idx = json.load(f)
    assert idx["samples"] == [{"file": "a_cue00.npz", "text": "x",
                               "num_frames": 2, "num_valid": 1}]
    assert jdv.Dataview(str(tmp_path / "w")).roi_u8_compact(0).shape == \
        (1, 96, 96)


def test_split_and_merge_match_jax(views, tmp_path):
    paths = [views[n][1].path for n in ("gt", "ert", "conv")]
    jm = jdv.merge_dataviews(str(tmp_path / "j"), paths)
    tm = tdv.merge_dataviews(str(tmp_path / "t"), paths)
    assert tm.samples == jm.samples and tm.meta == jm.meta
    for i in range(len(tm)):
        assert np.array_equal(tm.roi_u8(i), jm.roi_u8(i))
    # a second merge into the same directory replaces its files
    tm2 = tdv.merge_dataviews(str(tmp_path / "t"), paths[::-1])
    assert np.array_equal(tm2.roi_u8(0), views["conv"][1].roi_u8(0))
    for fr in ({"train": 0.9, "val": 0.1}, {"a": 0.5, "b": 0.3, "c": 0.2}):
        for seed in (0, 3):
            assert tdv.split_by_clip(tm, fr, seed) == \
                jdv.split_by_clip(jdv.Dataview(tm.path), fr, seed)
    assert tdv.clip_id_of(tm.samples[0]) == jdv.clip_id_of(tm.samples[0])
    other = views["gt"][1].path
    with open(os.path.join(other, "index.json")) as f:
        idx = json.load(f)
    idx["meta"]["roi_size"] = 64
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(bad / "index.json", "w") as f:
        json.dump(idx, f)
    with pytest.raises(ValueError, match="roi_size"):
        tdv.merge_dataviews(str(tmp_path / "m"), [other, str(bad)])


def _dataset_pair(view_path, buckets=(32, 64, 96)):
    jd = JData(time_buckets=buckets)
    td = DataConfig(time_buckets=buckets)
    return (jds.BucketedDataset(jdv.Dataview(view_path), jd),
            tds.BucketedDataset(tdv.Dataview(view_path), td))


def _same_batch(a, b):
    for f in ("rois_u8", "frame_lengths", "targets", "target_lengths",
              "ctc_labels", "ctc_lengths"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.texts == b.texts


def test_bucketed_batches_and_plans_match_jax(views):
    # the mask-keeping view buckets by its confident frames; bucket 32 cuts
    # the whole-clip sample, so its labels are capped at (t - 1) // 2
    for name, buckets in (("tracked_keep", (32, 64, 96)), ("gt", (32,))):
        jd, td = _dataset_pair(views[name][1].path, buckets)
        assert np.array_equal(td.sample_bucket, jd.sample_bucket)
        _same_batch(jd.make_batch(list(range(len(jd)))),
                    td.make_batch(list(range(len(td)))))
    jd, td = _dataset_pair(views["gt"][1].path)
    jit, tit = jds.BatchIterator(jd, 2, seed=4), tds.BatchIterator(td, 2,
                                                                   seed=4)
    for epoch in range(3):
        assert tit._make_plan(epoch) == jit._make_plan(epoch)
    for _ in range(5):                      # across an epoch's end
        _same_batch(next(jit), next(tit))
        assert tit.state == jit.state
    # resume mid-epoch
    state = tit.state
    resumed = tds.BatchIterator.from_state(td, 2, state)
    for _ in range(3):
        _same_batch(next(jit), next(resumed))
    split = tds.BucketedDataset(tdv.Dataview(views["gt"][1].path),
                                DataConfig(), indices=[3, 1])
    jsplit = jds.BucketedDataset(jdv.Dataview(views["gt"][1].path), JData(),
                                 indices=[3, 1])
    _same_batch(jsplit.make_batch([0, 1]), split.make_batch([0, 1]))


def test_batch_to_device_matches_jax_exactly(views):
    jd, td = _dataset_pair(views["conv"][1].path)
    b = td.make_batch(list(range(len(td))))
    # every byte value, so each division is checked
    b.rois_u8[0, 0].flat[:256] = np.arange(256, dtype=np.uint8)
    got = tds.batch_to_device(b, PRE.normalize_mean, PRE.normalize_std,
                              "cpu")
    want = jds.batch_to_device(b, PRE.normalize_mean, PRE.normalize_std)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    assert isinstance(got["rois"], torch.Tensor)


def test_generate_dataview_entry_matches_jax(views, tmp_path):
    """``generate_dataview gt_landmarks=1``: the JAX script's arguments and
    files (the JAX view of the "gt" mode was built with them)."""
    from lipreading_tpu_torch.generate_dataview import main

    jv = views["gt"][0]
    out = str(tmp_path / "gen")
    view = main([f"out={out}", "n_clips=1", f"seed={SEED}", "gt_landmarks=1",
                 "device=cpu"])
    assert view.samples == jv.samples and view.meta == jv.meta
    tv = views["gt"][1]                     # held to JAX's bytes above
    for i in range(len(jv)):
        assert np.array_equal(view.roi_u8(i), tv.roi_u8(i))
    merged = main([f"out={tmp_path / 'merged'}", f"merge={out},{jv.path}"])
    assert len(merged) == 2 * len(jv)
    with pytest.raises(SystemExit, match="unknown"):
        main([f"out={out}", "device=cpu", "nope=1"])
