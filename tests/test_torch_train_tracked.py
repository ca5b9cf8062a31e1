"""The port's fused trainer on the CPU against the JAX package's: the
tracked step (presence head, tracking, compaction of the faceless frames)
with the ERT and with the conv landmarker, the zero weight of a sample left
with no frame, and ``FusedTrainer.evaluate`` untracked and tracked, at a
small width and on the universal4 release.

Tolerances, each with its reason (those of ``tests/test_torch_train.py``):
float32 loss rtol 1e-5 and gradients rtol 1e-3 with atol 1e-6 + 1e-4 of
the leaf's largest entry (summation order; the k biases hold only rounding
noise); the zero-weight pin and the compaction exactly; transcripts
string-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.data.pipeline import FixtureVideoDataset as JVideoDataset
from lipreading_tpu.data.pipeline import VideoBatch as JVideoBatch
from lipreading_tpu.fixtures import blank_out_frames, make_clip
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.ops.detector import params_to_jax
from lipreading_tpu.ops.ert import model_to_jax
from lipreading_tpu.ops.landmarker import params_to_jax as lmk_to_jax
from lipreading_tpu.ops.preprocess import preprocess_clips_tracked
from lipreading_tpu.ops.tracking import compact_valid_frames
from lipreading_tpu.preproc_training import (
    load_assets,
    load_landmarker,
    load_presence,
)
from lipreading_tpu.train.loop import FusedTrainer as JFused
from lipreading_tpu_torch.data.pipeline import FixtureVideoDataset
from lipreading_tpu_torch.data.pipeline import VideoBatch
from lipreading_tpu_torch.io import load_preprocessors, to_jax_params
from lipreading_tpu_torch.train.loop import FusedTrainer
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)
from tests.test_torch_train_dataview import _cfgs, _grads_close, _leaves

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

T = 12


def _labels(seed, B=2):
    rng = np.random.default_rng(seed)
    return dict(
        targets=np.pad(rng.integers(3, 30, (B, 5)).astype(np.int32),
                       ((0, 0), (0, 3))),
        target_lengths=np.full((B,), 5, np.int32),
        ctc_labels=rng.integers(3, 30, (B, 6)).astype(np.int32),
        ctc_lengths=np.full((B,), 3, np.int32), texts=["x"] * B)


def _tracked_batch():
    """The batch of the JAX package's tracked-step test: make_clip(31) with
    frames 4-5 a cutaway, beside the clean clip."""
    clip = make_clip(31)
    frames = blank_out_frames(clip, [4, 5], seed=9)[:T]
    return dict(frames=np.stack([frames, clip.frames[:T]]),
                frame_lengths=np.asarray([T, T], np.int32), **_labels(0))


def _jax_lmk(lm):
    det, ert = load_assets()
    return params_to_jax(det), (model_to_jax(ert) if lm == "ert"
                                else lmk_to_jax(load_landmarker()))


def _pair(tmp_path, lm, tracked, **train):
    """JAX and port FusedTrainers with the same (seeded) parameters."""
    cfg, jcfg = _cfgs(**train)
    over = {"preprocess.landmarker": lm}
    cfg, jcfg = cfg.override(**over), jcfg.override(**over)
    jcfg.mesh.data_parallel = 1
    jdet, jlmk = _jax_lmk(lm)
    jt = JFused(jcfg, str(tmp_path / "j"), jdet, jlmk,
                presence=load_presence() if tracked else None,
                tracked=tracked)
    det, lmk, presence = load_preprocessors(lm, tracked=tracked, device="cpu")
    tt = FusedTrainer(cfg, str(tmp_path / "t"), det, lmk, device="cpu",
                      presence=presence, tracked=tracked)
    tt.logger.echo = jt.logger.echo = False
    tt.warm_start(jax.tree_util.tree_map(np.asarray, jt.params))
    return jt, tt


def _jax_tracked_grads(jt, batch):
    """Loss and gradient leaves of the JAX tracked step's loss, its model
    batch made as ``FusedTrainer._build_fused_step`` makes it, and the
    compacted lengths."""
    cfg = jt.cfg

    def loss_fn(p, det, presence, ert, b):
        rois, valid = preprocess_clips_tracked(det, presence, ert,
                                               b["frames"], cfg.preprocess)
        rois, new_len = compact_valid_frames(rois, valid, b["frame_lengths"])
        mb = dict(b, rois=rois, frame_lengths=jnp.maximum(new_len, 1),
                  ctc_lengths=jnp.minimum(b["ctc_lengths"],
                                          jnp.maximum((new_len - 1) // 2, 1)),
                  sample_weight=(new_len > 0).astype(jnp.float32))
        del mb["frames"]
        loss, _ = jlr.compute_loss(p, cfg, mb, rng=None)
        return loss, new_len

    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "texts"}
    (loss, new_len), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jt.params, jt._det, jt._presence, jt._ert, b)
    return (float(loss), dict(_leaves(jax.tree_util.tree_map(np.asarray, g))),
            np.asarray(new_len))


@pytest.mark.parametrize("lm", ["ert", "conv"])
def test_tracked_step_matches_jax(tmp_path, lm):
    batch = _tracked_batch()
    jt, tt = _pair(tmp_path, lm, tracked=True)
    jl, jg, new_len = _jax_tracked_grads(jt, batch)
    assert new_len.tolist() == [T - 2, T]        # the cutaway compacted
    mb = tt.model_batch({k: torch.as_tensor(v) for k, v in batch.items()
                         if k != "texts"})
    assert mb["frame_lengths"].tolist() == new_len.tolist()
    assert mb["sample_weight"].tolist() == [1.0, 1.0]
    jm = jt.train_step(JVideoBatch(**batch))
    tm = tt.train_step(VideoBatch(**batch))
    assert float(jm["loss"]) == pytest.approx(jl, rel=1e-6)
    assert float(tm["loss"]) == pytest.approx(jl, rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-4)
    got = dict(_leaves(to_jax_params(
        {k: p.grad for k, p in tt.model.named_parameters()})))
    assert sorted(got) == sorted(jg)
    _grads_close(got, jg)


@pytest.mark.parametrize("lm", ["ert", "conv"])
def test_faceless_sample_weighs_nothing(tmp_path, lm):
    """A sample whose every frame fails the presence gate compacts to no
    frame: weight 0, and the loss bit-identical whatever its pixels (the
    JAX package's pin, tests/test_tracked_dataview.py)."""
    clip = make_clip(33)
    det, lmk, presence = load_preprocessors(lm, tracked=True, device="cpu")
    cfg, _ = _cfgs()
    cfg = cfg.override(**{"preprocess.landmarker": lm})
    losses = []
    for i, seed in enumerate((9, 10)):       # two faceless backgrounds
        faceless = blank_out_frames(clip, range(T), seed=seed)[:T]
        batch = VideoBatch(frames=np.stack([faceless, clip.frames[:T]]),
                           frame_lengths=np.asarray([T, T], np.int32),
                           **_labels(1))
        tr = FusedTrainer(cfg, str(tmp_path / f"run{i}"), det, lmk,
                          device="cpu", presence=presence, tracked=True)
        tr.logger.echo = False
        mb = tr.model_batch({k: torch.as_tensor(getattr(batch, k)) for k in
                             ("frames", "frame_lengths", "targets",
                              "target_lengths", "ctc_labels",
                              "ctc_lengths")})
        assert mb["sample_weight"].tolist() == [0.0, 1.0]
        assert mb["frame_lengths"].tolist() == [1, T]
        assert mb["ctc_lengths"].tolist() == [1, 3]
        losses.append(float(tr.train_step(batch)["loss"]))
    assert np.isfinite(losses[0])
    assert losses[0] == losses[1], losses


@pytest.mark.parametrize("tracked", [False, True])
def test_fused_evaluate_matches_jax(tmp_path, tracked):
    """``FusedTrainer.evaluate`` on raw frames (the whole batch
    preprocessed, then compacted when tracked) at beam 8: the JAX
    trainer's transcripts, CER and WER from the same parameters."""
    jt, tt = _pair(tmp_path, "ert", tracked)
    ds, jds = (FixtureVideoDataset(1, seed=4, cfg=tt.cfg.data),
               JVideoDataset(1, seed=4, cfg=jt.cfg.data))
    tb, jb = ds.batch([0, 1, 2], 64), jds.batch([0, 1, 2], 64)
    if tracked:
        for b in (tb, jb):
            b.frames[0, 3:9] = 0             # a cutaway in the first sample
    m = tt.evaluate([tb], beam=8)
    assert m == jt.evaluate([jb], beam=8)
    lines = open(tt.logger.path).read().splitlines()
    jlines = open(jt.logger.path).read().splitlines()
    assert lines[-1].split('"sample_decode": ')[1] == \
        jlines[-1].split('"sample_decode": ')[1]
