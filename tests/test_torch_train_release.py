"""The training path at the full width of the shipped universal4 release, on
the CPU: one ``compute_loss`` with gradients on 2 fixture clips against
``jax.value_and_grad`` of the JAX package's ``compute_loss`` (``rng=None``),
in float32 and in the release's bfloat16; and the training entry point,
``python -m lipreading_tpu_torch.train``, end to end at a small width.

Tolerances: float32 loss rtol 1e-5 and each gradient leaf rtol 1e-3 with
atol 1e-6 + 1e-4 of the leaf's largest entry (summation order; the k biases
hold only rounding noise); bfloat16 loss rtol 2e-2 and gradient cosine at
least 0.99 (each dense layer rounds to bfloat16 at places the frameworks do
not share, through 8 layers)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.preproc_training import load_release_model as j_load_release
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.data.pipeline import FixtureVideoDataset
from lipreading_tpu_torch.models import lipreader as tlr
from lipreading_tpu_torch.ops.detector import params_to_torch
from lipreading_tpu_torch.ops.ert import model_to_torch
from lipreading_tpu_torch.ops.preprocess import preprocess_clips
from lipreading_tpu_torch.train.checkpoint import latest_checkpoint

RELEASE = "transformer_hybrid_universal4"


@pytest.fixture(scope="module")
def release_batch():
    """Two word samples of a fixture clip (bucket 32) as a model batch,
    ROIs from the port's preprocessing. The release fits the fixtures (its
    loss on them is ~3e-5, where float32 rounding of -log p near 0 is all
    that is left to compare), so each sample gets the other's labels."""
    tree, cfg = tio.load_release(RELEASE)
    ds = FixtureVideoDataset(1, seed=4, cfg=cfg.data)
    vb = ds.batch([0, 1], 32)
    det_np, ert_np = tio.load_assets()
    rois = preprocess_clips(params_to_torch(det_np, "cpu"),
                            model_to_torch(ert_np, "cpu"),
                            torch.from_numpy(vb.frames), cfg.preprocess)
    swap = [1, 0]
    batch = {"rois": rois.numpy(), "frame_lengths": vb.frame_lengths,
             "targets": vb.targets[swap],
             "target_lengths": vb.target_lengths[swap],
             "ctc_labels": vb.ctc_labels[swap],
             "ctc_lengths": vb.ctc_lengths[swap]}
    jparams, jcfg = j_load_release(RELEASE)
    return tree, cfg, jparams, jcfg, batch


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_loss_and_grads_match_jax(release_batch, dtype):
    tree, cfg, params, jcfg, batch = release_batch
    cfg = cfg.override(**{"model.dtype": dtype})
    jcfg = jcfg.override(**{"model.dtype": dtype})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlr.compute_loss(p, jcfg, jb, rng=None), has_aux=True))(
            params)
    model = tlr.LipReader(cfg)
    model.load_state_dict(tio.from_jax_params(tree, cfg))
    loss, _ = tlr.compute_loss(
        model, cfg, {k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()}, gen=None)
    loss.backward()
    got = dict(_leaves(tio.to_jax_params(
        {k: p.grad for k, p in model.named_parameters()})))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jg)))
    assert sorted(got) == sorted(want)
    if dtype == "float32":
        assert loss.item() == pytest.approx(float(jl), rel=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k], w, rtol=1e-3, atol=1e-6 + 1e-4 * np.abs(w).max(),
                err_msg=k)
    else:
        assert loss.item() == pytest.approx(float(jl), rel=2e-2)
        a = np.concatenate([got[k].ravel() for k in sorted(want)])
        b = np.concatenate([want[k].ravel() for k in sorted(want)])
        assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) >= 0.99


SMALL = ["model.patch_dim=16", "model.frontend_dim=24", "model.tf_dim=32",
         "model.tf_heads=2", "model.tf_mlp=64", "model.tf_layers=1",
         "model.tf_dec_layers=1", "model.highway_layers=1",
         "data.batch_size=2", "data.time_buckets=32", "train.log_every=1",
         "train.warmup_steps=1"]


def test_entry_point_trains_and_resumes_on_the_cpu(tmp_path):
    """2 steps from scratch, then ``resume=1`` for 1 more: the checkpoint
    of step 3, the log lines, the resumed iterator position."""
    from lipreading_tpu_torch.config import preset
    from lipreading_tpu_torch.data.pipeline import VideoBatchIterator
    from lipreading_tpu_torch.train.__main__ import main

    wd = str(tmp_path / "run")
    base = ["device=cpu", f"workdir={wd}", "n_clips=1", "data_seed=2"] + SMALL
    last = main(base + ["steps=2"])
    assert np.isfinite(last["loss"]) and "frames_per_sec" in last
    assert latest_checkpoint(os.path.join(wd, "ckpt")).endswith("0002.msgpack")
    last = main(base + ["steps=1", "resume=1"])
    ckpt = latest_checkpoint(os.path.join(wd, "ckpt"))
    assert ckpt.endswith("ckpt_00000003.msgpack")
    cfg = preset("transformer-patchify").override(
        **{"data.time_buckets": "32"})
    it = VideoBatchIterator(FixtureVideoDataset(1, seed=2, cfg=cfg.data), 2)
    for _ in range(3):
        next(it)
    with open(ckpt.replace(".msgpack", ".json")) as f:
        assert json.load(f)["iterator_state"] == it.state
    with open(os.path.join(wd, "logs", "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3]
