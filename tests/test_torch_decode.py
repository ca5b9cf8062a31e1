"""The port's CTC greedy collapse and the cascade's greedy leg
(``lipreading_tpu_torch.ops.decode``, ``lipreading_tpu_torch.infer``)
against the JAX package on the CPU.

Greedy ids are compared exactly: both sides take the first maximum, so a
tie must resolve the same way. The JAX side runs both ``ctc_greedy_ids``
and the Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.config import Config as JConfig
from lipreading_tpu.config import ModelConfig as JModel
from lipreading_tpu.infer import _greedy_conf_jit
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.ops.decode import ctc_greedy_ids as j_greedy
from lipreading_tpu.ops.decode_pallas import ctc_greedy_ids_pallas
from lipreading_tpu_torch.config import Config, ModelConfig
from lipreading_tpu_torch.infer import greedy_conf
from lipreading_tpu_torch.io import from_jax_params
from lipreading_tpu_torch.models.lipreader import LipReader
from lipreading_tpu_torch.ops import decode as tdec


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(name, seed=0):
    """(logits [B, T, V] f32, lengths [B] i32) with many exact ties."""
    rng = np.random.default_rng(seed)
    B, T, V = {"ties": (4, 16, 31), "t1": (3, 1, 31), "zero": (3, 9, 7),
               "t128": (2, 128, 31), "long": (3, 300, 31)}[name]
    logits = rng.integers(0, 3, size=(B, T, V)).astype(np.float32)
    lengths = rng.integers(0, T + 1, size=B).astype(np.int32)
    lengths[-1] = T
    if name == "zero":
        lengths[:] = 0
    return logits, lengths


@pytest.mark.parametrize("name", ["ties", "t1", "zero", "t128", "long"])
def test_ctc_greedy_ids_matches_jax(name):
    logits, lengths = _case(name)
    want_ids, want_n = (np.asarray(x) for x in
                        j_greedy(jnp.asarray(logits), jnp.asarray(lengths)))
    p_ids, p_n = (np.asarray(x) for x in ctc_greedy_ids_pallas(
        jnp.asarray(logits), jnp.asarray(lengths), interpret=True))
    ids, n = tdec.ctc_greedy_ids(_t(logits), _t(lengths))
    assert ids.dtype == torch.int32 and n.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(n.numpy(), want_n)
    np.testing.assert_array_equal(ids.numpy(), p_ids)
    np.testing.assert_array_equal(n.numpy(), p_n)


def test_ctc_greedy_ids_matches_jax_long_clips():
    """The long-clip shape of the serving path with flash attention: B 4 x
    T 1024 x V 31, lengths 940..980 (one chunk of the kernel), many ties."""
    rng = np.random.default_rng(1024)
    logits = rng.integers(0, 3, size=(4, 1024, 31)).astype(np.float32)
    lengths = rng.integers(940, 981, size=4).astype(np.int32)
    want_ids, want_n = (np.asarray(x) for x in
                        j_greedy(jnp.asarray(logits), jnp.asarray(lengths)))
    p_ids, p_n = (np.asarray(x) for x in ctc_greedy_ids_pallas(
        jnp.asarray(logits), jnp.asarray(lengths), interpret=True))
    ids, n = tdec.ctc_greedy_ids(_t(logits), _t(lengths))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(n.numpy(), want_n)
    np.testing.assert_array_equal(ids.numpy(), p_ids)
    np.testing.assert_array_equal(n.numpy(), p_n)
    assert (n.numpy() > 0).all()


def test_ctc_greedy_first_max_and_collapse():
    """A hand-made row: ties go to the lower id; repeats merge; a blank
    splits a repeat; frames past the length are ignored."""
    V = 5
    want_path = [2, 2, 0, 2, 3, 3, 1, 4]       # argmax per frame
    logits = np.zeros((1, 8, V), np.float32)
    for t, k in enumerate(want_path):
        logits[0, t, k] = 1.0
    logits[0, 1, 4] = 1.0                      # tie with 2: 2 wins
    ids, n = tdec.ctc_greedy_ids(_t(logits), _t(np.int32([7])))
    assert n.tolist() == [4]
    assert ids[0].tolist() == [2, 2, 3, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("bad", ["dtype", "lengths_dtype", "shape"])
def test_ctc_greedy_rejects_bad_inputs(bad):
    logits = torch.zeros((2, 4, 5))
    lengths = torch.zeros((2,), dtype=torch.int32)
    if bad == "dtype":
        logits = logits.half()
    elif bad == "lengths_dtype":
        lengths = lengths.long()
    else:
        lengths = lengths[:1]
    with pytest.raises((TypeError, ValueError)):
        tdec.ctc_greedy_ids(logits, lengths)


def test_ctc_greedy_cpu_counts_no_launch():
    logits, lengths = _case("ties")
    before = tdec.ctc_greedy_ids.launches
    tdec.ctc_greedy_ids(_t(logits), _t(lengths))
    assert tdec.ctc_greedy_ids.launches == before


def test_greedy_conf_matches_jax_float32():
    """The cascade's greedy leg on a small float32 model: ids and counts
    exact, confidence within 1e-4 (float32, summation order only)."""
    kw = dict(frontend="patchify", patch_dim=16, frontend_dim=24, tf_dim=32,
              tf_heads=2, tf_mlp=64, tf_layers=2, tf_dec_layers=1,
              highway_layers=1, framewise_norm=True, dtype="float32")
    cfg = Config(encoder="transformer", decoder="hybrid", model=ModelConfig(**kw))
    jcfg = JConfig(encoder="transformer", decoder="hybrid", model=JModel(**kw))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jlr.init_model(jax.random.PRNGKey(5), jcfg))
    model = LipReader(cfg)
    model.load_state_dict(from_jax_params(tree, cfg))
    rng = np.random.default_rng(6)
    rois = rng.normal(size=(3, 10, 96, 96)).astype(np.float32)
    lengths = np.int32([10, 4, 0])
    w_ids, w_n, w_conf, w_enc = (np.asarray(x) for x in _greedy_conf_jit(jcfg)(
        tree, jnp.asarray(rois), jnp.asarray(lengths)))
    ids, n, conf, enc = greedy_conf(model.eval(), cfg, _t(rois), _t(lengths))
    np.testing.assert_array_equal(ids.numpy(), w_ids)
    np.testing.assert_array_equal(n.numpy(), w_n)
    np.testing.assert_allclose(conf.numpy(), w_conf, rtol=0, atol=1e-4)
    np.testing.assert_allclose(enc.numpy(), w_enc, rtol=0, atol=1e-4)
    assert n[2] == 0 and conf[2] == 0.0
