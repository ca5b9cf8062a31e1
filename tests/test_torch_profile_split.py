"""The component splits of the port's ``profile_decode`` and
``profile_train`` against the JAX scripts' own components, at a tiny float32
width on the CPU, weights carried across by ``io.from_jax_params``:

* ``profile_decode.att_steps`` and ``ctc_steps`` equal the JAX script's
  isolated loops (``scripts/profile_decode.py:106-151``, built here from
  the JAX package's ``decoder_step`` / ``ctc_candidate_scores`` /
  ``ctc_chosen_lattice``) within 1e-4 relative;
* ``profile_train``'s component losses and gradient norms equal
  ``jax.grad`` of the same losses (``scripts/profile_train.py:144-211``)
  within 1e-4 relative, with and without remat; its MFU numerators equal
  the JAX expressions exactly.

1e-4 relative: both sides are float32 and sum in other orders (the decoder
steps' softmax over 48 steps, the lattices' log-sum-exps over T). The
frontend's and encoder's losses are sums of their whole outputs, and the
encoder's ends in a layer norm, so its sum is cancellation noise near 0:
those two losses may also part by N x 1.2e-7 (N the entries summed, each
of size ~1: the worst float32 rounding of such a sum); their gradient
norms are held to 1e-4 relative all the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu import flops as jflops
from lipreading_tpu.config import preset as jpreset
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.models import transformer as jtf
from lipreading_tpu.models.frontend3d import frontend_apply
from lipreading_tpu.ops import joint_decode as jjd
from lipreading_tpu.ops.ctc import ctc_loss_best as j_ctc_loss_best
from lipreading_tpu_torch import profile_decode, profile_train
from lipreading_tpu_torch.config import preset
from lipreading_tpu_torch.io import from_jax_params, to_jax_params
from lipreading_tpu_torch.models.lipreader import LipReader, init_model
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

TINY = {"model.dtype": "float32", "model.tf_dim": 32, "model.tf_heads": 2,
        "model.tf_mlp": 64, "model.frontend_dim": 24,
        "model.frontend_channels": (4, 8, 12), "model.tf_layers": 1,
        "model.tf_dec_layers": 1, "model.highway_layers": 1}
RTOL = 1e-4
SUM_EPS = 1.2e-7        # float32 rounding of each entry of a summed output


def _cfgs(**extra):
    over = dict(TINY, **extra)
    return (preset("transformer-attn").override(**over),
            jpreset("transformer-attn").override(**over))


def _lists(tree):
    """A tree keyed "0", "1", ... where the JAX package holds lists."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return [_lists(tree[str(i)]) for i in range(len(tree))]
    return {k: _lists(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    """(port model, JAX params, port cfg, JAX cfg) at the tiny width: the
    port's draws as the JAX tree (``to_jax_params``; the JAX package's own
    init takes 12-20 s here), loaded back by ``from_jax_params``."""
    cfg, jcfg = _cfgs()
    tree = to_jax_params(init_model(cfg, device="cpu").state_dict())
    params = jax.tree_util.tree_map(jnp.asarray, _lists(tree))
    model = LipReader(cfg)
    model.load_state_dict(from_jax_params(tree, cfg))
    return model, params, cfg, jcfg


def test_att_steps_equal_jax_loop(models):
    model, params, cfg, jcfg = models
    B, T, beam, L = 2, 12, 3, 10
    heads = cfg.model.tf_heads
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((B, T, cfg.model.tf_dim)).astype(np.float32)
    lengths = np.array([T, T - 4], np.int32)
    enc_t, len_t = np.repeat(enc, beam, 0), np.repeat(lengths, beam, 0)
    BW = B * beam
    p = params["att_decoder"]

    def att_only(p, enc_t, len_t):                  # :106-125
        cache = jtf.decoder_init_cache(p, BW, L, heads, jnp.float32)
        ckv = jtf.decoder_cross_kv(p, enc_t, heads, jnp.float32)

        def body(c, tok):
            c2, logits = jtf.decoder_step(p, c, tok, enc_t, len_t, heads,
                                          jnp.float32, cross_kv=ckv)
            return c2, logits.max()

        _, outs = jax.lax.scan(body, cache, jnp.ones((L, BW), jnp.int32))
        return outs.sum()

    want = float(jax.jit(att_only)(p, jnp.asarray(enc_t),
                                   jnp.asarray(len_t)))
    with torch.inference_mode():
        got = float(profile_decode.att_steps(
            model.att_decoder, torch.from_numpy(enc_t),
            torch.from_numpy(len_t), L, heads, torch.float32))
    assert got == pytest.approx(want, rel=RTOL)


def test_ctc_steps_equal_jax_loop():
    BW, T, V, L = 6, 20, 31, 12
    rng = np.random.default_rng(6)
    ctc_t = rng.normal(0, 2, (BW, T, V)).astype(np.float32)
    len_t = np.array([20, 20, 16, 16, 9, 9], np.int32)

    def ctc_only(ctc_t, len_t):                     # :130-151
        lp = jjd.mask_ctc_logp(ctc_t, len_t, 0)
        state = jjd.init_ctc_prefix_state(lp, 0)

        def body(st, tok):
            psi_ext, full_lp, emit = jjd.ctc_candidate_scores(st, lp, 0)
            emit_c = jnp.take_along_axis(
                emit, tok[:, None, None], axis=2)[:, :, 0]
            lp_c = jnp.take_along_axis(lp, tok[:, None, None],
                                       axis=2)[:, :, 0]
            r_n, r_b = jjd.ctc_chosen_lattice(emit_c, lp_c, lp[:, :, 0])
            st2 = dict(st, r_n=r_n, r_b=r_b,
                       psi=jnp.take_along_axis(psi_ext, tok[:, None],
                                               axis=1)[:, 0],
                       last=tok, empty=jnp.zeros_like(st["empty"]))
            return st2, psi_ext.max()

        toks = jnp.full((L, BW), 3, jnp.int32)
        _, outs = jax.lax.scan(body, state, toks)
        return outs.sum()

    want = float(jax.jit(ctc_only)(jnp.asarray(ctc_t), jnp.asarray(len_t)))
    got = float(profile_decode.ctc_steps(torch.from_numpy(ctc_t),
                                         torch.from_numpy(len_t), L))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=RTOL)


def _norm(tree) -> float:
    return float(np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                             for g in jax.tree_util.tree_leaves(tree))))


def _jax_components(params, jcfg, x):
    """The JAX script's component losses (:144-211) -> {row: (loss, norm,
    entries the loss sums)}."""
    m = jcfg.model
    dtype = jnp.float32
    j = {k: jnp.asarray(v) for k, v in x.items()}
    heads = m.tf_heads

    def fe(q):
        return frontend_apply(q, j["rois"], dtype).astype(jnp.float32).sum()

    def enc(q):
        return jtf.encoder_apply(q, j["feats"], j["lengths"], heads,
                                 dtype=dtype, flash=m.flash_attention
                                 ).astype(jnp.float32).sum()

    def dec(q):
        att = jtf.decoder_apply(q, j["targets"][:, :-1], j["enc"],
                                j["lengths"], heads, dtype=dtype)
        return jlr.cross_entropy_loss(att, j["targets"][:, 1:],
                                      j["tlen"] + 2)

    def ctc(q):
        lg = jlr.ctc_logits({"ctc_head": q}, j["enc"])
        return j_ctc_loss_best(lg, j["labels"], j["lengths"],
                               j["llen"]).mean()

    def n_out(sub):
        """How many float32 entries the loss sums: the frontend's and the
        encoder's whole outputs; the others are means."""
        if sub == "frontend":
            return j["rois"].shape[0] * j["rois"].shape[1] * m.frontend_dim
        if sub == "encoder":
            return j["feats"].shape[0] * j["feats"].shape[1] * m.tf_dim
        return 0

    if jcfg.train.remat:
        fe = jax.checkpoint(fe)
    out = {}
    for name, fn, sub in (("frontend fwd+bwd", fe, "frontend"),
                          ("encoder fwd+bwd", enc, "encoder"),
                          ("decoder fwd+bwd", dec, "att_decoder"),
                          ("ctc head+loss fwd+bwd", ctc, "ctc_head")):
        loss, g = jax.jit(jax.value_and_grad(fn))(params[sub])
        out[name] = (float(loss), _norm(g), float(n_out(sub)))
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_profile_train_components_equal_jax_grad(models, remat):
    model, params, cfg, jcfg = models
    if remat:
        cfg = cfg.override(**{"train.remat": True})
        jcfg = jcfg.override(**{"train.remat": True})
    B, T, L = 2, 8, 3
    x = profile_train.make_inputs(cfg, B, T, L)
    want = _jax_components(params, jcfg, x)
    got = profile_train.component_grads(
        model, cfg, profile_train.to_device(x, torch.float32, "cpu"))
    assert list(got) == list(want)
    for name, (loss, norm, n) in want.items():
        assert np.isfinite(got[name][0]) and got[name][1] > 0, name
        assert got[name][0] == pytest.approx(loss, rel=RTOL,
                                             abs=n * SUM_EPS), name
        assert got[name][1] == pytest.approx(norm, rel=RTOL), name


@pytest.mark.parametrize("name,over", [
    ("transformer-attn", {}),
    ("transformer-attn", {"train.remat": True}),
    ("transformer-patchify", {}),
    ("bigru-ctc", {}),
])
def test_profile_train_mfu_numerators_equal_jax(name, over):
    cfg = preset(name).override(**over) if over else preset(name)
    jcfg = jpreset(name).override(**over) if over else jpreset(name)
    B, T, L = 64, 64, 13
    fr_mult = 4 if jcfg.train.remat else 3           # :158
    want = {"full step": 3 * B * jflops.model_fwd_flops(jcfg, T, L),
            "frontend fwd+bwd": fr_mult * B * jflops.frontend_flops(jcfg, T)}
    if jcfg.encoder == "transformer":
        want["encoder fwd+bwd"] = (
            3 * B * jflops.transformer_encoder_flops(jcfg, T))
        if jcfg.decoder in ("attention", "hybrid"):
            want["decoder fwd+bwd"] = (
                3 * B * jflops.transformer_decoder_flops(jcfg, T, L))
    if jcfg.decoder in ("ctc", "hybrid"):
        want["ctc head+loss fwd+bwd"] = 3 * B * jflops.ctc_head_flops(jcfg, T)
    want["optimizer (AdamW)"] = 0.0
    assert profile_train.mfu_numerators(cfg, B, T, L) == want
