"""The conv3d stem, the Bahdanau GRU attention decoder and the model
families built on them, against the JAX package on the CPU at a small
size: weights from the JAX package's init functions carried across by
``io.from_jax_params``, inputs made with numpy from a seed.

* the stem (``frontend_apply``) at R 96 with channels (4, 8, 12) on an odd
  clip length, float32 and bfloat16, GroupNorm per sample and per frame;
  a symmetric 2-pixel pad of the 5x5 stride-2 convolution (where XLA pads
  1 before and 2 after) must break the float32 limit;
* the decoder: ``attend`` and ``decoder_step``, and ``teacher_forced_logits``
  at teacher forcing 1.0 and 0.0 (both deterministic in both packages); at
  0.5 the port's coins come from the generator;
* the five variants of ``tests/test_models.py`` (bi-GRU x {ctc, attention,
  hybrid}, transformer after the conv3d stem x {ctc, hybrid}): the loss
  and every gradient, transcripts at beam 1 and 3, and the parameter tree.

Tolerances: float32 1e-5 for the stem and the decoder (the same ops; only
summation order differs); in bfloat16 5e-2, the limit of
``test_torch_models.py::test_encode_logprobs_match_jax_bfloat16``; the loss
and gradients within ``test_compute_loss_and_grads_match_jax_float32``'s
limits (loss rtol 1e-5, gradients rtol 1e-3 with atol 1e-6 + 1e-4 of the
leaf's largest entry); transcripts string-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lipreading_tpu.config import preset as jpreset
from lipreading_tpu.infer import transcribe as j_transcribe
from lipreading_tpu.models import attention as jatt
from lipreading_tpu.models import frontend3d as jfe
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu_torch.config import preset
from lipreading_tpu_torch.infer import transcribe
from lipreading_tpu_torch.io import from_jax_params, to_jax_params
from lipreading_tpu_torch.models import attention as tatt
from lipreading_tpu_torch.models import frontend3d as tfe
from lipreading_tpu_torch.models import lipreader as tlr
from lipreading_tpu_torch.models import nn as tnn
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

VARIANTS = [("bigru", "ctc"), ("bigru", "attention"), ("bigru", "hybrid"),
            ("transformer", "hybrid"), ("transformer", "ctc")]
TINY = {"model.frontend_channels": (4, 8, 12), "model.frontend_dim": 32,
        "model.gru_hidden": 24, "model.gru_layers": 1, "model.tf_layers": 1,
        "model.tf_dec_layers": 1, "model.tf_dim": 32, "model.tf_heads": 2,
        "model.tf_mlp": 64, "model.dtype": "float32",
        "model.dropout": 0.0, "train.max_decode_len": 8,
        "train.beam_width": 3}


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _cfgs(enc="bigru", dec="ctc", **extra):
    """The tiny config of ``tests/test_models.py`` (dropout off) in both
    packages."""
    kw = dict(TINY, encoder=enc, decoder=dec, **extra)
    if dec == "hybrid":
        kw.update({"train.ctc_weight": 0.5, "train.att_weight": 0.5})
    return preset("bigru-ctc").override(**kw), jpreset("bigru-ctc").override(**kw)


def _model(cfg, jcfg, seed=0):
    tree = _tree(jlr.init_model(jax.random.PRNGKey(seed), jcfg))
    model = tlr.LipReader(cfg)
    model.load_state_dict(from_jax_params(tree, cfg))
    return model.eval(), tree


def _rois(B=2, T=11, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (B, T, 96, 96)).astype(np.float32)


# --- the conv3d stem ---


@pytest.mark.parametrize("framewise", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_stem_matches_jax(dtype, framewise):
    cfg, jcfg = _cfgs(**{"model.framewise_norm": framewise})
    model, tree = _model(cfg, jcfg, seed=3)
    rois = _rois(T=7, seed=3)                     # odd length, R 96
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    want = jfe.frontend_apply(tree["frontend"], jnp.asarray(rois), jdt,
                              framewise_norm=framewise)
    with torch.no_grad():
        got = tfe.frontend_apply(model.frontend, _t(rois), tdt)
    assert got.shape == (2, 7, 32) and got.dtype == (tdt or torch.float32)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


def test_conv3d_stem_pads_like_xla_same():
    """XLA's SAME pad of the 5x5 stride-2 convolution at R 96 is 1 before
    and 2 after; a symmetric pad of 2 shifts the output grid by a pixel and
    must break the stem's float32 limit."""
    assert tnn._same_pads(96, 5, 2) == (1, 2)
    cfg, jcfg = _cfgs()
    model, tree = _model(cfg, jcfg, seed=4)
    rois = _rois(T=5, seed=4)
    want = np.asarray(jfe.frontend_apply(tree["frontend"], jnp.asarray(rois)))

    def symmetric(x, w, b, strides=(1, 1, 1), dtype=None):
        pad = (w.shape[1] // 2,) * 2
        pads = (pad[0], pad[1], pad[0], pad[1], 1, 1)
        xc = F.pad(x.permute(0, 4, 1, 2, 3), pads)
        y = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=tuple(strides))
        return y.permute(0, 2, 3, 4, 1) + b

    with torch.no_grad():
        got = tfe.frontend_apply(model.frontend, _t(rois)).numpy()
        real = tnn.conv3d
        tnn.conv3d = symmetric
        try:
            bad = tfe.frontend_apply(model.frontend, _t(rois)).numpy()
        finally:
            tnn.conv3d = real
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(bad - want).max() > 1e-2


# --- the Bahdanau decoder ---


def _decoder(seed=5, enc_dim=20, T=9, B=3):
    cfg, jcfg = _cfgs("bigru", "attention", **{"model.decoder_hidden": 16,
                                               "model.attn_dim": 12})
    tree = _tree(jatt.attn_decoder_init(jax.random.PRNGKey(seed), jcfg.model,
                                        enc_dim))
    dec = tatt.AttnDecoder(cfg.model, enc_dim)
    dec.load_state_dict(from_jax_params(tree, cfg))
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(B, T, enc_dim)).astype(np.float32)
    lengths = np.asarray([T, 5, 1], np.int32)
    return dec.eval(), tree, enc, lengths


def test_bias_free_dense_layers_hold_no_bias():
    dec, tree, _, _ = _decoder()
    assert "b" not in tree["attn_enc"] and "b" not in tree["attn_v"]
    names = set(dec.state_dict())
    assert "attn_enc.w" in names and "attn_enc.b" not in names
    assert "attn_v.w" in names and "attn_v.b" not in names
    assert "attn_dec.b" in names


def test_attend_and_decoder_step_match_jax():
    dec, tree, enc, lengths = _decoder()
    rng = np.random.default_rng(6)
    h = rng.normal(size=(3, 16)).astype(np.float32)
    tok = np.asarray([1, 7, 30], np.int32)
    mask = np.arange(enc.shape[1])[None, :] < lengths[:, None]
    jproj = jatt.precompute_attention(tree, jnp.asarray(enc))
    jctx, jw = jatt.attend(tree, jnp.asarray(h), jnp.asarray(enc), jproj,
                           jnp.asarray(mask))
    jh, jlogits = jatt.decoder_step(tree, jnp.asarray(h), jnp.asarray(tok),
                                    jnp.asarray(enc), jproj, jnp.asarray(mask))
    with torch.no_grad():
        proj = tatt.precompute_attention(dec, _t(enc))
        ctx, w = tatt.attend(dec, _t(h), _t(enc), proj, _t(mask))
        th, tlogits = tatt.decoder_step(dec, _t(h), _t(tok), _t(enc), proj,
                                        _t(mask))
    for got, want in ((proj, jproj), (ctx, jctx), (w, jw), (th, jh),
                      (tlogits, jlogits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert (w.numpy()[~mask] == 0).all()
    assert tlogits.dtype == torch.float32


@pytest.mark.parametrize("teacher_forcing", [1.0, 0.0])
def test_teacher_forced_logits_match_jax(teacher_forcing):
    """At 1.0 every step feeds the target; at 0.0 (JAX's ``coin < 0`` never
    holds) every step feeds the previous argmax, token 0 at step 0."""
    dec, tree, enc, lengths = _decoder(seed=7)
    targets = np.random.default_rng(7).integers(3, 31, (3, 6)).astype(np.int32)
    targets[:, 0] = 1
    want = jatt.teacher_forced_logits(
        tree, jnp.asarray(enc), jnp.asarray(lengths), jnp.asarray(targets),
        teacher_forcing=teacher_forcing, rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        got = tatt.teacher_forced_logits(
            dec, _t(enc), _t(lengths), _t(targets),
            teacher_forcing=teacher_forcing,
            gen=torch.Generator().manual_seed(0))
    assert got.shape == (3, 5, 31)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_scheduled_sampling_draws_from_the_generator():
    dec, _, enc, lengths = _decoder(seed=8)
    targets = np.random.default_rng(8).integers(3, 31, (3, 12)).astype(np.int32)

    def run(seed):
        with torch.no_grad():
            return tatt.teacher_forced_logits(
                dec, _t(enc), _t(lengths), _t(targets), teacher_forcing=0.5,
                gen=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all() and a.shape == (3, 11, 31)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    with torch.no_grad():
        forced = tatt.teacher_forced_logits(dec, _t(enc), _t(lengths),
                                            _t(targets), teacher_forcing=0.5)
    # no generator: no coins, every step feeds the target
    np.testing.assert_array_equal(
        forced.numpy(),
        tatt.teacher_forced_logits(dec, _t(enc), _t(lengths), _t(targets)
                                   ).detach().numpy())


# --- the five variants ---


def _batch(seed=0, B=2, T=10, L=8):
    rng = np.random.default_rng(seed)
    return {"rois": _rois(B, T, seed),
            "frame_lengths": np.asarray([T, 7], np.int32),
            "targets": rng.integers(3, 30, (B, L)).astype(np.int32),
            "target_lengths": np.asarray([6, 5], np.int32),
            "ctc_labels": rng.integers(3, 30, (B, L)).astype(np.int32),
            "ctc_lengths": np.asarray([4, 3], np.int32)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("enc,dec", VARIANTS)
def test_variant_loss_and_gradients_match_jax(enc, dec):
    cfg, jcfg = _cfgs(enc, dec)
    model, tree = _model(cfg, jcfg, seed=11)
    batch = _batch(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlr.compute_loss(p, jcfg, jb, rng=None), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    loss, metrics = tlr.compute_loss(
        model, cfg, {k: _t(v) for k, v in batch.items()}, gen=None)
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    assert set(metrics) == set(jm)
    for k in metrics:
        assert metrics[k].item() == pytest.approx(float(jm[k]), rel=1e-5)
    got = dict(_leaves(to_jax_params(
        {k: p.grad for k, p in model.named_parameters()})))
    want = dict(_leaves(_tree(jg)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=1e-3, atol=1e-6 + 1e-4 * np.abs(w).max(),
            err_msg=k)


@pytest.mark.parametrize("enc,dec", VARIANTS)
def test_variant_transcripts_match_jax(enc, dec):
    cfg, jcfg = _cfgs(enc, dec)
    model, tree = _model(cfg, jcfg, seed=12)
    batch = _batch(12)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    for beam in (1, 3):
        want = j_transcribe(params, jcfg, jnp.asarray(batch["rois"]),
                            jnp.asarray(batch["frame_lengths"]), beam=beam)
        got = transcribe(model, cfg, batch["rois"], batch["frame_lengths"],
                         beam=beam)
        assert got == want, (beam, got, want)


@pytest.mark.parametrize("enc,dec", VARIANTS)
def test_variant_init_tree_has_jax_paths_and_shapes(enc, dec):
    cfg, jcfg = _cfgs(enc, dec)
    got = dict(_leaves(to_jax_params(
        tlr.init_model(cfg, device="cpu").state_dict())))
    want = {k: v.shape for k, v in _leaves(_tree(
        jlr.init_model(jax.random.PRNGKey(0), jcfg)))}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.shape == want[k], k
        assert v.dtype == np.float32
    if enc == "bigru":
        # GRU cells uniform in +-1/sqrt(H), as gru_cell_init draws them
        bound = 1 / np.sqrt(cfg.model.gru_hidden)
        w = got["/encoder/layers/0/fwd/w_ih"]
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
