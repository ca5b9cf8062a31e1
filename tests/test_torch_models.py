"""The port's model layers and the universal4 model family
(``lipreading_tpu_torch.models``), and a model of each family the JAX
package's ``init_model`` builds besides it, against the JAX package on the
CPU, at a small size: weights from the JAX package's ``init_model``
carried across by ``io.from_jax_params``, inputs made with numpy from a
seed.

Tolerances: 1e-4 in float32, where both sides run the same operations and
only summation order differs; 5e-2 on the CTC log-probabilities in bfloat16,
where each dense layer and the attention round to bfloat16 (8 bits of
mantissa, 4e-3 relative) at places the two frameworks do not share, through
a few layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.config import Config as JConfig
from lipreading_tpu.config import ModelConfig as JModel
from lipreading_tpu.models import frontend3d as jfe
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.models import nn as jnn
from lipreading_tpu.models import transformer as jtf
from lipreading_tpu_torch.config import Config, ModelConfig
from lipreading_tpu_torch.io import from_jax_params
from lipreading_tpu_torch.models import frontend3d as tfe
from lipreading_tpu_torch.models import lipreader as tlr
from lipreading_tpu_torch.models import nn as tnn
from lipreading_tpu_torch.models import transformer as ttf

B, T, R = 2, 12, 96          # the patchify stem is built for 96x96 ROIs


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(dtype="float32", framewise=True):
    kw = dict(frontend="patchify", patch_dim=16, frontend_dim=24, tf_dim=32,
              tf_heads=2, tf_mlp=64, tf_layers=2, tf_dec_layers=1,
              highway_layers=2, framewise_norm=framewise, dtype=dtype)
    return (Config(encoder="transformer", decoder="hybrid",
                   model=ModelConfig(**kw)),
            JConfig(encoder="transformer", decoder="hybrid", model=JModel(**kw)))


def _model(cfg, jcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray,
                                  jlr.init_model(jax.random.PRNGKey(seed), jcfg))
    model = tlr.LipReader(cfg)
    model.load_state_dict(from_jax_params(tree, cfg))
    return model.eval(), tree


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    rois = rng.normal(0, 1, size=(B, T, R, R)).astype(np.float32)
    lengths = np.asarray([T, T - 5], np.int32)
    return rois, lengths


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(3, 2, size=(4, 5, 32)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 32).astype(np.float32),
         "bias": rng.normal(0, 0.1, 32).astype(np.float32)}
    want = np.asarray(jnn.layernorm(p, jnp.asarray(x, dtype)).astype(jnp.float32))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = tnn.layernorm(_t(x).to(tdt), _t(p["scale"]), _t(p["bias"]))
    assert got.dtype == tdt
    # bf16 output: one bf16 ulp where the float32 results straddle a rounding
    tol = 1e-5 if dtype == jnp.float32 else 2 ** -7 * 4
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("framewise", [False, True])
@pytest.mark.parametrize("channels", [16, 12])     # gcd(8, 12) = 4 groups
def test_groupnorm_matches_jax(framewise, channels):
    rng = np.random.default_rng(1)
    x = rng.normal(1, 3, size=(2, 5, 3, 3, channels)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, channels).astype(np.float32),
         "bias": rng.normal(0, 0.1, channels).astype(np.float32)}
    want = np.asarray(jnn.groupnorm(p, jnp.asarray(x), framewise=framewise))
    got = tnn.groupnorm(_t(x), _t(p["scale"]), _t(p["bias"]),
                        framewise=framewise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dense_casts_like_jax():
    """With a dtype both w and b are cast to it; without one, bf16 x f32
    promotes to float32 as jnp does (the CTC head's case)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    p = {"w": rng.normal(size=(8, 5)).astype(np.float32),
         "b": rng.normal(size=5).astype(np.float32)}
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16), (None, None)):
        xj = jnp.asarray(x, jnp.bfloat16)
        want = np.asarray(jnn.dense(p, xj, dt).astype(jnp.float32))
        got = tnn.dense(_t(x).bfloat16(), _t(p["w"]), _t(p["b"]), tdt)
        assert got.dtype == (torch.bfloat16 if dt else torch.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_conv3d_and_maxpool_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 6, 6, 5)).astype(np.float32)
    p = {"w": rng.normal(size=(3, 3, 3, 5, 7)).astype(np.float32) * 0.2,
         "b": rng.normal(size=7).astype(np.float32)}
    want = np.asarray(jnn.conv3d(p, jnp.asarray(x)))
    got = tnn.conv3d(_t(x), _t(p["w"]), _t(p["b"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tnn.maxpool3d(_t(got)).numpy(),
                                  np.asarray(jnn.maxpool3d(jnp.asarray(got))))


def test_patchify_matches_jax():
    cfg, jcfg = _cfgs()
    model, tree = _model(cfg, jcfg)
    rois, _ = _inputs()
    want = np.asarray(jfe.patchify_apply(tree["frontend"], jnp.asarray(rois),
                                         jcfg.model))
    with torch.no_grad():
        got = tfe.patchify_apply(model.frontend, _t(rois), cfg.model).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_encoder_matches_jax():
    cfg, jcfg = _cfgs()
    model, tree = _model(cfg, jcfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, cfg.model.frontend_dim)).astype(np.float32)
    _, lengths = _inputs()
    want = np.asarray(jtf.encoder_apply(tree["encoder"], jnp.asarray(x),
                                        jnp.asarray(lengths), cfg.model.tf_heads))
    with torch.no_grad():
        got = ttf.encoder_apply(model.encoder, _t(x), _t(lengths),
                                cfg.model.tf_heads).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("framewise", [True, False])
def test_encode_and_logprobs_match_jax_float32(framewise):
    cfg, jcfg = _cfgs(framewise=framewise)
    model, tree = _model(cfg, jcfg, seed=1)
    rois, lengths = _inputs(1)
    jenc = jlr.encode(tree, jcfg, jnp.asarray(rois), jnp.asarray(lengths))
    want = np.asarray(jax.nn.log_softmax(jlr.ctc_logits(tree, jenc), axis=-1))
    with torch.no_grad():
        enc = tlr.encode(model, cfg, _t(rois), _t(lengths))
        got = torch.log_softmax(tlr.ctc_logits(model, enc), -1).numpy()
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_encode_logprobs_match_jax_bfloat16():
    cfg, jcfg = _cfgs(dtype="bfloat16")
    model, tree = _model(cfg, jcfg, seed=2)
    rois, lengths = _inputs(2)
    jenc = jlr.encode(tree, jcfg, jnp.asarray(rois), jnp.asarray(lengths))
    assert jenc.dtype == jnp.bfloat16
    want = np.asarray(jax.nn.log_softmax(jlr.ctc_logits(tree, jenc), axis=-1))
    with torch.no_grad():
        enc = tlr.encode(model, cfg, _t(rois), _t(lengths))
        got = torch.log_softmax(tlr.ctc_logits(model, enc), -1)
    assert enc.dtype == torch.bfloat16 and got.dtype == torch.float32
    valid = np.arange(T)[None, :] < lengths[:, None]
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=0,
                               atol=5e-2)


@pytest.mark.parametrize("change", ["bigru", "attention", "conv3d"])
def test_later_slices_raise_not_implemented(change):
    """The three models this test once held refused (the bi-GRU encoder, a
    decoder without the CTC head, the conv3d stem) now build, and each
    one's forward matches the JAX package's in float32: the encoder output,
    the CTC log-probabilities where it has the head, and the teacher-forced
    attention logits where it has a decoder."""
    cfg, jcfg = _cfgs()
    small = {"gru_hidden": 12, "gru_layers": 2, "attn_dim": 8,
             "decoder_hidden": 12, "frontend_channels": (4, 8, 12)}
    if change == "bigru":
        top = {"encoder": "bigru"}
    elif change == "attention":
        top = {"decoder": "attention"}
    else:
        top, small["frontend"] = {}, "conv3d"
    cfg = Config(**{**cfg.__dict__, **top, "model": ModelConfig(
        **{**cfg.model.__dict__, **small})})
    jcfg = JConfig(**{**jcfg.__dict__, **top, "model": JModel(
        **{**jcfg.model.__dict__, **small})})
    model, tree = _model(cfg, jcfg, seed=3)
    rois, lengths = _inputs(3)
    rng = np.random.default_rng(3)
    targets = rng.integers(3, 31, (B, 6)).astype(np.int32)
    jenc = jlr.encode(tree, jcfg, jnp.asarray(rois), jnp.asarray(lengths))
    with torch.no_grad():
        enc = tlr.encode(model, cfg, _t(rois), _t(lengths))
        pairs = [(enc, jenc)]
        if cfg.decoder != "attention":
            pairs.append((torch.log_softmax(tlr.ctc_logits(model, enc), -1),
                          jax.nn.log_softmax(jlr.ctc_logits(tree, jenc), -1)))
        if cfg.decoder != "ctc":
            pairs.append((
                tlr.attention_logits(model, cfg, enc, _t(lengths),
                                     _t(targets)),
                jlr.attention_logits(tree, jcfg, jenc, jnp.asarray(lengths),
                                     jnp.asarray(targets))))
    assert len(pairs) == 3 - (cfg.decoder != "hybrid")
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_runs_in_full_float32(monkeypatch, dtype):
    """The model's convolutions (the patchify stem's) run with cuDNN's TF32
    off, whatever the caller allowed, as the detector's do; the caller's
    setting comes back after the call."""
    seen = []
    real = tnn.F.conv3d

    def spy(*a, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*a, **kw)

    monkeypatch.setattr(tnn.F, "conv3d", spy)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = torch.ones((1, 2, 4, 4, 3), dtype=dtype)
        w = torch.ones((3, 3, 3, 3, 5))
        tnn.conv3d(x, w, torch.zeros(5), dtype=dtype)
        assert seen == [False]
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
