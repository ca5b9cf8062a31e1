"""The port's encoder, training entry and release loading with flash
attention on (``model.flash_attention=1``), against the JAX package on the
CPU (Pallas kernels in interpret mode, the port's plain versions); the
attention op itself is held in ``tests/test_torch_flash.py``.

Tolerances, as max|port - JAX| / max|JAX|: float32 2e-5, the JAX tests'
limit (only the order of the sums differs); bf16 3e-2, since the
projections, the layer norms' casts and the ``xla`` backward's einsums run
in bf16 on both sides, each rounding in its own places, and the differences
add up through the layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.config import ModelConfig as JModel
from lipreading_tpu.models import transformer as jtf
from lipreading_tpu_torch.config import Config, ModelConfig
from lipreading_tpu_torch.io import from_jax_params
from lipreading_tpu_torch.models import transformer as ttf
from lipreading_tpu_torch.ops import flash_attention as tfa

F32, BF16 = 2e-5, 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _f(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.detach().float().numpy()


def _enc(dtype, seed=0):
    """A 2-layer encoder (tf_dim 32, 4 heads) from the JAX package's
    initialisation, on both sides, and an input at T = 32."""
    kw = dict(frontend="patchify", tf_dim=32, tf_heads=4, tf_mlp=64,
              tf_layers=2, frontend_dim=16, flash_attention=True)
    jcfg, cfg = JModel(**kw), ModelConfig(**kw)
    tree = jax.tree_util.tree_map(
        np.asarray, jtf.encoder_init(jax.random.PRNGKey(seed), jcfg, 16))
    full = Config(encoder="transformer", decoder="ctc", model=cfg)
    state = from_jax_params({"encoder": tree}, full)
    enc = ttf.TransformerEncoder(cfg, 16)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in state.items()})
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 32, 16)).astype(np.float32)
    w = rng.normal(0, 1, (2, 32, 32)).astype(np.float32)
    return cfg, tree, enc, x, w, np.asarray([32, 21], np.int32)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bwd", ["xla", "pallas", "fused"])
def test_encoder_flash_matches_jax_vjp(bwd, dtype):
    """encoder_apply(flash=True) values, and the gradients of the input and
    of every parameter through ``jax.vjp``, under each backward policy."""
    cfg, tree, enc, x, w, ln = _enc(dtype)
    jd, td = DTYPES[dtype]

    def f(p, xx):
        return jtf.encoder_apply(p, xx, jnp.asarray(ln), cfg.tf_heads,
                                 dtype=jd, flash=True, flash_bwd=bwd)

    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    # the input in the activation type, as the frontend hands it on
    want, vjp = jax.vjp(f, jtree, jnp.asarray(x, jd))
    gp, gx = vjp(jnp.asarray(w, want.dtype))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    got = ttf.encoder_apply(enc, xt, torch.from_numpy(ln), cfg.tf_heads,
                            dtype=td, flash=True, flash_bwd=bwd)
    got.backward(torch.from_numpy(w).to(got.dtype))
    tol = F32 if dtype == "float32" else BF16
    assert _rel(_f(got), _f(want)) <= tol
    assert _rel(_f(xt.grad), _f(gx)) <= tol
    # each parameter's gradient against the largest of them all: some are
    # 0 by the algebra (the key bias shifts every score of a row alike), and
    # there both sides hold rounding noise
    params = dict(enc.named_parameters())
    pairs = [(params[n].grad.numpy(), g) for n, g in
             _paths(jax.tree_util.tree_map(np.asarray, gp))]
    scale = max(np.abs(g).max() for _, g in pairs)
    for (pg, g), name in zip(pairs, (n for n, _ in _paths(gp))):
        assert np.abs(pg - g).max() / scale <= tol, name


@pytest.mark.parametrize("bwd", ["pallas", "fused"])
def test_entry_point_fine_tunes_with_flash_on_the_cpu(tmp_path, monkeypatch,
                                                      bwd):
    """``python -m lipreading_tpu_torch.train model.flash_attention=1
    model.flash_bwd=...`` at a tiny width on the CPU: finite losses, and the
    encoder's attention goes through the flash plain versions of that
    policy."""
    from lipreading_tpu_torch.train.__main__ import main

    calls = {}

    def counting(name):
        real = getattr(tfa, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)

        monkeypatch.setattr(tfa, name, wrapped)

    for name in ("flash_fwd_reference", "flash_bwd_fused_reference",
                 "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
                 "reference_attend"):
        counting(name)
    small = ["model.patch_dim=16", "model.frontend_dim=24",
             "model.tf_dim=32", "model.tf_heads=2", "model.tf_mlp=64",
             "model.tf_layers=1", "model.tf_dec_layers=1",
             "model.highway_layers=1", "data.batch_size=2",
             "data.time_buckets=32", "train.log_every=1",
             "train.warmup_steps=1"]
    last = main(["device=cpu", f"workdir={tmp_path}", "n_clips=1", "steps=2",
                 "model.flash_attention=1", f"model.flash_bwd={bwd}"] + small)
    assert np.isfinite(last["loss"])
    want_bwd = {"fused": "flash_bwd_fused_reference",
                "pallas": "flash_bwd_dkv_reference"}[bwd]
    assert calls.get("flash_fwd_reference", 0) == 2       # 1 layer, 2 steps
    assert calls.get(want_bwd, 0) == 2


def test_release_loads_with_flash_and_encodes_as_without(monkeypatch):
    """universal4 with ``model.flash_attention=1``: the same weights load
    (flash adds no parameter), and in float32, where flash and the einsum
    attention are one function, a short random ROI clip encodes as it does
    with flash off (2e-5 of the largest state)."""
    from lipreading_tpu_torch.io import load_release_model
    from lipreading_tpu_torch.models import lipreader as tlr

    f32 = {"model.dtype": "float32"}
    model, cfg = load_release_model(
        "transformer_hybrid_universal4", device="cpu",
        overrides=dict(f32, **{"model.flash_attention": 1}))
    plain, cfg0 = load_release_model("transformer_hybrid_universal4",
                                     device="cpu", overrides=f32)
    assert cfg.model.flash_attention and not cfg0.model.flash_attention
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              plain.state_dict().items()):
        assert torch.equal(a, b), n
    rng = np.random.default_rng(0)
    R = cfg.preprocess.roi_size
    rois = torch.from_numpy(rng.normal(0, 1, (2, 16, R, R)).astype(np.float32))
    ln = torch.tensor([16, 11], dtype=torch.int32)
    calls = []
    real = tfa.flash_fwd_reference
    monkeypatch.setattr(tfa, "flash_fwd_reference",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        got = tlr.encode(model, cfg, rois, ln)
        assert len(calls) == cfg.model.tf_layers
        want = tlr.encode(plain, cfg0, rois, ln)
    assert len(calls) == cfg.model.tf_layers
    assert _rel(got.numpy(), want.numpy()) <= F32
