"""The port's GRU layers (``lipreading_tpu_torch.models.gru``) against the
JAX package's and against ``torch.nn.GRU`` on the CPU, at a small size:
weights from the JAX package's ``bigru_init`` carried across by
``io.from_jax_params``, inputs made with numpy from a seed, lengths of
every kind (full, short, 1).

Tolerances: 1e-5 in float32, padded positions included (both sides run the
same ops; only the products' summation order differs); in bfloat16, where
each op of the step rounds to 8 bits of mantissa, 5e-2, the limit of
``test_torch_models.py::test_encode_logprobs_match_jax_bfloat16``;
``flip_sequences`` exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.models import gru as jgru
from lipreading_tpu.models import nn as jnn
from lipreading_tpu_torch.io import from_jax_params
from lipreading_tpu_torch.models import gru as tgru
from lipreading_tpu_torch.models import nn as tnn

from tests.test_torch_helpers import file_hang_guard  # noqa: F401

pytestmark = pytest.mark.usefixtures("file_hang_guard")

B, T, D, H = 3, 11, 10, 8
LENGTHS = np.asarray([T, 7, 1], np.int32)


def _bigru(layers: int, seed: int = 0):
    tree = jax.tree_util.tree_map(
        np.asarray, jgru.bigru_init(jax.random.PRNGKey(seed), D, H, layers))
    model = tgru.BiGRU(D, H, layers)
    model.load_state_dict(from_jax_params(tree, None))
    return model.eval(), tree


def _x(seed: int = 0):
    return np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32)


def test_flip_sequences_matches_jax_exactly():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, 2, 3)).astype(np.float32)
    for lengths in (LENGTHS, np.asarray([T, T, T], np.int32),
                    np.asarray([0, 1, 2], np.int32)):
        want = np.asarray(jnn.flip_sequences(jnp.asarray(x),
                                             jnp.asarray(lengths)))
        got = tnn.flip_sequences(torch.from_numpy(x),
                                 torch.from_numpy(lengths)).numpy()
        np.testing.assert_array_equal(got, want)


def test_gru_layer_matches_jax_float32():
    model, tree = _bigru(1, seed=1)
    x = _x(1)
    want, want_h = jgru.gru_layer(tree["layers"][0]["fwd"], jnp.asarray(x))
    with torch.no_grad():
        got, got_h = tgru.gru_layer(model.layers[0].fwd, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("layers", [1, 2])
def test_bigru_matches_jax_float32(layers):
    model, tree = _bigru(layers, seed=layers)
    x = _x(layers)
    want = np.asarray(jgru.bigru(tree, jnp.asarray(x), jnp.asarray(LENGTHS)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(LENGTHS)).numpy()
    assert got.shape == (B, T, 2 * H)
    # every position, the padded ones included
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layers", [1, 2])
def test_bigru_matches_jax_bfloat16(layers):
    model, tree = _bigru(layers, seed=10 + layers)
    x = _x(10 + layers)
    want = jgru.bigru(tree, jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(LENGTHS), dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16(), torch.from_numpy(LENGTHS),
                    torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=5e-2)


def test_bigru_matches_torch_nn_gru_float32():
    """Variable lengths against ``torch.nn.GRU`` over packed sequences (the
    reference's semantics) on the valid positions, as tests/test_gru.py
    holds the JAX package."""
    torch.manual_seed(2)
    tg = torch.nn.GRU(D, H, batch_first=True, bidirectional=True,
                      num_layers=2)
    model = tgru.BiGRU(D, H, 2)
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            for cell, sfx in ((layer.fwd, f"_l{i}"),
                              (layer.bwd, f"_l{i}_reverse")):
                cell.w_ih.copy_(getattr(tg, f"weight_ih{sfx}").T)
                cell.w_hh.copy_(getattr(tg, f"weight_hh{sfx}").T)
                cell.b_ih.copy_(getattr(tg, f"bias_ih{sfx}"))
                cell.b_hh.copy_(getattr(tg, f"bias_hh{sfx}"))
        x = torch.from_numpy(_x(2))
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x, LENGTHS.tolist(), batch_first=True, enforce_sorted=False)
        out, _ = tg(packed)
        want, _ = torch.nn.utils.rnn.pad_packed_sequence(
            out, batch_first=True, total_length=T)
        got = model(x, torch.from_numpy(LENGTHS))
    for b, L in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, :L].numpy(), want[b, :L].numpy(),
                                   rtol=0, atol=1e-5)


def test_bigru_gradients_match_jax_float32():
    model, tree = _bigru(2, seed=5)
    x = _x(5)
    w = np.random.default_rng(6).normal(size=(B, T, 2 * H)).astype(np.float32)

    def jloss(p, xx):
        return (jgru.bigru(p, xx, jnp.asarray(LENGTHS)) * w).sum()

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(tree, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (model(xt, torch.from_numpy(LENGTHS)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jg), None)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
