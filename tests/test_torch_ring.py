"""The port's ring attention (``lipreading_tpu_torch/parallel/ring.py``)
against the JAX package's ``ring_encoder_apply`` and against the port's
plain encoder, as ``tests/test_ring.py`` sets it up: 2 layers, tf_dim 32,
4 heads, MLP 64, float32, T 32, one padded sample. The ranks (4 gloo ranks
on the CPU, ``tests/torch_dist_work.ring_cases``) are spawned once for the
file; the JAX references run here on conftest's 8-device mesh.

Tolerances: outputs 2e-5, the JAX tests' limit (the online softmax sums in
another order). Gradients of ``sum(out * w)`` per leaf within 1e-4 of the
leaf's largest entry plus 1e-6: the k biases' true gradient is 0 (softmax
ignores a constant shift), so they hold rounding noise alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.config import MeshConfig as JMesh
from lipreading_tpu.config import preset as jpreset
from lipreading_tpu.models import transformer as jtf
from lipreading_tpu.parallel.mesh import make_mesh as jmake_mesh
from lipreading_tpu.parallel.ring import ring_encoder_apply as jring
from lipreading_tpu_torch.config import MeshConfig
from lipreading_tpu_torch.io import from_jax_params
from lipreading_tpu_torch.parallel.mesh import make_mesh
from lipreading_tpu_torch.parallel.ring import ring_encoder_apply
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_helpers import few_torch_threads  # noqa: F401
from tests.torch_dist_work import encoder, ring_cases, spawn

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

KW = dict(tf_dim=32, tf_heads=4, tf_mlp=64, tf_layers=2, frontend_dim=16)
TOL = 2e-5


def _jax_tree(kw, seed=0):
    jcfg = jpreset("transformer-attn")
    for k, v in kw.items():
        setattr(jcfg.model, k, v)
    return jax.tree_util.tree_map(np.asarray, jtf.encoder_init(
        jax.random.PRNGKey(seed), jcfg.model, kw["frontend_dim"]))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tree = _jax_tree(KW)
    state = {k: v.numpy() for k, v in from_jax_params(tree).items()}
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 32, 16)).astype(np.float32)
    lengths = np.asarray([32, 21], np.int32)       # one full, one padded
    w = rng.normal(0, 1, (2, 32, 32)).astype(np.float32)
    x3 = rng.normal(0, 1, (3, 32, 16)).astype(np.float32)
    lengths3 = np.asarray([32, 9, 30], np.int32)
    ranks = spawn(4, ring_cases, (KW, state, x, lengths, w, x3, lengths3),
                  str(tmp_path_factory.mktemp("ring")))
    enc = encoder(KW, 16, state)
    plain = enc(torch.from_numpy(x), torch.from_numpy(lengths))
    (plain * torch.from_numpy(w)).sum().backward()
    return dict(tree=tree, x=x, lengths=lengths, ranks=ranks,
                plain=plain.detach().numpy(),
                grads={n: p.grad.numpy() for n, p in enc.named_parameters()},
                plain3=enc(torch.from_numpy(x3),
                           torch.from_numpy(lengths3)).detach().numpy())


@pytest.mark.parametrize("mp", [2, 4])
def test_ring_matches_jax_ring_encoder_apply(case, mp):
    jm = jmake_mesh(JMesh(data_parallel=8 // mp, model_parallel=mp))
    want = np.asarray(jring(case["tree"], jnp.asarray(case["x"]),
                            jnp.asarray(case["lengths"]), KW["tf_heads"], jm))
    for o in case["ranks"]:
        lo, hi = o[f"rows{mp}"]
        np.testing.assert_allclose(o[f"fwd{mp}"], want[lo:hi], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("mp", [2, 4])
def test_ring_matches_the_plain_encoder_and_splits_rows_over_data(case, mp):
    rows = set()
    for o in case["ranks"]:
        lo, hi = o[f"rows{mp}"]
        rows.add((lo, hi))
        np.testing.assert_allclose(o[f"fwd{mp}"], case["plain"][lo:hi],
                                   rtol=TOL, atol=TOL)
    # mp 2 leaves 2 data ranks, one sample each; mp 4 one data rank
    assert rows == ({(0, 1), (1, 2)} if mp == 2 else {(0, 2)})


@pytest.mark.parametrize("mp", [2, 4])
def test_ring_gradients_match_the_plain_encoder(case, mp):
    for o in case["ranks"]:
        got = o[f"grad{mp}"]
        assert set(got) == set(case["grads"])
        for name, want in case["grads"].items():
            err = np.abs(got[name] - want).max()
            assert err <= 1e-4 * np.abs(want).max() + 1e-6, (name, err)


def test_a_batch_that_does_not_split_replicates_over_data(case):
    for o in case["ranks"]:
        np.testing.assert_allclose(o["fwd_b3"], case["plain3"], rtol=TOL,
                                   atol=TOL)


def test_dropout_draws_apart_on_each_data_rank(case):
    a, b = (case["ranks"][r]["dropout"] for r in (0, 2))   # data ranks 0, 1
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert not np.allclose(a, b)
    # the two model ranks of one data rank gather the same output
    np.testing.assert_array_equal(a, case["ranks"][1]["dropout"])


def test_ring_rejects_a_T_that_does_not_split():
    enc = encoder(KW, 16, {k: v.numpy() for k, v in
                           from_jax_params(_jax_tree(KW)).items()})
    mesh = make_mesh(MeshConfig(model_parallel=4), world=4)
    with pytest.raises(ValueError, match="T=30 not divisible by model size 4"):
        ring_encoder_apply(enc, torch.zeros(2, 30, 16),
                           torch.tensor([30, 30]), KW["tf_heads"], mesh)
