"""The port's GPipe encoder (``lipreading_tpu_torch/parallel/pipeline.py``)
against the JAX package's ``pipeline_encoder_apply`` and the port's plain
encoder, as ``tests/test_pipeline_parallel.py`` sets it up: 4 layers,
tf_dim 32, 4 heads, MLP 64, float32, B 8, T 24, ragged lengths. The ranks
(4 gloo ranks on the CPU, ``tests/torch_dist_work.pipeline_cases``) are
spawned once for the file; the JAX references run here on conftest's
8-device mesh.

Tolerances: outputs 2e-5, the JAX tests' limit; with flash on, the port's
flash plain version against JAX's Pallas kernel in interpret mode, the same
limit. Gradients of ``sum(out * w)`` per leaf within 1e-4 of the leaf's
largest entry plus 1e-6 (the k biases' true gradient is 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.config import MeshConfig as JMesh
from lipreading_tpu.parallel.mesh import make_mesh as jmake_mesh
from lipreading_tpu.parallel.pipeline import (
    pipeline_encoder_apply as jpipeline,
)
from lipreading_tpu_torch.config import MeshConfig
from lipreading_tpu_torch.io import from_jax_params
from lipreading_tpu_torch.parallel.mesh import make_mesh
from lipreading_tpu_torch.parallel.pipeline import pipeline_encoder_apply
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_helpers import few_torch_threads  # noqa: F401
from tests.test_torch_ring import _jax_tree
from tests.torch_dist_work import encoder, pipeline_cases, spawn

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

KW = dict(tf_dim=32, tf_heads=4, tf_mlp=64, tf_layers=4, frontend_dim=16)
TOL = 2e-5
CASES = [("2_2", 2, 2, False), ("4_2", 4, 2, False), ("4_4", 4, 4, False),
         ("4_2_flash", 4, 2, True)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tree = _jax_tree(KW)
    state = {k: v.numpy() for k, v in from_jax_params(tree).items()}
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (8, 24, 16)).astype(np.float32)
    lengths = rng.integers(8, 25, (8,)).astype(np.int32)
    w = rng.normal(0, 1, (8, 24, 32)).astype(np.float32)
    ranks = spawn(4, pipeline_cases, (KW, state, x, lengths, w),
                  str(tmp_path_factory.mktemp("pipeline")))
    enc = encoder(KW, 16, state)
    plain = enc(torch.from_numpy(x), torch.from_numpy(lengths))
    (plain * torch.from_numpy(w)).sum().backward()
    return dict(tree=tree, x=x, lengths=lengths, ranks=ranks, state=state,
                plain=plain.detach().numpy(),
                grads={n: p.grad.numpy() for n, p in enc.named_parameters()})


@pytest.mark.parametrize("key,mp,mb,flash", CASES, ids=[c[0] for c in CASES])
def test_pipeline_matches_jax_pipeline_encoder_apply(case, key, mp, mb,
                                                     flash):
    jm = jmake_mesh(JMesh(data_parallel=8 // mp, model_parallel=mp))
    want = np.asarray(jpipeline(case["tree"], jnp.asarray(case["x"]),
                                jnp.asarray(case["lengths"]), KW["tf_heads"],
                                jm, microbatches=mb, flash=flash))
    for o in case["ranks"]:
        lo, hi = o[f"rows{key}"]
        np.testing.assert_allclose(o[f"fwd{key}"], want[lo:hi], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("key,mp,mb,flash", CASES, ids=[c[0] for c in CASES])
def test_pipeline_matches_the_plain_encoder(case, key, mp, mb, flash):
    for o in case["ranks"]:
        lo, hi = o[f"rows{key}"]
        assert hi - lo == 8 // (4 // mp)
        np.testing.assert_allclose(o[f"fwd{key}"], case["plain"][lo:hi],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("key,mp,mb,flash", CASES, ids=[c[0] for c in CASES])
def test_pipeline_gradients_match_the_plain_encoder(case, key, mp, mb, flash):
    for o in case["ranks"]:
        got = o[f"grad{key}"]
        for name, want in case["grads"].items():
            err = np.abs(got[name] - want).max()
            assert err <= 1e-4 * np.abs(want).max() + 1e-6, (name, err)


def test_dropout_draws_apart_on_each_data_rank(case):
    a, b = (case["ranks"][r]["dropout"] for r in (0, 2))   # data ranks 0, 1
    assert np.isfinite(a).all() and np.isfinite(b).all()
    # the same rows on both data ranks, other masks
    assert not np.allclose(a, b)
    np.testing.assert_array_equal(a, case["ranks"][1]["dropout"])


@pytest.mark.parametrize("layers,mb,match", [
    (3, 0, "tf_layers=3 not divisible by pipe stages 4"),
    (4, 3, "local batch 8 not divisible by microbatches 3")])
def test_pipeline_refuses_what_does_not_split(case, layers, mb, match):
    kw = dict(KW, tf_layers=layers)
    state = {k: v for k, v in case["state"].items()
             if not k.startswith("layers.3.") or layers == 4}
    enc = encoder(kw, 16, state)
    mesh = make_mesh(MeshConfig(model_parallel=4), world=4)
    with pytest.raises(ValueError, match=match):
        pipeline_encoder_apply(enc, torch.zeros(8, 24, 16),
                               torch.full((8,), 24), KW["tf_heads"], mesh,
                               microbatches=mb)
