"""The port's mesh and collectives (``lipreading_tpu_torch/parallel/mesh.py``
and ``comm.py``) against the JAX package's ``parallel/mesh.py`` on
conftest's 8-device CPU mesh: ``make_mesh``'s sizes and refusals, each
rank's place on the grid, ``shard_batch``'s and ``shard_host_local_batch``'s
rows, the tensor-parallel plan against ``model_param_shardings``; then the
collectives and ``replicate`` on 4 gloo ranks spawned once for the file
(``tests/torch_dist_work.py``), forward and backward, a wait past its
timeout, and the batch iterators' per-rank rows. The values compared are
exact: rows, ranks and small integers move or sum without rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.config import MeshConfig as JMesh
from lipreading_tpu.config import preset as jpreset
from lipreading_tpu.models.lipreader import init_model as jinit
from lipreading_tpu.parallel.mesh import make_mesh as jmake_mesh
from lipreading_tpu.parallel.mesh import model_param_shardings
from lipreading_tpu.parallel.mesh import shard_batch as jshard_batch
from lipreading_tpu_torch.config import MeshConfig, preset
from lipreading_tpu_torch.data.dataset import BatchIterator
from lipreading_tpu_torch.data.pipeline import VideoBatchIterator
from lipreading_tpu_torch.models.lipreader import LipReader
from lipreading_tpu_torch.parallel.mesh import (
    make_mesh,
    model_param_plan,
    shard_batch,
    shard_host_local_batch,
    shard_params_,
)
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_helpers import few_torch_threads  # noqa: F401
from tests.torch_dist_work import comm_cases, spawn, timeout_case

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

SMALL = {"model.patch_dim": 16, "model.frontend_dim": 24, "model.tf_dim": 32,
         "model.tf_heads": 4, "model.tf_mlp": 64, "model.tf_layers": 2,
         "model.tf_dec_layers": 2, "model.frontend_channels": (4, 8, 12),
         "model.gru_hidden": 16, "model.gru_layers": 1}


def _jmesh(dp, mp, world=8):
    return jmake_mesh(JMesh(data_parallel=dp, model_parallel=mp),
                      devices=jax.devices()[:world])


@pytest.mark.parametrize("world,dp,mp", [(8, -1, 1), (8, -1, 2), (8, 2, 2),
                                         (4, -1, 4), (8, 2, 3)])
def test_make_mesh_shape_matches_jax(world, dp, mp):
    got = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp),
                    world=world)
    assert (got.dp, got.mp) == tuple(_jmesh(dp, mp, world).devices.shape)


@pytest.mark.parametrize("dp,mp", [(4, 4), (3, 3), (9, 1), (2, 5)])
def test_make_mesh_refuses_with_jax_text(dp, mp):
    with pytest.raises(ValueError) as want:
        _jmesh(dp, mp)
    with pytest.raises(ValueError) as got:
        make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), world=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dp,mp", [(4, 2), (2, 4), (8, 1)])
def test_each_rank_sits_where_jax_puts_its_device(dp, mp):
    grid = np.vectorize(lambda d: d.id)(_jmesh(dp, mp).devices)
    for r in range(dp * mp):
        m = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp),
                      world=8, rank=r)
        assert grid[m.data_index, m.model_index] == r
        assert m.data.ranks == tuple(grid[:, m.model_index])
        assert m.model.ranks == tuple(grid[m.data_index])


def _batch(B=8):
    rng = np.random.default_rng(0)
    return {"rois": rng.normal(0, 1, (B, 4, 3)).astype(np.float32),
            "frame_lengths": np.arange(B, dtype=np.int32) + 1}


@pytest.mark.parametrize("dp,mp", [(2, 1), (4, 2), (8, 1)])
def test_shard_batch_rows_match_jax(dp, mp):
    batch = _batch()
    jm = _jmesh(dp, mp)
    sharded = jshard_batch({k: jnp.asarray(v) for k, v in batch.items()}, jm)
    by_device = {s.device.id: np.asarray(s.data)
                 for s in sharded["rois"].addressable_shards}
    for r in range(dp * mp):
        m = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp),
                      world=8, rank=r)
        got = shard_batch(batch, m)
        np.testing.assert_array_equal(got["rois"], by_device[r])
        assert len(got["frame_lengths"]) == 8 // dp


def test_shard_batch_splits_a_dataclass_batch_and_refuses_a_ragged_one():
    from lipreading_tpu_torch.data.dataset import Batch

    B = 6
    b = Batch(np.zeros((B, 2, 3, 3), np.uint8), np.arange(B, dtype=np.int32),
              np.zeros((B, 4), np.int32), np.full(B, 2, np.int32),
              np.zeros((B, 4), np.int32), np.ones(B, np.int32),
              [f"t{i}" for i in range(B)])
    m = make_mesh(MeshConfig(data_parallel=3), world=3, rank=2)
    got = shard_batch(b, m)
    assert got.texts == ["t4", "t5"]
    np.testing.assert_array_equal(got.frame_lengths, [4, 5])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(_batch(7), m)


def test_shard_host_local_batch_checks_the_row_count():
    m = make_mesh(MeshConfig(data_parallel=4), world=4, rank=1)
    local = _batch(2)
    assert shard_host_local_batch(local, m, 8) is local
    with pytest.raises(ValueError, match="holds 2 rows"):
        shard_host_local_batch(local, m, 16)


def _path(p) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)


def _axis(spec):
    """A leaf's PartitionSpec -> the axis it splits over ``model``."""
    return next((i for i, a in enumerate(spec) if a == "model"), None)


@pytest.mark.parametrize("name", ["transformer-patchify", "transformer-attn",
                                  "bigru-ctc"])
def test_tp_plan_is_model_param_shardings(name):
    jcfg = jpreset(name)
    for k, v in SMALL.items():
        section, field = k.split(".")
        setattr(getattr(jcfg, section), field, v)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    specs = jax.tree_util.tree_flatten_with_path(
        model_param_shardings(params, _jmesh(4, 2)))[0]
    want = {_path(p): _axis(s.spec) for p, s in specs}
    want = {k: a for k, a in want.items() if a is not None}
    model = LipReader(preset(name).override(**SMALL))
    got = model_param_plan(model)
    assert got == want
    assert set(got) <= set(model.state_dict())
    assert bool(got) == (name != "bigru-ctc")


def test_shard_params_cuts_this_ranks_columns_and_rows():
    cfg = preset("transformer-patchify").override(**SMALL)
    whole = LipReader(cfg)
    for p in whole.parameters():
        torch.nn.init.normal_(p)
    model = LipReader(cfg)
    model.load_state_dict(whole.state_dict())
    tp = shard_params_(model, make_mesh(MeshConfig(model_parallel=2),
                                        world=2, rank=1))
    sd, full = model.state_dict(), whole.state_dict()
    for name in ("encoder.layers.0.attn.q.w", "att_decoder.layers.1.cross.v.w",
                 "encoder.layers.1.mlp.in.w"):
        np.testing.assert_array_equal(sd[name], full[name].chunk(2, 1)[1])
    for name in ("encoder.layers.0.attn.o.w", "encoder.layers.0.mlp.out.w"):
        np.testing.assert_array_equal(sd[name], full[name].chunk(2, 0)[1])
    for name in ("encoder.layers.0.attn.k.b", "encoder.layers.0.mlp.in.b"):
        np.testing.assert_array_equal(sd[name], full[name].chunk(2, 0)[1])
    for name in ("encoder.layers.0.attn.o.b", "encoder.layers.0.ln1.scale",
                 "frontend.embed.w", "ctc_head.w"):
        assert name not in tp.plan
        np.testing.assert_array_equal(sd[name], full[name])
    assert model.encoder.layers[0].attn.model_axis.size == 2


def test_shard_params_refuses_heads_that_do_not_split():
    cfg = preset("transformer-patchify").override(**SMALL)
    with pytest.raises(ValueError, match="tf_heads"):
        shard_params_(LipReader(cfg), make_mesh(
            MeshConfig(model_parallel=3), world=3))


# --- the collectives, on 4 spawned ranks --------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(4, comm_cases, (), str(tmp_path_factory.mktemp("comm")))


def _base(r):
    return np.arange(3, dtype=np.float32) + 10 * r


def test_ranks_make_the_groups_of_their_row_and_column(ranks):
    for r, o in enumerate(ranks):
        assert o["coords"] == (r // 2, r % 2)
        assert o["data_ranks"] == (r % 2, 2 + r % 2)
        assert o["model_ranks"] == (r - r % 2, r - r % 2 + 1)


def test_ppermute_shifts_forward_and_back(ranks):
    for r, o in enumerate(ranks):
        src = r - r % 2 + (r % 2 + 1) % 2         # the other rank of the row
        np.testing.assert_array_equal(o["ppermute"], _base(src))
        # the gradient comes back from the rank it was sent to
        np.testing.assert_array_equal(o["ppermute_grad"], np.full(3, src + 1))


def test_psum_sums_and_passes_the_gradient_through(ranks):
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o["psum"],
                                      _base(r % 2) + _base(2 + r % 2))
        np.testing.assert_array_equal(o["psum_grad"], np.full(3, r + 1))


def test_copy_is_identity_and_sums_the_gradient(ranks):
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o["copy"], _base(r))
        row = r - r % 2
        np.testing.assert_array_equal(o["copy_grad"],
                                      np.full(3, row + 1 + row + 2))


def test_all_gather_concatenates_and_returns_this_ranks_slice(ranks):
    want = np.stack([_base(r) for r in range(4)])
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o["all_gather"], want)
        np.testing.assert_array_equal(o["all_gather_grad"], np.full((1, 3), r))


def test_low_precision_and_bool_tensors_cross_the_wire(ranks):
    bf = [torch.from_numpy(_base(r) / 7).to(torch.bfloat16) for r in range(4)]
    total = sum(b.float() for b in bf).to(torch.bfloat16).float().numpy()
    for r, o in enumerate(ranks):
        src = r - r % 2 + (r % 2 + 1) % 2
        np.testing.assert_array_equal(o["ppermute_bf16"], bf[src].float())
        np.testing.assert_array_equal(o["psum_bf16"], total)
        np.testing.assert_array_equal(o["ppermute_bool"],
                                      [(r - 1) % 4 % 2 == 0, True])
        np.testing.assert_array_equal(
            o["all_gather_bf16"][0], np.concatenate([b.float() for b in bf]))
        np.testing.assert_array_equal(o["all_gather_bf16_grad"],
                                      np.full(3, 2.0))


def test_replicate_takes_rank_zeros_parameters(ranks):
    for o in ranks:
        np.testing.assert_array_equal(o["replicated"], np.ones(8))


def test_a_wait_past_its_timeout_raises(tmp_path):
    assert spawn(2, timeout_case, (), str(tmp_path)) == [
        "raised RuntimeError", "idle"]


# --- each data rank's rows from the batch iterators ---------------------------

class _Buckets:
    """What ``BatchIterator`` reads of a dataset; a batch is its indices."""

    buckets = (32, 64)

    def __init__(self, n):
        self.sample_bucket = np.asarray([32 if i % 3 else 64
                                         for i in range(n)])

    def __len__(self):
        return len(self.sample_bucket)

    def make_batch(self, idx):
        return list(idx)


class _Clips:
    """What ``VideoBatchIterator`` reads of a dataset."""

    def __init__(self, n):
        self.cfg = dataclasses.replace(preset("bigru-ctc").data,
                                       time_buckets=(32, 64))
        self.samples = [(np.zeros((20 + 7 * i % 40, 1)), "") for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def batch(self, idx, bucket):
        return (bucket, list(idx))


@pytest.mark.parametrize("kind", ["dataview", "fused"])
def test_iterators_give_each_rank_its_rows_in_order_and_on_resume(kind):
    cls, ds = ((BatchIterator, _Buckets(40)) if kind == "dataview"
               else (VideoBatchIterator, _Clips(40)))
    rows = (lambda b: b) if kind == "dataview" else (lambda b: b[1])
    whole = cls(ds, 8, seed=3)
    parts = [cls(ds, 8, seed=3, shard=(i, 4)) for i in range(4)]
    for step in range(12):           # past an epoch's end
        want = rows(next(whole))
        got = [rows(next(p)) for p in parts]
        assert sum(got, []) == want, step
        if step == 4:
            state = parts[2].state
    resumed = cls.from_state(ds, 8, state, shard=(2, 4))
    replay = cls(ds, 8, seed=3, shard=(2, 4))
    for _ in range(5):
        next(replay)
    for _ in range(8):
        assert rows(next(resumed)) == rows(next(replay))
    with pytest.raises(ValueError, match="does not split"):
        cls(ds, 8, shard=(0, 3))
