"""The port's reference-checkpoint importer (``lipreading_tpu_torch/train/
importer.py``) against the JAX package's (``lipreading_tpu/train/
importer.py``), on the cases of ``tests/test_importer.py``: each module
importer's leaves equal to JAX's and the port's ops on them equal to the
``torch.nn`` module within that test's tolerance; ``import_model`` on the
reference-shaped model of ``tests/torch_ref.py`` leaf-equal to JAX's tree;
export after import and import after export bit-exact; the refusals and
their texts; a ``.pt`` file round trip."""

import jax
import numpy as np
import pytest
import torch

from lipreading_tpu.train import importer as jimp
from lipreading_tpu_torch.config import from_dict
from lipreading_tpu_torch.io import from_jax_params
from lipreading_tpu_torch.models import nn as pnn
from lipreading_tpu_torch.models.gru import BiGRU
from lipreading_tpu_torch.train import importer as pimp
from tests import torch_ref
from tests.test_parity_gate import _gate_cfg
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")


def _assert_trees_equal(a, b, path="root"):
    """The same structure (dicts, lists) and bit-equal float32 leaves."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}.{i}")
    else:
        assert a.dtype == np.float32 and b.dtype == np.float32, path
        assert a.shape == b.shape and np.array_equal(a, b), path


def _t(p: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}


def test_linear_roundtrip():
    torch.manual_seed(0)
    m = torch.nn.Linear(6, 4)
    x = torch.randn(3, 6)
    p = pimp.import_linear(m.state_dict())
    _assert_trees_equal(p, jimp.import_linear(m.state_dict()))
    got = pnn.dense(x, **_t(p))
    torch.testing.assert_close(got, m(x).detach(), rtol=1e-5, atol=1e-6)


def test_linear_prefixed():
    torch.manual_seed(1)
    model = torch.nn.Sequential(torch.nn.Linear(5, 7))
    sd = model.state_dict()
    p = pimp.import_linear(sd, "0")
    _assert_trees_equal(p, jimp.import_linear(sd, "0"))
    x = torch.randn(2, 5)
    torch.testing.assert_close(pnn.dense(x, **_t(p)), model(x).detach(),
                               rtol=1e-5, atol=1e-6)


def test_conv3d_roundtrip():
    torch.manual_seed(2)
    m = torch.nn.Conv3d(2, 5, kernel_size=(3, 3, 3), padding=(1, 1, 1))
    x = torch.randn(1, 2, 4, 8, 8)                    # NCDHW
    sd = {f"c.{k}": v for k, v in m.state_dict().items()}
    p = pimp.import_conv3d(sd, "c")
    _assert_trees_equal(p, jimp.import_conv3d(sd, "c"))
    got = pnn.conv3d(x.permute(0, 2, 3, 4, 1), **_t(p))   # NDHWC
    torch.testing.assert_close(got.permute(0, 4, 1, 2, 3), m(x).detach(),
                               rtol=1e-4, atol=1e-5)


def test_bigru_roundtrip():
    torch.manual_seed(3)
    B, T, D, H = 2, 7, 5, 6
    m = torch.nn.GRU(D, H, num_layers=2, batch_first=True, bidirectional=True)
    sd = {f"g.{k}": v for k, v in m.state_dict().items()}
    p = pimp.import_bigru(sd, "g", layers=2)
    _assert_trees_equal(p, jimp.import_bigru(sd, "g", layers=2))
    enc = BiGRU(D, H, 2)
    enc.load_state_dict(from_jax_params(p), strict=True)
    x = torch.randn(B, T, D)
    want, _ = m(x)
    with torch.no_grad():
        got = enc(x, torch.tensor([T, T]))
    torch.testing.assert_close(got, want.detach(), rtol=1e-4, atol=1e-5)


def test_grucell_and_groupnorm_equal_jax():
    torch.manual_seed(7)
    cell = torch.nn.GRUCell(5, 6)
    gn = torch.nn.GroupNorm(2, 4)
    sd = {**{f"c.{k}": v for k, v in cell.state_dict().items()},
          **{f"n.{k}": v for k, v in gn.state_dict().items()}}
    _assert_trees_equal(pimp.import_grucell(sd, "c"),
                        jimp.import_grucell(sd, "c"))
    _assert_trees_equal(pimp.import_groupnorm(sd, "n"),
                        jimp.import_groupnorm(sd, "n"))


def test_embedding_roundtrip():
    torch.manual_seed(4)
    m = torch.nn.Embedding(11, 8)
    sd = {f"e.{k}": v for k, v in m.state_dict().items()}
    p = pimp.import_embedding(sd, "e")
    _assert_trees_equal(p, jimp.import_embedding(sd, "e"))
    ids = torch.tensor([[1, 5, 10], [0, 2, 3]])
    torch.testing.assert_close(pnn.embedding(ids, **_t(p)), m(ids).detach(),
                               rtol=1e-6, atol=1e-6)


def test_frozen_batchnorm_fold():
    torch.manual_seed(5)
    m = torch.nn.BatchNorm3d(4)
    m.eval()
    with torch.no_grad():
        m.running_mean += torch.randn(4) * 0.3
        m.running_var *= torch.rand(4) + 0.5
        m.weight *= 1.3
        m.bias += 0.2
    x = torch.randn(2, 4, 3, 5, 5)
    want = m(x).detach()
    sd = {f"bn.{k}": v for k, v in m.state_dict().items()}
    p = pimp.import_batchnorm_as_scale_bias(sd, "bn")
    _assert_trees_equal(p, jimp.import_batchnorm_as_scale_bias(sd, "bn"))
    xl = x.permute(0, 2, 3, 4, 1)                          # channel-last
    got = pimp.apply_frozen_bn(p, xl).permute(0, 4, 1, 2, 3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        pimp.apply_frozen_bn(p, xl.numpy()),
        np.asarray(jimp.apply_frozen_bn(p, xl.numpy())))


def test_torch_ckpt_file_roundtrip(tmp_path):
    torch.manual_seed(6)
    model = torch.nn.Sequential(torch.nn.Linear(4, 9), torch.nn.ReLU(),
                                torch.nn.Linear(9, 3))
    path = str(tmp_path / "ckpt.pt")
    torch.save(model.state_dict(), path)
    wrapped = str(tmp_path / "wrapped.pt")
    torch.save({"state_dict": model.state_dict(), "epoch": 3}, wrapped)
    sd = pimp.load_torch_state_dict(path)
    for k, v in pimp.load_torch_state_dict(wrapped).items():
        assert torch.equal(v, sd[k]), k
    p0, p2 = pimp.import_linear(sd, "0"), pimp.import_linear(sd, "2")
    jsd = jimp.load_torch_state_dict(path)
    _assert_trees_equal(p0, jimp.import_linear(jsd, "0"))
    _assert_trees_equal(p2, jimp.import_linear(jsd, "2"))
    x = torch.randn(5, 4)
    got = pnn.dense(torch.relu(pnn.dense(x, **_t(p0))), **_t(p2))
    torch.testing.assert_close(got, model(x).detach(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("decoder", ["ctc", "attention", "hybrid"])
def test_import_model_tree_equals_jax(decoder):
    """The reference-shaped model's state_dict -> the same tree, leaf for
    leaf, as the JAX importer's; the port's model built from it carries
    exactly those leaves."""
    jcfg = _gate_cfg(decoder)
    torch.manual_seed(11)
    ref = torch_ref.TorchLipReader(jcfg).eval()
    sd = ref.state_dict()
    cfg = from_dict(jcfg.to_dict())
    tree = pimp.import_model(sd, cfg)
    _assert_trees_equal(tree, jimp.import_model(sd, jcfg))
    port = pimp.lipreader_from_state_dict(sd, cfg, device="cpu")
    assert not port.training
    want = from_jax_params(tree)
    got = port.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_state_dict_roundtrip_bitexact():
    """import_model(export(params)) reproduces every leaf bit for bit and
    export(import_model(sd)) the state_dict, from the JAX package's init
    tree; the export equals the JAX exporter's."""
    from lipreading_tpu.models.lipreader import init_model as j_init

    jcfg = _gate_cfg("hybrid")
    cfg = from_dict(jcfg.to_dict())
    params = jax.tree_util.tree_map(np.asarray,
                                    j_init(jax.random.PRNGKey(9), jcfg))
    sd = pimp.export_model_state_dict(params, cfg)
    jsd = jimp.export_model_state_dict(params, jcfg)
    assert set(sd) == set(jsd)
    for k in sd:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], jsd[k]), k
    back = pimp.import_model(sd, cfg)
    _assert_trees_equal(back, params)
    sd2 = pimp.export_model_state_dict(back, cfg)
    assert set(sd2) == set(sd)
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k


def test_refusals_keep_the_jax_texts():
    """A non-conv3d frontend and a key the import does not consume raise
    the JAX importer's errors; ``num_batches_tracked`` is ignored."""
    jcfg = _gate_cfg("ctc")
    cfg = from_dict(jcfg.to_dict())
    torch.manual_seed(12)
    sd = dict(torch_ref.TorchLipReader(jcfg).state_dict())
    sd["frontend.gn0.num_batches_tracked"] = torch.tensor(5)
    pimp.import_model(sd, cfg)                    # ignored, as in JAX
    sd["stray.weight"] = torch.zeros(3)
    for mod, c in ((pimp, cfg), (jimp, jcfg)):
        with pytest.raises(ValueError) as e:
            mod.import_model(sd, c)
        assert str(e.value) == ("state_dict keys not consumed by "
                                "import_model: ['stray.weight']")
    del sd["stray.weight"]
    cfg.model.frontend = jcfg.model.frontend = "patchify"
    for name, arg in (("import_model", sd), ("export_model_state_dict", {})):
        with pytest.raises(ValueError, match="frontend='patchify' has no "
                           "torch counterpart") as got:
            getattr(pimp, name)(arg, cfg)
        with pytest.raises(ValueError) as want:
            getattr(jimp, name)(arg, jcfg)
        assert got.value.args == want.value.args, name
