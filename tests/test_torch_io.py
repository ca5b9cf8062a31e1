"""The port's weight loading (``lipreading_tpu_torch.io``) against flax and
the JAX package, and the port's independence from both.

The port reads flax's msgpack releases with its own pure-Python decoder; it
must give the same tree, leaf for leaf, as ``flax.serialization`` does."""

import os
import re

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from lipreading_tpu.config import from_dict as jax_from_dict
from lipreading_tpu.models.lipreader import init_model
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.config import Config, ModelConfig
from lipreading_tpu_torch.models.lipreader import LipReader

REPO = os.path.join(os.path.dirname(__file__), "..")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("release", ["transformer_hybrid_universal4",
                                     "bigru_ctc"])
def test_release_reader_matches_flax(release):
    with open(os.path.join(tio.ASSETS_DIR, f"{release}.msgpack"), "rb") as f:
        data = f.read()
    want = dict(_leaves(serialization.msgpack_restore(data)))
    got = dict(_leaves(tio.msgpack_restore(data)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, np.ndarray), k
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert g.tobytes() == w.tobytes(), k


def test_msgpack_reader_all_types():
    """Every msgpack type flax writes, incl. wide ints, scalars and bf16."""
    tree = {
        "small": 5, "neg": -3, "neg8": -100, "u16": 60000, "i32": -70000,
        "u64": 2**40, "f": 1.5, "none": None, "t": True, "fa": False,
        "s": "x" * 40, "nested": {"0": np.arange(6, dtype=np.int32).reshape(2, 3),
                                  "1": np.float32(2.5)},
        "bf16": jax.numpy.arange(4, dtype=jax.numpy.bfloat16),
        "big": np.ones((70, 70), np.float32),
    }
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)
    got = tio.msgpack_restore(data)
    for (kw, w), (kg, g) in zip(_leaves(want), _leaves(got)):
        assert kw == kg
        if isinstance(w, (np.ndarray, np.generic)) or hasattr(w, "dtype"):
            w = np.asarray(w)
            assert np.asarray(g).dtype.name == w.dtype.name, kw
            assert np.asarray(g).tobytes() == w.tobytes(), kw
        else:
            assert g == w and type(g) is type(w), kw


def test_msgpack_reader_rejects_trailing_bytes():
    data = serialization.msgpack_serialize({"a": 1})
    with pytest.raises(ValueError, match="trailing"):
        tio.msgpack_restore(data + b"\x00")


def test_release_config_matches_jax():
    import json

    _, cfg = tio.load_release("transformer_hybrid_universal4")
    with open(os.path.join(tio.ASSETS_DIR,
                           "transformer_hybrid_universal4.json")) as f:
        jcfg = jax_from_dict(json.load(f)["config"])
    for part in ("data", "preprocess", "model"):
        a, b = getattr(cfg, part), getattr(jcfg, part)
        for name in a.__dataclass_fields__:
            assert getattr(a, name) == getattr(b, name), (part, name)
    assert (cfg.encoder, cfg.decoder) == (jcfg.encoder, jcfg.decoder)


def _small_cfg(framewise: bool = True) -> Config:
    return Config(encoder="transformer", decoder="hybrid", model=ModelConfig(
        frontend="patchify", patch_dim=16, frontend_dim=24, tf_dim=32,
        tf_heads=2, tf_mlp=64, tf_layers=2, tf_dec_layers=1,
        highway_layers=1, framewise_norm=framewise, dtype="float32"))


def test_from_jax_params_fills_every_weight():
    """``init_model``'s tree (lists, not dicts) -> the port's state_dict:
    every key present, every shape equal, values carried bit for bit; the
    attention decoder (a later slice) is left out."""
    from lipreading_tpu.config import Config as JConfig
    from lipreading_tpu.config import ModelConfig as JModel

    cfg = _small_cfg()
    jcfg = JConfig(encoder="transformer", decoder="hybrid",
                   model=JModel(**cfg.model.__dict__))
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(3), jcfg))
    sd = tio.from_jax_params(tree, cfg)
    want = LipReader(cfg).state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    np.testing.assert_array_equal(sd["encoder.layers.1.mlp.in.w"].numpy(),
                                  tree["encoder"]["layers"][1]["mlp"]["in"]["w"])
    assert not any(k.startswith("att_decoder") for k in sd)


def test_load_release_model_on_cpu():
    model, cfg = tio.load_release_model(device="cpu")
    assert cfg.model.tf_dim == 256 and cfg.model.framewise_norm
    p = next(model.parameters())
    assert p.device.type == "cpu" and p.dtype == torch.float32


def test_load_assets_shapes():
    det, ert = tio.load_assets()
    assert det["conv1/w"].shape == (3, 3, 1, 8)
    assert ert.leaves.shape[-1] == 136 and ert.mean_shape.shape == (68, 2)


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|msgpack|lipreading_tpu)(\.|\s|$)", re.M)


def _port_sources():
    root = os.path.join(REPO, "lipreading_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_nothing_of_jax():
    """The port and its smoke script import no jax, flax, msgpack or JAX
    package module, and no kernel source includes PyTorch's headers."""
    srcs = list(_port_sources())
    assert len(srcs) > 10
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert not _FORBIDDEN.search(text), path
        assert "torch/extension.h" not in text, path
        assert "cpp_extension" not in text, path
