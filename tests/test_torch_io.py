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
    every key present, every shape equal, values carried bit for bit, the
    attention decoder's included."""
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
    np.testing.assert_array_equal(
        sd["att_decoder.layers.0.self.q.w"].numpy(),
        tree["att_decoder"]["layers"][0]["self"]["q"]["w"])


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
    r"^\s*(import|from)\s+(jax|flax|msgpack|optax|lipreading_tpu)(\.|\s|$)",
    re.M)


def _port_sources():
    root = os.path.join(REPO, "lipreading_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_nothing_of_jax():
    """The port and its smoke script import no jax, flax, msgpack, optax or
    JAX package module, and no kernel source includes PyTorch's headers."""
    srcs = list(_port_sources())
    assert len(srcs) > 10
    names = {os.path.relpath(p, REPO) for p in srcs}
    assert {"lipreading_tpu_torch/ops/flash_attention.py",
            "lipreading_tpu_torch/csrc/flash_attention.cu",
            "lipreading_tpu_torch/lm.py", "lipreading_tpu_torch/lexicon.py",
            "lipreading_tpu_torch/ops/ctc_beam.py",
            "lipreading_tpu_torch/ops/joint_decode.py",
            "lipreading_tpu_torch/ops/tracking.py",
            "lipreading_tpu_torch/ops/landmarker.py",
            "lipreading_tpu_torch/data/video.py",
            "lipreading_tpu_torch/serve.py",
            "lipreading_tpu_torch/data/dataview.py",
            "lipreading_tpu_torch/data/dataset.py",
            "lipreading_tpu_torch/evaluate.py",
            "lipreading_tpu_torch/generate_dataview.py",
            "lipreading_tpu_torch/train/__main__.py",
            "lipreading_tpu_torch/models/gru.py",
            "lipreading_tpu_torch/models/attention.py",
            "lipreading_tpu_torch/models/frontend3d.py",
            "lipreading_tpu_torch/export_model.py",
            "lipreading_tpu_torch/streaming.py",
            "lipreading_tpu_torch/demo.py",
            "lipreading_tpu_torch/stream_latency.py",
            "lipreading_tpu_torch/stream_eval.py",
            "lipreading_tpu_torch/preproc_training.py",
            "lipreading_tpu_torch/oracle/ert_train.py",
            "lipreading_tpu_torch/oracle/roi.py",
            "lipreading_tpu_torch/train_preprocessor.py",
            "lipreading_tpu_torch/train_presence.py",
            "lipreading_tpu_torch/train_landmarker.py",
            "lipreading_tpu_torch/parallel/__init__.py",
            "lipreading_tpu_torch/parallel/comm.py",
            "lipreading_tpu_torch/parallel/mesh.py",
            "lipreading_tpu_torch/parallel/ring.py",
            "lipreading_tpu_torch/parallel/pipeline.py",
            "lipreading_tpu_torch/train/importer.py",
            "lipreading_tpu_torch/oracle/pipeline.py",
            "lipreading_tpu_torch/oracle/detector.py",
            "lipreading_tpu_torch/make_golden.py",
            "lipreading_tpu_torch/native.py",
            "lipreading_tpu_torch/csrc/lipreading_host.cpp",
            "lipreading_tpu_torch/profiling.py",
            "lipreading_tpu_torch/data/pipeline.py",
            "lipreading_tpu_torch/microbench.py",
            "lipreading_tpu_torch/bench_flash.py",
            "lipreading_tpu_torch/roofline_preprocess.py",
            "lipreading_tpu_torch/profile_train.py",
            "lipreading_tpu_torch/bench_stem.py",
            "lipreading_tpu_torch/profile_decode.py",
            "lipreading_tpu_torch/bench_decode_knee.py",
            "lipreading_tpu_torch/bench_ingest.py"} <= names
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert not _FORBIDDEN.search(text), path
        assert "torch/extension.h" not in text, path
        assert "cpp_extension" not in text, path


def _writer_tree():
    return {
        "small": 5, "neg": -3, "neg8": -100, "u16": 60000, "i32": -70000,
        "u64": 2**40, "i64": -2**40, "f": 1.5, "none": None, "t": True,
        "fa": False, "s": "x" * 40, "s300": "y" * 300, "b": b"abc",
        "nested": {"0": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "1": np.float32(2.5), "2": np.array(3, np.int32)},
        "bf16": np.asarray(jax.numpy.arange(4, dtype=jax.numpy.bfloat16)),
        "big": np.ones((70, 70), np.float32), "list": [1, 2, {"a": 3}],
        "wide": {str(i): i for i in range(20)}, "empty": {},
    }


def test_msgpack_writer_matches_flax():
    """Byte for byte what flax writes, for every type a checkpoint holds
    (flax sorts dict keys: "10" before "2"), and read back by both."""
    tree = _writer_tree()
    data = tio.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = serialization.msgpack_restore(data)
    assert back["wide"]["11"] == 11 and back["nested"]["1"] == np.float32(2.5)
    with pytest.raises(TypeError):
        tio.msgpack_serialize({"t": (1, 2)})


def test_msgpack_writer_rewrites_a_release_byte_for_byte():
    path = os.path.join(tio.ASSETS_DIR, "transformer_hybrid_universal4.msgpack")
    with open(path, "rb") as f:
        data = f.read()
    assert tio.msgpack_serialize(tio.msgpack_restore(data)) == data


def test_to_jax_params_inverts_from_jax_params():
    tree, cfg = tio.load_release("transformer_hybrid_universal4")
    back = tio.to_jax_params(tio.from_jax_params(tree, cfg))
    want, got = dict(_leaves(tree)), dict(_leaves(back))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].tobytes() == w.tobytes(), k


def _ckpt_models(tmp_path):
    """A small port trainer and the JAX tree and optax state of the same
    configuration."""
    from lipreading_tpu.config import Config as JConfig
    from lipreading_tpu.config import ModelConfig as JModel
    from lipreading_tpu.train.loop import make_optimizer
    from lipreading_tpu_torch.train.loop import Trainer

    cfg = _small_cfg()
    jcfg = JConfig(encoder="transformer", decoder="hybrid",
                   model=JModel(**cfg.model.__dict__))
    params = init_model(jax.random.PRNGKey(1), jcfg)
    tx = make_optimizer(jcfg)
    tr = Trainer(cfg, str(tmp_path / "port"), device="cpu")
    return tr, params, tx


def _state_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def test_jax_reads_a_port_checkpoint(tmp_path):
    """A port checkpoint after 2 optimizer updates, read by the JAX
    package's load_checkpoint against its own templates: params and
    opt_state equal leaf for leaf, the step and sidecar kept."""
    from lipreading_tpu.train.checkpoint import load_checkpoint

    tr, params, tx = _ckpt_models(tmp_path)
    for _ in range(2):
        for p in tr.model.parameters():
            p.grad = torch.full_like(p, 0.01)
        tr.opt.update()
    tr.step = 2
    path = tr.save()
    step, jp, jo, it_state, extra = load_checkpoint(path, params,
                                                    tx.init(params))
    assert step == 2 and extra == {"config": "default"} and it_state == {}
    want = _state_leaves(jax.tree_util.tree_map(
        np.asarray, tio.to_jax_params(tr.model.state_dict())))
    got = _state_leaves(serialization.to_state_dict(jp))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].tobytes() == w.tobytes(), k
    jo_sd = serialization.to_state_dict(jo)
    assert int(jo_sd["1"]["0"]["count"]) == 2
    assert int(jo_sd["1"]["2"]["count"]) == 2
    mu = _state_leaves(jo_sd["1"]["0"]["mu"])
    for k, t in tr.opt.mu.items():
        key = "".join(f"['{p}']" for p in k.split("."))
        assert mu[key].tobytes() == t.numpy().tobytes(), k


def test_port_reads_a_jax_checkpoint(tmp_path):
    """A JAX checkpoint (params and a stepped optax state) restored by the
    port's Trainer: params and moments equal, count and step kept."""
    import jax.numpy as jnp
    import optax

    from lipreading_tpu.train.checkpoint import save_checkpoint

    tr, params, tx = _ckpt_models(tmp_path)
    state = tx.init(params)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.02), params)
    for _ in range(3):
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    save_checkpoint(tr.ckpt_dir, 3, params, state,
                    iterator_state={"epoch": 1, "pos": 2, "seed": 0})
    assert tr.restore() == {"epoch": 1, "pos": 2, "seed": 0}
    assert tr.step == 3 and tr.opt.count == 3
    want = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(params))))
    got = dict(_leaves(tio.to_jax_params(tr.model.state_dict())))
    for k, w in want.items():
        assert got[k].tobytes() == w.tobytes(), k
    nu = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(state[1][0].nu))))
    got_nu = dict(_leaves(tio.to_jax_params(tr.opt.nu)))
    for k, w in nu.items():
        assert got_nu[k].tobytes() == w.tobytes(), k
