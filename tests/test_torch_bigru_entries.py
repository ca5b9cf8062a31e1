"""The entry points with the bi-GRU family on the CPU at a small width:
``python -m lipreading_tpu_torch.train preset=bigru-ctc`` on both training
paths with a held-out evaluation, ``evaluate`` of the ``bigru_ctc``
release against the line ``scripts/evaluate.py`` prints for the same
parameters, and ``export_model`` of a run against flax's serialisation of
the same parameters and the sidecar the JAX script writes.

Tolerances: none; the evaluation's printed line, the exported bytes and the
parsed sidecar are equal."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
from flax import serialization

from lipreading_tpu.config import load_workdir_config as j_workdir_config
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.train.checkpoint import latest_checkpoint
from lipreading_tpu.train.checkpoint import load_checkpoint as j_load_ckpt
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

REPO = os.path.join(os.path.dirname(__file__), "..")
SMALL_ARGS = ["preset=bigru-ctc", "device=cpu", "n_clips=1",
              "model.frontend_channels=4,8,12", "model.frontend_dim=16",
              "model.gru_hidden=16", "model.gru_layers=1",
              "model.highway_layers=1", "data.batch_size=2",
              "data.time_buckets=32", "train.log_every=1",
              "train.warmup_steps=1", "train.max_decode_len=8",
              "train.beam_width=2", "steps=2", "train.eval_every=2"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fused_run(tmp_path_factory):
    from lipreading_tpu_torch.train.__main__ import main

    wd = tmp_path_factory.mktemp("bigru") / "run"
    last = main(SMALL_ARGS + [f"workdir={wd}"])
    return str(wd), last


def test_train_bigru_ctc_fused_with_eval(fused_run):
    wd, last = fused_run
    assert np.isfinite(last["loss"]) and "eval_cer" in last
    with open(os.path.join(wd, "config.json")) as f:
        saved = json.load(f)
    assert (saved["encoder"], saved["decoder"]) == ("bigru", "ctc")
    assert saved["model"]["frontend"] == "conv3d"
    assert saved["model"]["gru_hidden"] == 16


def test_train_bigru_ctc_dataview_with_eval(tmp_path):
    from lipreading_tpu_torch.train.__main__ import main

    wd = tmp_path / "run"
    last = main(SMALL_ARGS + ["fused=0", f"workdir={wd}"])
    assert np.isfinite(last["loss"]) and "eval_cer" in last
    for view in ("dataview", "dataview_heldout"):
        assert (wd / view / "index.json").exists()


def test_export_model_matches_flax_and_the_jax_sidecar(fused_run, tmp_path):
    """The exported ``.msgpack`` is byte for byte flax's serialisation of the
    JAX package's restore of the same checkpoint, and the ``.json`` parses
    to what ``scripts/export_model.py`` writes (its code, not the script,
    which writes into ``assets/``)."""
    from lipreading_tpu_torch.export_model import export, main

    wd, _ = fused_run
    out = export(wd, "tiny", out_dir=str(tmp_path / "out"))
    jcfg = j_workdir_config(wd)
    template = jlr.init_model(jax.random.PRNGKey(0), jcfg)
    step, params, _, _, _ = j_load_ckpt(
        latest_checkpoint(os.path.join(wd, "ckpt")), template)
    blob = serialization.msgpack_serialize(
        serialization.to_state_dict(jax.tree.map(np.asarray, params)))
    with open(out, "rb") as f:
        assert f.read() == blob
    want = json.loads(json.dumps({"config": jcfg.to_dict(), "step": step},
                                 indent=1, default=str))
    with open(tmp_path / "out" / "tiny.json") as f:
        assert json.load(f) == want
    # the port reads its own export back as a release
    from lipreading_tpu_torch.io import load_release_model

    model, cfg = load_release_model("tiny", device="cpu",
                                    assets_dir=str(tmp_path / "out"))
    assert (cfg.encoder, cfg.decoder) == ("bigru", "ctc")
    with pytest.raises(SystemExit, match="workdir="):
        main([])


def test_evaluate_bigru_release_prints_the_jax_line(capsys):
    """``evaluate preset=bigru-ctc release=bigru_ctc decode=ctc`` on 2 clips
    (no checkpoint in the workdir: the release) prints the corpus line of
    ``scripts/evaluate.py`` with the same parameters."""
    from lipreading_tpu_torch.evaluate import main

    argv = ["preset=bigru-ctc", "release=bigru_ctc", "decode=ctc",
            "n_clips=2", "beam=1", "workdir=/nonexistent"]
    got = main(argv + ["device=cpu"])
    mine = capsys.readouterr().out.splitlines()
    _jax_script("evaluate").main(argv)
    theirs = capsys.readouterr().out.splitlines()
    assert "assets/bigru_ctc.msgpack" in mine[0]
    assert mine[-1] == theirs[-1] and mine[-1].startswith("corpus CER=")
    # the per-clip lines too (hypotheses and references)
    assert [l for l in mine if l.startswith("  clip")] == \
        [l for l in theirs if l.startswith("  clip")]
    assert len(got["hyps"]) == 2
