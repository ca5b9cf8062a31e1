"""The port's evaluation entry (``python -m lipreading_tpu_torch.evaluate``)
on the CPU against the JAX package's ``scripts/evaluate.py``, and the
held-out evaluation of a fine-tuning run from the universal4 release
against the JAX package's.

Tolerances: transcripts string-identical, so the printed CER, WER and
rescored counts equal.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lipreading_tpu.config import load_workdir_config as j_workdir_config
from lipreading_tpu.data.pipeline import FixtureVideoDataset as JVideoDataset
from lipreading_tpu.infer import transcribe as jtranscribe
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.ops.detector import params_to_jax
from lipreading_tpu.ops.ert import model_to_jax
from lipreading_tpu.ops.preprocess import preprocess_clips as j_preprocess
from lipreading_tpu.preproc_training import load_assets
from lipreading_tpu.preproc_training import load_release_model as j_release
from lipreading_tpu.train.checkpoint import load_checkpoint as j_load_ckpt
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.data import dataset as tds
from lipreading_tpu_torch.data import dataview as tdv
from lipreading_tpu_torch.data.pipeline import FixtureVideoDataset
from lipreading_tpu_torch.train.loop import FusedTrainer, Trainer
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)
from tests.test_torch_train_dataview import _cfgs

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

REPO = os.path.join(os.path.dirname(__file__), "..")
RELEASE = "transformer_hybrid_universal4"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A trainer's workdir: 20 steps on a dataview of 5 fixture clips (the
    fewest whose clip-level split has a "val" part), its config and its
    checkpoint."""
    root = tmp_path_factory.mktemp("eval")
    view = tdv.build_fixture_dataview(str(root / "view"), 5, seed=8,
                                      use_ground_truth_landmarks=True,
                                      device="cpu")
    cfg, _ = _cfgs(learning_rate=3e-3)
    tr = Trainer(cfg, str(root / "run"), device="cpu")
    tr.logger.echo = False
    it = tds.BatchIterator(tds.BucketedDataset(view, cfg.data), 2, seed=0)
    for _ in range(20):
        tr.train_step(next(it))
    tr.save(it)
    return str(root / "run"), view.path


@pytest.mark.parametrize("decode", ["cascade", "ctc"])
def test_evaluate_dataview_entry_matches_jax(workdir, decode, capsys):
    """``evaluate workdir=... dataview=... split=val decode=...``: the line
    the JAX package's ``evaluate_dataview`` prints for the same checkpoint
    (CER, WER and, for the cascade, the rescored rows)."""
    from lipreading_tpu_torch.evaluate import main

    wd, view = workdir
    argv = [f"workdir={wd}", f"dataview={view}", "split=val",
            f"decode={decode}", "device=cpu"]
    got = main(argv)
    mine = capsys.readouterr().out.splitlines()[-1]
    jcfg = j_workdir_config(wd)
    template = jlr.init_model(jax.random.PRNGKey(0), jcfg)
    from lipreading_tpu.train.checkpoint import latest_checkpoint

    _, params, _, _, _ = j_load_ckpt(
        latest_checkpoint(os.path.join(wd, "ckpt")), template)
    if decode == "ctc":
        jcfg = dataclasses.replace(jcfg, decoder="ctc")
    _jax_script("evaluate").evaluate_dataview(
        params, jcfg, view, "val", jcfg.train.beam_width, decode=decode)
    theirs = capsys.readouterr().out.splitlines()[-1]
    assert mine == theirs and mine.startswith("val split: ")
    assert got["cer"] >= 0 and len(got["hyps"]) == len(got["refs"]) > 0
    assert (got["rescored"] is None) == (decode == "ctc")


def test_evaluate_fixture_path_on_the_release(capsys):
    """The fixture path from the release on the CPU: the cascade and the
    CTC head at beam 1 (the greedy kernel's path on the card)."""
    from lipreading_tpu_torch.evaluate import main

    base = ["n_clips=2", "device=cpu", "workdir=/nonexistent"]
    casc = main(base + ["decode=cascade", "beam=8"])
    ctc = main(base + ["decode=ctc", "beam=1"])
    out = capsys.readouterr().out
    assert f"assets/{RELEASE}.msgpack" in out and "cascade: " in out
    for r in (casc, ctc):
        assert len(r["hyps"]) == 2 and r["refs"] == casc["refs"]
        assert 0 <= r["cer"] <= 1
    # the release reads the fixtures: greedy CTC within a few edits
    assert ctc["cer"] < 0.2 and casc["cer"] < 0.2
    with pytest.raises(SystemExit, match="decode="):
        main(base + ["decode=beam"])


def test_release_fused_evaluate_matches_jax(tmp_path):
    """``FusedTrainer.evaluate`` warm-started from the universal4 release
    on 2 held-out samples (the training entry's held-out clips, the largest
    bucket), beam 8: the JAX package's transcripts from the same
    parameters (its ``FusedTrainer.evaluate``: ``preprocess_clips``, then
    ``transcribe``)."""
    from lipreading_tpu.metrics import corpus_cer, corpus_wer

    tree, cfg = tio.load_release(RELEASE)
    det, lmk, _ = tio.load_preprocessors(device="cpu")
    tr = FusedTrainer(cfg, str(tmp_path), det, lmk, device="cpu")
    tr.logger.echo = False
    tr.warm_start(tree)
    seed, bucket = 1 + 999_983, max(cfg.data.time_buckets)
    batch = FixtureVideoDataset(4, seed=seed, cfg=cfg.data).batch([0, 1],
                                                                  bucket)
    m = tr.evaluate([batch], beam=8)

    jparams, jcfg = j_release(RELEASE)
    jb = JVideoDataset(4, seed=seed, cfg=jcfg.data).batch([0, 1], bucket)
    assert np.array_equal(jb.frames, batch.frames)
    det_np, ert_np = load_assets()
    rois = j_preprocess(params_to_jax(det_np), model_to_jax(ert_np),
                        jnp.asarray(jb.frames), jcfg.preprocess)
    hyps = jtranscribe(jparams, jcfg, rois, jnp.asarray(jb.frame_lengths),
                       beam=8)
    assert m == {"eval_cer": corpus_cer(hyps, jb.texts),
                 "eval_wer": corpus_wer(hyps, jb.texts)}
    with open(tr.logger.path) as f:
        last = f.read().splitlines()[-1]
    assert f"hyp={hyps[0]!r}" in last
