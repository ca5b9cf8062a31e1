"""The port's whole slice on the CPU with the shipped universal4 release:
uint8 fixture frames -> ``preprocess_clips`` -> ``greedy_conf`` ->
transcripts, against the JAX package's ``preprocess_clips`` and
``_greedy_conf_jit`` on the same frames; and the smoke script's refusal to
run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from lipreading_tpu.infer import _greedy_conf_jit
from lipreading_tpu.ops.detector import params_to_jax
from lipreading_tpu.ops.ert import model_to_jax
from lipreading_tpu.ops.preprocess import preprocess_clips as j_preprocess
from lipreading_tpu.preproc_training import load_assets as j_load_assets
from lipreading_tpu.preproc_training import load_release_model as j_load_release
from lipreading_tpu.text import Vocab as JVocab
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.fixtures import make_clip
from lipreading_tpu_torch.infer import greedy_conf, transcribe_greedy
from lipreading_tpu_torch.ops.detector import params_to_torch
from lipreading_tpu_torch.ops.ert import model_to_torch
from lipreading_tpu_torch.ops.preprocess import preprocess_clips

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _batch(seeds):
    clips = [make_clip(s) for s in seeds]
    T = max(len(c.frames) for c in clips)
    frames = np.zeros((len(clips), T, 160, 160, 3), np.uint8)
    lengths = np.zeros((len(clips),), np.int32)
    for b, c in enumerate(clips):
        frames[b, :len(c.frames)] = c.frames
        lengths[b] = len(c.frames)
    return frames, lengths, [c.text for c in clips]


def test_universal4_transcripts_match_jax():
    frames, lengths, texts = _batch([101, 104])      # 64 and 68 frames
    params, jcfg = j_load_release("transformer_hybrid_universal4")
    det_np, ert_np = j_load_assets()
    jrois = j_preprocess(params_to_jax(det_np), model_to_jax(ert_np),
                         jnp.asarray(frames), jcfg.preprocess)
    ids, n, jconf, _ = _greedy_conf_jit(jcfg)(params, jrois,
                                              jnp.asarray(lengths))
    ids, n = np.asarray(ids), np.asarray(n)
    want = [JVocab().decode(ids[b, :n[b]]) for b in range(len(texts))]

    model, cfg = tio.load_release_model(device="cpu")
    det, ert = params_to_torch(det_np, "cpu"), model_to_torch(ert_np, "cpu")
    got, flags = transcribe_greedy(model, cfg, det, ert, frames, lengths)
    assert got == want
    assert flags.tolist() == (np.asarray(jconf) < 8.0).tolist()

    rois = preprocess_clips(det, ert, torch.from_numpy(frames), cfg.preprocess)
    np.testing.assert_allclose(rois.numpy(), np.asarray(jrois), atol=1e-4)
    _, _, conf, _ = greedy_conf(model, cfg, rois, torch.from_numpy(lengths))
    # bfloat16 model: the mean top1 - top2 margin (~13 nats) within 0.1
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=0.1)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_to_run_without_gpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_fixture_copy_matches_jax():
    """The port's renderer copy gives the JAX package's clips byte for byte."""
    from lipreading_tpu.fixtures import make_clip as j_make_clip

    for seed in (0, 101):
        a, b = make_clip(seed), j_make_clip(seed)
        assert a.text == b.text
        np.testing.assert_array_equal(a.frames, b.frames)
        np.testing.assert_array_equal(a.landmarks, b.landmarks)


def test_corpus_cer_matches_jax():
    from lipreading_tpu.metrics import corpus_cer as j_cer
    from lipreading_tpu_torch.metrics import corpus_cer

    hyps = ["write write they arout", "", "abc"]
    refs = ["write write they about", "x", "abd"]
    assert corpus_cer(hyps, refs) == j_cer(hyps, refs)
