"""The port's three preprocessor-training entries (``python -m
lipreading_tpu_torch.train_preprocessor``, ``.train_presence`` and
``.train_landmarker``) on the CPU: their arguments and defaults against the
JAX scripts', each trainer's defaults against the JAX package's, a 2-step
run of each into a temporary directory, and the transcript gate at one
clip. None writes into ``assets/``.

Tolerances: ``ert.npz`` of a ``train_preprocessor`` run is byte-equal to
the JAX package's ``train_all`` of the same arguments (numpy boosting on the
same frames); its detector after 2 steps within 1e-5 of JAX's (float32
sums in other orders; see ``test_torch_preproc_training.py``)."""

import inspect
import os

import numpy as np
import pytest

from lipreading_tpu import preproc_training as jpt
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch import preproc_training as tpt
from lipreading_tpu_torch import train_landmarker, train_presence
from lipreading_tpu_torch import train_preprocessor
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_helpers import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")


@pytest.mark.parametrize("name", ["train_detector", "train_all",
                                  "train_presence_head",
                                  "train_conv_landmarker"])
def test_trainer_defaults_match_jax(name):
    want = inspect.signature(getattr(jpt, name)).parameters
    got = inspect.signature(getattr(tpt, name)).parameters
    assert list(got) == list(want) + ["device"]
    for k, p in want.items():
        assert got[k].default == p.default, k
    assert got["device"].default == "cuda"


def test_arguments_and_defaults():
    assert train_preprocessor.parse_args([]) == {"device": "cuda",
                                                 "out_dir": None}
    assert train_preprocessor.parse_args(
        ["seed=3", "n_clips=2", "det_steps=5", "out_dir=/x",
         "device=cpu"]) == {"seed": 3, "n_clips": 2, "det_steps": 5,
                            "out_dir": "/x", "device": "cpu"}
    assert train_presence.parse_args([]) == {
        "seed": 0, "n_clips": 24, "variants": ["default", "robust"],
        "out_dir": tio.ASSETS_DIR, "device": "cuda"}
    lm = train_landmarker.parse_args([])
    assert lm == {"variant": "default", "n_clips": 48, "steps": 4000,
                  "seed": 0, "variation": 0.0,
                  "out": os.path.join(tio.ASSETS_DIR, "landmarker_conv.npz"),
                  "gate_cer": True,
                  "gate_release": "transformer_hybrid_universal",
                  "mouth_weight": 4.0, "box_weight": 1.0, "roi_loss": 0.0,
                  "width": 1.0, "device": "cuda"}
    lm = train_landmarker.parse_args(["variant=robust", "gate_cer=0",
                                      "roi_loss=1.0", "width=0.5"])
    assert lm["out"] == os.path.join(tio.ASSETS_DIR,
                                     "landmarker_conv_robust.npz")
    assert (lm["gate_cer"], lm["roi_loss"], lm["width"]) == (False, 1.0, 0.5)
    for parse in (train_preprocessor.parse_args, train_presence.parse_args,
                  train_landmarker.parse_args):
        with pytest.raises(SystemExit):
            parse(["bogus=1"])
        with pytest.raises(ValueError):
            parse(["seed"])


@pytest.mark.parametrize("entry", [train_preprocessor, train_presence,
                                   train_landmarker])
def test_entries_default_to_the_card(entry, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    with pytest.raises(SystemExit, match="no CUDA device"):
        entry.main([f"out_dir={tmp_path}"] if entry is not train_landmarker
                   else [f"out={tmp_path}/lm.npz"])
    assert not os.listdir(tmp_path)


def test_train_preprocessor_two_steps_like_jax(tmp_path):
    train_preprocessor.main([f"out_dir={tmp_path}/port", "n_clips=1",
                             "det_steps=2", "seed=1", "device=cpu"])
    jpt.train_all(seed=1, n_clips=1, det_steps=2,
                  out_dir=str(tmp_path / "jax"), verbose=False)
    assert sorted(os.listdir(tmp_path / "port")) == [
        "detector.npz", "ert.npz", "presence.npz"]
    got = np.load(tmp_path / "port" / "ert.npz")
    want = np.load(tmp_path / "jax" / "ert.npz")
    assert got.files == want.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    det, _ = jpt.load_assets(str(tmp_path / "port"))
    jdet, _ = jpt.load_assets(str(tmp_path / "jax"))
    for k in jdet:
        np.testing.assert_allclose(det[k], jdet[k], rtol=0, atol=1e-5)
    head = jpt.load_presence(str(tmp_path / "port"))
    shipped = tio.load_presence()
    assert {k: v.shape for k, v in head.items()} == {
        k: v.shape for k, v in shipped.items()}


def test_train_presence_one_variant(tmp_path, capsys):
    heads = train_presence.main([f"out_dir={tmp_path}", "n_clips=1",
                                 "variants=robust", "device=cpu"])
    assert os.listdir(tmp_path) == ["presence_robust.npz"]
    assert "[robust] held-out face conf" in capsys.readouterr().out
    loaded = tio.load_presence(str(tmp_path), variant="robust")
    for k, v in heads["robust"].items():
        np.testing.assert_array_equal(loaded[k], v)
        assert np.isfinite(v).all()


def test_train_landmarker_two_steps(tmp_path, capsys):
    out = tmp_path / "landmarker_conv.npz"
    report = train_landmarker.main([f"out={out}", "steps=2", "n_clips=1",
                                    "gate_cer=0", "device=cpu"])
    text = capsys.readouterr().out
    assert "held-out landmark error vs ERT" in text and "saved" in text
    assert np.isfinite(report["err_px"]) and 0 <= report["agreement"] <= 1
    got = jpt.load_landmarker(str(tmp_path))
    shipped = tio.load_landmarker()
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in shipped.items()}


def test_transcript_gate_at_one_clip():
    det, ert = tio.load_assets()
    cers, hyps = train_landmarker.gate_transcript_cer(
        tio.load_landmarker(), det, ert, "transformer_hybrid_universal",
        0.0, 0, n_clips=1, device="cpu")
    assert set(cers) == set(hyps) == {"ert", "conv"}
    assert all(len(h) == 1 and h[0] for h in hyps.values())
    assert all(0.0 <= c <= 1.0 for c in cers.values())
    assert train_landmarker.gate_transcript_cer(
        None, det, ert, "no_such_release", 0.0, 0) == (None, None)
