"""The conv3d-stem releases on the CPU at full width and depth, against the
JAX package, and the fp32 parity gate of ``tests/test_parity_gate.py``
reproduced by the port:

* every release of ``assets/`` loads through ``io.load_release_model``
  with a strict ``load_state_dict``;
* ``bigru_ctc`` on the three clips of
  ``tests/test_release_model.py::test_release_model_heldout_cer`` and
  ``transformer_hybrid_universal`` on the 2 + 2 clips of
  ``test_universal_release_covers_both_appearances`` (ERT ROIs, each clip
  padded to a multiple of 64, beam 1): transcripts string-identical to
  JAX's, and the CER gates of those tests;
* ``bigru_ctc`` through the cascade (beam 8, LM 0.4) on two clips equal to
  JAX's ``transcribe_cascade``;
* the reference-shaped torch model of ``tests/torch_ref.py``, carried
  through the JAX importer and ``from_jax_params``: the port's transcripts
  equal the reference's own decodes (CTC greedy, attention greedy,
  attention beam 4 with length penalty 0.6).

Both packages decode the same ROIs (the JAX package's preprocessing); the
port's preprocessing is held against the JAX package's elsewhere
(``test_torch_preprocess.py``, ``test_torch_release.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.fixtures import make_clip
from lipreading_tpu.infer import transcribe as j_transcribe
from lipreading_tpu.infer import transcribe_cascade as j_cascade
from lipreading_tpu.metrics import corpus_cer
from lipreading_tpu.ops.detector import params_to_jax
from lipreading_tpu.ops.ert import model_to_jax
from lipreading_tpu.ops.preprocess import preprocess_padded
from lipreading_tpu.preproc_training import load_assets as j_load_assets
from lipreading_tpu.preproc_training import load_release_model as j_release
from lipreading_tpu.text import Vocab
from lipreading_tpu.train import importer
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.config import from_dict
from lipreading_tpu_torch.infer import transcribe, transcribe_cascade
from lipreading_tpu_torch.models.lipreader import LipReader
from tests import torch_ref
from tests.test_parity_gate import _torch_model, clips  # noqa: F401
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

RELEASES = {"bigru_ctc": ("conv3d", "bigru", "ctc"),
            "transformer_hybrid": ("conv3d", "transformer", "hybrid"),
            "transformer_hybrid_robust": ("conv3d", "transformer", "hybrid"),
            "transformer_hybrid_universal": ("conv3d", "transformer",
                                             "hybrid"),
            "transformer_hybrid_universal3": ("patchify", "transformer",
                                              "hybrid"),
            "transformer_hybrid_universal4": ("patchify", "transformer",
                                              "hybrid")}


@pytest.mark.parametrize("name", sorted(RELEASES))
def test_release_loads_strictly(name):
    model, cfg = tio.load_release_model(name, device="cpu")
    assert (cfg.model.frontend, cfg.encoder, cfg.decoder) == RELEASES[name]
    tree, _ = tio.load_release(name)
    # load_release_model's load_state_dict is strict; every leaf is used
    assert set(model.state_dict()) == set(tio.from_jax_params(tree, cfg))


def _padded_rois(det, ert, cfg, seeds, variation=0.0):
    """ERT ROIs of each clip, padded to a multiple of 64 -> [(rois [1, P, R,
    R], length)], and the texts."""
    out, texts = [], []
    for s in seeds:
        clip = make_clip(s, cfg.data, variation=variation)
        r = preprocess_padded(det, ert, clip.frames, cfg.preprocess)
        T = r.shape[0]
        P = -(-T // 64) * 64
        out.append((np.pad(r, ((0, P - T), (0, 0), (0, 0)))[None], T))
        texts.append(clip.text)
    return out, texts


def _greedy_both(name, variant, groups):
    params, jcfg = j_release(name)
    model, cfg = tio.load_release_model(name, device="cpu")
    det_np, ert_np = j_load_assets(variant=variant)
    det, ert = params_to_jax(det_np), model_to_jax(ert_np)
    hyps, want, refs = [], [], []
    for seeds, variation in groups:
        batch, texts = _padded_rois(det, ert, jcfg, seeds, variation)
        for rois, T in batch:
            want += j_transcribe(params, jcfg, rois, jnp.asarray([T]), beam=1)
            hyps += transcribe(model, cfg, rois, np.asarray([T]), beam=1)
        refs += texts
    return hyps, want, refs


def test_bigru_ctc_release_transcripts_match_jax():
    hyps, want, refs = _greedy_both(
        "bigru_ctc", "default", [([424242 + i for i in range(3)], 0.0)])
    assert hyps == want
    cer = corpus_cer(hyps, refs)
    assert cer < 0.30, (cer, list(zip(hyps, refs)))


def test_universal_release_both_appearances_match_jax():
    hyps, want, refs = _greedy_both(
        "transformer_hybrid_universal", "robust",
        [([515151, 515152], 0.0), ([515151, 515152], 0.6)])
    assert hyps == want
    cer = corpus_cer(hyps, refs)
    assert cer < 0.25, (cer, list(zip(hyps, refs)))


def test_bigru_ctc_cascade_matches_jax():
    """Two clips as one batch, padded to a common multiple of 64, through
    the cascade at beam 8 with the char LM at 0.4 (the CTC prefix beam
    rescores the flagged clips); the flags too."""
    params, jcfg = j_release("bigru_ctc")
    model, cfg = tio.load_release_model("bigru_ctc", device="cpu")
    det_np, ert_np = j_load_assets()
    det, ert = params_to_jax(det_np), model_to_jax(ert_np)
    rois_l = [preprocess_padded(det, ert, make_clip(717171 + i, jcfg.data)
                                .frames, jcfg.preprocess) for i in (2, 11)]
    lens = np.asarray([r.shape[0] for r in rois_l], np.int32)
    P = -(-int(lens.max()) // 64) * 64
    rois = np.stack([np.pad(r, ((0, P - len(r)), (0, 0), (0, 0)))
                     for r in rois_l])
    for margin in (8.0, float("inf")):
        want, wflags = j_cascade(params, jcfg, rois, jnp.asarray(lens),
                                 beam=8, lm_weight=0.4, margin=margin,
                                 rescore_bucket=2, return_flags=True)
        got, flags = transcribe_cascade(model, cfg, rois, lens, beam=8,
                                        lm_weight=0.4, margin=margin,
                                        rescore_bucket=2, return_flags=True)
        assert got == want, (margin, got, want)
        assert flags.tolist() == np.asarray(wflags).tolist()
    assert flags.all()                  # margin=inf rescored every clip


# --- the parity gate, reproduced ---


def _port_from_reference(decoder: str, seed: int):
    """The reference-shaped torch model of the gate and the port's model
    carrying its weights (through the JAX importer)."""
    model, jcfg = _torch_model(decoder, seed)
    tree = importer.import_model(model.state_dict(), jcfg)
    cfg = from_dict(jcfg.to_dict())
    port = LipReader(cfg)
    port.load_state_dict(tio.from_jax_params(_numpy(tree), cfg))
    return model, jcfg, port.eval(), cfg


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return np.asarray(tree)


def test_parity_gate_ctc_greedy(clips):  # noqa: F811
    rois, lengths, _ = clips
    ref, _, port, cfg = _port_from_reference("ctc", 100)
    want = torch_ref.ctc_greedy_transcripts(
        ref, torch.from_numpy(rois), torch.from_numpy(lengths), Vocab())
    assert transcribe(port, cfg, rois, lengths, beam=1) == want


def test_parity_gate_attention_greedy(clips):  # noqa: F811
    rois, lengths, _ = clips
    ref, jcfg, port, cfg = _port_from_reference("attention", 102)
    want = torch_ref.attention_greedy_transcripts(
        ref, torch.from_numpy(rois), torch.from_numpy(lengths), Vocab(),
        jcfg.train.max_decode_len)
    assert transcribe(port, cfg, rois, lengths, beam=1) == want


def test_parity_gate_attention_beam(clips):  # noqa: F811
    rois, lengths, _ = clips
    ref, jcfg, port, cfg = _port_from_reference("attention", 103)
    assert cfg.train.length_penalty == 0.6
    want = torch_ref.attention_beam_transcripts(
        ref, torch.from_numpy(rois), torch.from_numpy(lengths), Vocab(),
        beam=4, max_len=jcfg.train.max_decode_len,
        length_penalty=jcfg.train.length_penalty)
    assert transcribe(port, cfg, rois, lengths, beam=4) == want
