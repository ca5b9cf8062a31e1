"""The fp32 transcript parity gate of ``tests/test_parity_gate.py``, held by
the port through its own importer (``lipreading_tpu_torch/train/
importer.py``) and its own per-frame oracle: on the ROIs of
``oracle.pipeline.run_clip`` for make_clip(33000-33004) (equal to the JAX
package's ``run_clip``), the reference-shaped torch model of
``tests/torch_ref.py`` is imported into the port's ``LipReader`` and the
port's CPU transcripts must be string-identical to the reference's own
decodes and to the JAX package's ``transcribe`` on the JAX importer's tree:
CTC greedy, CTC prefix beam (x64 head), attention greedy, attention beam 4.
The state_dict round trip through the port's model and a ``.pt`` file is
bit-exact.

The CTC prefix-beam reference is the numpy prefix search on the reference's
log-posteriors at width 256 (``tests/test_parity_gate.py`` searches at
4096, which takes minutes on a CPU, and holds JAX's beam-16 decode to it;
at 256 the search gives the same strings, and the port must equal JAX's
beam-16 decode too)."""

import numpy as np
import pytest
import torch

from lipreading_tpu.infer import transcribe as j_transcribe
from lipreading_tpu.oracle.pipeline import run_clip as j_run_clip
from lipreading_tpu.train import importer as jimp
from lipreading_tpu_torch.config import from_dict
from lipreading_tpu_torch.fixtures import make_clip
from lipreading_tpu_torch.infer import transcribe
from lipreading_tpu_torch.io import load_assets
from lipreading_tpu_torch.models.lipreader import LipReader, init_model
from lipreading_tpu_torch.ops.ctc_beam import ctc_prefix_beam_search
from lipreading_tpu_torch.oracle.pipeline import run_clip
from lipreading_tpu_torch.text import Vocab
from lipreading_tpu_torch.train import importer as pimp
from tests import torch_ref
from tests.test_parity_gate import N_CLIPS, _gate_cfg
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

PREFIX_SEARCH_WIDTH = 256


@pytest.fixture(scope="module")
def oracle_rois(assets):
    """Each clip's ROIs from the port's run_clip and the JAX package's."""
    det, ert = load_assets()
    jdet, jert = assets
    out = []
    for i in range(N_CLIPS):
        frames = make_clip(33000 + i).frames
        out.append((run_clip(frames, det, ert).roi,
                    j_run_clip(frames, jdet, jert).roi))
    return out


@pytest.fixture(scope="module")
def clips(oracle_rois):
    """The port's ROIs padded to a common T, as the JAX gate pads them."""
    rois = [r for r, _ in oracle_rois]
    lengths = [r.shape[0] for r in rois]
    T = max(lengths)
    rois = np.stack([np.pad(r, ((0, T - r.shape[0]), (0, 0), (0, 0)))
                     for r in rois]).astype(np.float32)
    return rois, np.asarray(lengths, np.int32)


def _models(decoder: str, seed: int, head_scale: float = 1.0):
    """The reference model (seeded), the JAX tree and config, the port's
    model and config, all from its state_dict."""
    jcfg = _gate_cfg(decoder)
    torch.manual_seed(seed)
    ref = torch_ref.TorchLipReader(jcfg).eval()
    if head_scale != 1.0:
        with torch.no_grad():
            ref.ctc_head.weight *= head_scale
            ref.ctc_head.bias *= head_scale
    sd = ref.state_dict()
    cfg = from_dict(jcfg.to_dict())
    return (ref, jimp.import_model(sd, jcfg), jcfg,
            pimp.lipreader_from_state_dict(sd, cfg, device="cpu"), cfg)


def test_run_clip_rois_equal_jax(oracle_rois):
    for port, jax_roi in oracle_rois:
        np.testing.assert_array_equal(port, jax_roi)


def test_ctc_greedy_transcript_parity(clips):
    rois, lengths = clips
    ref, tree, jcfg, port, cfg = _models("ctc", 100)
    want = torch_ref.ctc_greedy_transcripts(
        ref, torch.from_numpy(rois), torch.from_numpy(lengths), Vocab())
    got = transcribe(port, cfg, rois, lengths, beam=1)
    assert got == want, list(zip(got, want))
    assert j_transcribe(tree, jcfg, rois, lengths, beam=1) == want


def test_ctc_prefix_beam_transcript_parity(clips):
    """The head sharpened x64 (trained-checkpoint posteriors), 24 frames:
    the device prefix beam of width 16 against the numpy search."""
    rois, lengths = clips
    rois, lengths = rois[:, :24], np.minimum(lengths, 24)
    ref, tree, jcfg, port, cfg = _models("ctc", 101, head_scale=64.0)
    jcfg.train.max_decode_len = cfg.train.max_decode_len = 32
    lp = torch_ref.ctc_log_posteriors(ref, torch.from_numpy(rois),
                                      torch.from_numpy(lengths))
    want = []
    for b in range(lp.shape[0]):
        ids, _ = ctc_prefix_beam_search(lp[b, : int(lengths[b])],
                                        beam_width=PREFIX_SEARCH_WIDTH,
                                        prune_topk=lp.shape[-1])
        want.append(Vocab().decode(ids))
    got = transcribe(port, cfg, rois, lengths, beam=16)
    assert got == want, list(zip(got, want))
    assert j_transcribe(tree, jcfg, rois, lengths, beam=16) == want


def test_attention_greedy_transcript_parity(clips):
    rois, lengths = clips
    ref, tree, jcfg, port, cfg = _models("attention", 102)
    want = torch_ref.attention_greedy_transcripts(
        ref, torch.from_numpy(rois), torch.from_numpy(lengths), Vocab(),
        jcfg.train.max_decode_len)
    got = transcribe(port, cfg, rois, lengths, beam=1)
    assert got == want, list(zip(got, want))
    assert j_transcribe(tree, jcfg, rois, lengths, beam=1) == want


def test_attention_beam_transcript_parity(clips):
    rois, lengths = clips
    ref, tree, jcfg, port, cfg = _models("attention", 103)
    assert cfg.train.length_penalty == 0.6
    want = torch_ref.attention_beam_transcripts(
        ref, torch.from_numpy(rois), torch.from_numpy(lengths), Vocab(),
        beam=4, max_len=jcfg.train.max_decode_len,
        length_penalty=jcfg.train.length_penalty)
    got = transcribe(port, cfg, rois, lengths, beam=4)
    assert got == want, list(zip(got, want))
    assert j_transcribe(tree, jcfg, rois, lengths, beam=4) == want


def test_state_dict_roundtrip_bitexact(tmp_path):
    """The port's hybrid model -> export -> a ``.pt`` file -> the reference
    model (strict) and back through the importer: every parameter bit for
    bit, and export(import_model(sd)) equal to sd."""
    cfg = from_dict(_gate_cfg("hybrid").to_dict())
    port = init_model(cfg, torch.Generator().manual_seed(9), device="cpu")
    sd = pimp.export_model_state_dict(port, cfg)
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    ref = torch_ref.TorchLipReader(_gate_cfg("hybrid"))
    ref.load_state_dict(pimp.load_torch_state_dict(path), strict=True)
    back = LipReader(cfg)
    back.load_state_dict(pimp.lipreader_from_state_dict(
        ref.state_dict(), cfg, device="cpu").state_dict(), strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    sd2 = pimp.export_model_state_dict(pimp.import_model(sd, cfg), cfg)
    assert set(sd2) == set(sd)
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k


@pytest.mark.parametrize("decoder", ["ctc", "attention", "hybrid"])
def test_the_smokes_gate_config_is_the_gates(decoder):
    """``chip_smoke.py``'s ``[parity-gate]`` builds the same small model."""
    import chip_smoke

    assert (chip_smoke.gate_cfg(decoder).to_dict()
            == from_dict(_gate_cfg(decoder).to_dict()).to_dict())
