"""The port's decoding entry points (``infer.decode_ids``, ``transcribe``,
``transcribe_cascade``) against the JAX package on the CPU: on tiny models
(weights from the JAX package's ``init_model``), and on the shipped
universal4 release with the clips of the JAX package's
``test_cascade_matches_full_beam_on_release`` (``make_clip(717171 + i)``,
i in 2, 7, 11: an easy clip, a low-margin clip and one the beam corrects).

Tolerance: none. Ids, lengths, transcripts and trigger flags are compared
for equality; the releases' ROIs come from the JAX package's
``preprocess_padded`` and are fed to both packages, except in the case that
runs the port's own ``preprocess_clips`` on the frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu import infer as jinf
from lipreading_tpu.config import Config as JConfig
from lipreading_tpu.config import ModelConfig as JModel
from lipreading_tpu.config import TrainConfig as JTrain
from lipreading_tpu.fixtures import make_clip as j_make_clip
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.ops.detector import params_to_jax
from lipreading_tpu.ops.ert import model_to_jax
from lipreading_tpu.ops.preprocess import preprocess_padded
from lipreading_tpu.preproc_training import load_assets as j_load_assets
from lipreading_tpu.preproc_training import load_release_model as j_release
from lipreading_tpu_torch import infer
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.config import Config, ModelConfig, TrainConfig
from lipreading_tpu_torch.fixtures import LEXICON, make_clip
from lipreading_tpu_torch.models.lipreader import LipReader
from lipreading_tpu_torch.ops import decode as tdec
from lipreading_tpu_torch.ops.detector import params_to_torch
from lipreading_tpu_torch.ops.ert import model_to_torch
from lipreading_tpu_torch.ops.preprocess import preprocess_clips
from lipreading_tpu_torch.text import Vocab

B, T, R = 2, 10, 96
RELEASE = "transformer_hybrid_universal4"
CASCADE = dict(beam=8, lm_weight=0.4, rescore_bucket=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The beams issue hundreds of small PyTorch ops a step. Beside the
    other workers of a parallel test run, an intra-op pool of one thread
    per core waits on cores that are busy elsewhere, and a call that takes
    0.5 s alone took 50 s; one thread keeps this file near its time
    alone. The pool's size is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(decoder):
    kw = dict(frontend="patchify", patch_dim=16, frontend_dim=24, tf_dim=32,
              tf_heads=2, tf_mlp=64, tf_layers=1, tf_dec_layers=1)
    tkw = dict(max_decode_len=8, beam_width=3, ctc_weight=0.3)
    cfg = Config(encoder="transformer", decoder=decoder,
                 model=ModelConfig(**kw), train=TrainConfig(**tkw))
    jcfg = JConfig(encoder="transformer", decoder=decoder,
                   model=JModel(**kw), train=JTrain(**tkw))
    params = jlr.init_model(jax.random.PRNGKey(0), jcfg)
    model = LipReader(cfg)
    model.load_state_dict(tio.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    rng = np.random.default_rng(4)
    rois = rng.normal(0, 1, (B, T, R, R)).astype(np.float32)
    lengths = np.asarray([T, T - 2], np.int32)
    return model.eval(), cfg, params, jcfg, rois, lengths


@pytest.mark.parametrize("decoder,beam", [("hybrid", 1), ("hybrid", 3),
                                          ("ctc", 1), ("ctc", 3)])
def test_decode_ids_matches_jax_on_a_tiny_model(decoder, beam):
    """Each branch of the dispatch: attention greedy, the joint beam, CTC
    greedy (the kernel's plain version here) and the device prefix beam."""
    model, cfg, params, jcfg, rois, lengths = _tiny(decoder)
    want = jinf._decode_jit(jcfg, beam)(params, jnp.asarray(rois),
                                        jnp.asarray(lengths))
    got = infer.decode_ids(model, cfg, torch.from_numpy(rois),
                           torch.from_numpy(lengths), beam)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cascade_endpoints_on_a_tiny_model():
    """margin=inf rescores every clip (== transcribe); with every trigger
    off none is (== the greedy leg); return_flags gives the flags."""
    model, cfg, _, _, rois, lengths = _tiny("hybrid")
    full = infer.transcribe(model, cfg, rois, lengths, beam=3)
    casc, n = infer.transcribe_cascade(model, cfg, rois, lengths, beam=3,
                                       margin=float("inf"))
    assert casc == full and n == B
    casc, flags = infer.transcribe_cascade(
        model, cfg, rois, lengths, beam=3, margin=float("inf"),
        rescore_bucket=3, return_flags=True)
    assert casc == full and flags.dtype == bool and flags.all()
    off = dict(margin=0.0, lm_margin=float("inf"), oov_trigger=False)
    casc, n = infer.transcribe_cascade(model, cfg, rois, lengths, beam=3,
                                       lm_weight=0.4, **off)
    ids, counts, _, _ = infer.greedy_conf(model, cfg, torch.from_numpy(rois),
                                          torch.from_numpy(lengths))
    greedy = [Vocab().decode(ids[b, :counts[b]].numpy())
              for b in range(B)]
    assert casc == greedy and n == 0
    # the OOV trigger alone: random weights give non-words
    _, flags = infer.transcribe_cascade(
        model, cfg, rois, lengths, beam=3, margin=0.0,
        lm_margin=float("inf"), return_flags=True)
    assert flags.tolist() == [any(w not in LEXICON for w in t.split())
                              for t in greedy]


def test_cascade_rows_limit_the_rescore_leg_on_a_tiny_model():
    """rows keeps the clips outside it out of the rescore leg: they keep
    the greedy transcript and are not flagged, the others are rescored as
    without it (margin=inf)."""
    model, cfg, _, _, rois, lengths = _tiny("hybrid")
    full = infer.transcribe(model, cfg, rois, lengths, beam=3)
    ids, counts, _, _ = infer.greedy_conf(model, cfg, torch.from_numpy(rois),
                                          torch.from_numpy(lengths))
    greedy = [Vocab().decode(ids[b, :counts[b]].numpy())
              for b in range(B)]
    for rows in ([True, False], [False, True], [False, False]):
        casc, flags = infer.transcribe_cascade(
            model, cfg, rois, lengths, beam=3, margin=float("inf"),
            return_flags=True, rows=np.asarray(rows))
        assert flags.tolist() == rows
        assert casc == [full[b] if rows[b] else greedy[b] for b in range(B)]


@pytest.fixture(scope="module")
def release():
    """The universal4 release in both packages, the three clips' frames
    (zero-padded) and the JAX package's ROIs, and the JAX transcripts."""
    params, jcfg = j_release(RELEASE)
    det_np, ert_np = j_load_assets()
    det, ert = params_to_jax(det_np), model_to_jax(ert_np)
    clips = [j_make_clip(717171 + i, jcfg.data) for i in (2, 7, 11)]
    rois_l = [np.asarray(preprocess_padded(det, ert, c.frames,
                                           jcfg.preprocess)) for c in clips]
    lens = np.asarray([r.shape[0] for r in rois_l], np.int32)
    P = -(-int(lens.max()) // 64) * 64
    rois = np.stack([np.pad(r, ((0, P - len(r)), (0, 0), (0, 0)))
                     for r in rois_l])
    frames = np.zeros((3, P) + clips[0].frames.shape[1:], np.uint8)
    for b, c in enumerate(clips):
        frames[b, :len(c.frames)] = c.frames
    assert lens.tolist() == [len(c.frames) for c in clips]
    jl = jnp.asarray(lens)
    want = {
        "beam_lm": jinf.transcribe(params, jcfg, rois, jl, beam=8,
                                   lm_weight=0.4),
        "beam_lm_lexicon": jinf.transcribe(params, jcfg, rois, jl, beam=8,
                                           lm_weight=0.4, use_lexicon=True),
        "attention_greedy": jinf.transcribe(params, jcfg, rois, jl, beam=1),
        "cascade": jinf.transcribe_cascade(params, jcfg, rois, jl,
                                           return_flags=True, **CASCADE),
    }
    model, cfg = tio.load_release_model(RELEASE, device="cpu")
    return dict(model=model, cfg=cfg, rois=rois, lens=lens, frames=frames,
                det_np=det_np, ert_np=ert_np, want=want)


@pytest.mark.parametrize("kind", ["beam_lm", "beam_lm_lexicon",
                                  "attention_greedy"])
def test_release_transcribe_matches_jax(release, kind):
    kw = {"beam_lm": dict(beam=8, lm_weight=0.4),
          "beam_lm_lexicon": dict(beam=8, lm_weight=0.4, use_lexicon=True),
          "attention_greedy": dict(beam=1)}[kind]
    got = infer.transcribe(release["model"], release["cfg"], release["rois"],
                           release["lens"], **kw)
    assert got == release["want"][kind]


def test_release_cascade_matches_jax_and_the_full_beam(release):
    """The cascade's transcripts and flags equal the JAX package's, and the
    cascade equals the full joint beam (with LM) on these clips."""
    want, want_flags = release["want"]["cascade"]
    before = tdec.early_exit_scan.steps
    got, flags = infer.transcribe_cascade(
        release["model"], release["cfg"], release["rois"], release["lens"],
        return_flags=True, **CASCADE)
    assert got == want and flags.tolist() == np.asarray(want_flags).tolist()
    assert 1 <= flags.sum() < 3
    assert got == release["want"]["beam_lm"]
    # the rescore leg stopped early: every beam finished before 48 steps
    assert 0 < tdec.early_exit_scan.steps - before < 48


def test_release_cascade_from_frames(release):
    """frames -> the port's preprocess_clips -> the cascade gives the JAX
    package's transcripts."""
    det = params_to_torch(release["det_np"], "cpu")
    ert = model_to_torch(release["ert_np"], "cpu")
    cfg = release["cfg"]
    assert np.array_equal(make_clip(717171 + 2, cfg.data).frames,
                          release["frames"][0, :release["lens"][0]])
    rois = preprocess_clips(det, ert, torch.from_numpy(release["frames"]),
                            cfg.preprocess)
    got, n = infer.transcribe_cascade(release["model"], cfg, rois,
                                      release["lens"], **CASCADE)
    assert got == release["want"]["cascade"][0]
    assert n == int(release["want"]["cascade"][1].sum())
