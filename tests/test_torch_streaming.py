"""``streaming.StreamingTranscriber`` against the JAX package's on the CPU.

The JAX streaming tests' tiny ``bigru-ctc`` (channels (4, 8, 12), dim 32,
H 24, one layer, float32) and a tiny ``hybrid`` transformer (for the joint
beam over a segment at a flush or at ``finish``) are carried across by
``io.from_jax_params``. The same chunks go through both transcribers, and
after every ``feed`` the transcript, the committed text, ``_ctx``, the
buffer's length and ``cut_events`` must be equal (exact: strings and
ints), and so must the buffered ROI frames (within 1e-4) and the final
transcript. The port's ROIs agree with the
JAX package's to ~1e-5, which moves no argmax here.

The JAX transcriber's segment decode (the joint beam at a flush or at
``finish``) is run op by op, as the port runs it: on one segment of the
tiny hybrid the JAX package's jitted beam reads another hypothesis than
the same beam op by op, which the port equals
(``tests/test_torch_streaming_beam.py::
test_tracked_hybrid_stream_and_its_near_tie``). The beam configs are in
that file, the tracked ones in ``tests/test_torch_streaming_tracked.py``."""

import jax
import numpy as np
import pytest
import torch

from lipreading_tpu import streaming as jstreaming
from lipreading_tpu.config import Config as JConfig
from lipreading_tpu.config import ModelConfig as JModel
from lipreading_tpu.config import TrainConfig as JTrain
from lipreading_tpu.config import preset as jpreset
from lipreading_tpu.fixtures import (
    blank_out_frames,
    make_clip,
    render_faceless_frames,
)
from lipreading_tpu import infer as jinf
from lipreading_tpu.infer import transcribe as j_transcribe
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.ops.detector import params_to_jax
from lipreading_tpu.ops.ert import model_to_jax
from lipreading_tpu.ops.landmarker import params_to_jax as lmk_to_jax
from lipreading_tpu.preproc_training import (
    load_assets,
    load_landmarker,
    load_presence,
)
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch import streaming
from lipreading_tpu_torch.config import Config, ModelConfig, TrainConfig
from lipreading_tpu_torch.config import preset
from lipreading_tpu_torch.infer import transcribe
from lipreading_tpu_torch.models.lipreader import LipReader
from lipreading_tpu_torch.ops import detector as tdet
from lipreading_tpu_torch.ops import ert as tert
from lipreading_tpu_torch.ops import landmarker as tlmk
from lipreading_tpu_torch.ops.preprocess import preprocess_frames
from tests.test_torch_helpers import file_hang_guard  # noqa: F401

pytestmark = pytest.mark.usefixtures("file_hang_guard")

TINY_BIGRU = {"model.frontend_channels": "4,8,12", "model.frontend_dim": 32,
              "model.gru_hidden": 24, "model.gru_layers": 1,
              "model.dtype": "float32"}
TINY_TF = dict(frontend="patchify", patch_dim=16, frontend_dim=24, tf_dim=32,
               tf_heads=2, tf_mlp=64, tf_layers=1, tf_dec_layers=1)
TINY_TRAIN = dict(max_decode_len=12, beam_width=3, ctc_weight=0.3)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(cfg, jcfg):
    params = jax.tree_util.tree_map(
        np.asarray, jlr.init_model(jax.random.PRNGKey(0), jcfg))
    model = LipReader(cfg)
    model.load_state_dict(tio.from_jax_params(params, cfg))
    return dict(model=model.eval(), cfg=cfg, params=params, jcfg=jcfg)


@pytest.fixture(scope="module")
def models():
    bigru = _pair(preset("bigru-ctc").override(**TINY_BIGRU),
                  jpreset("bigru-ctc").override(**TINY_BIGRU))
    hybrid = _pair(
        Config(encoder="transformer", decoder="hybrid",
               model=ModelConfig(**TINY_TF), train=TrainConfig(**TINY_TRAIN)),
        JConfig(encoder="transformer", decoder="hybrid",
                model=JModel(**TINY_TF), train=JTrain(**TINY_TRAIN)))
    return {"bigru": bigru, "hybrid": hybrid}


@pytest.fixture(scope="module")
def prep():
    """The default preprocessing assets in both packages, and the conv
    landmarker's."""
    det_np, ert_np = load_assets()
    pres_np, lmk_np = load_presence(), load_landmarker()
    return {
        "jax": dict(det=params_to_jax(det_np), ert=model_to_jax(ert_np),
                    conv=lmk_to_jax(lmk_np), presence=pres_np),
        "port": dict(det=tdet.params_to_torch(det_np, "cpu"),
                     ert=tert.model_to_torch(ert_np, "cpu"),
                     conv=tlmk.params_to_torch(lmk_np, "cpu"),
                     presence=tdet.params_to_torch(pres_np, "cpu")),
    }


def _state(st):
    return (st.hypothesis, st.committed, st._ctx, len(st._buf),
            st.cut_events)


def _streams(models, prep, model, landmarker="ert", tracked=False, **kw):
    m = models[model]
    jcfg, cfg = m["jcfg"], m["cfg"]
    if landmarker == "conv":
        jcfg = jcfg.override(**{"preprocess.landmarker": "conv"})
        cfg = cfg.override(**{"preprocess.landmarker": "conv"})
    lmk = "conv" if landmarker == "conv" else "ert"
    j, p = prep["jax"], prep["port"]
    js = jstreaming.StreamingTranscriber(
        m["params"], jcfg, j["det"], j[lmk], tracked=tracked,
        presence=j["presence"] if tracked else None, **kw)
    ps = streaming.StreamingTranscriber(
        m["model"], cfg, p["det"], p[lmk], tracked=tracked,
        presence=p["presence"] if tracked else None, **kw)
    if js._segment_decode is not None:
        js._segment_decode = _eager_decode(jcfg, ps.beam, ps.lm_weight)
    return js, ps


def _eager_decode(jcfg, beam, lm_weight):
    """The JAX package's ``decode_ids`` op by op (the segment decode's
    function without ``jax.jit``)."""
    lm = jinf._load_lm() if lm_weight > 0 else None
    return lambda params, rois, lengths: jinf.decode_ids(
        params, jcfg, rois, lengths, beam, lm_weight, lm=lm)


def _same_buffer(ps, js, k):
    """The buffered ROI frames equal the JAX transcriber's (1e-4: a conv
    landmark's float32 ulps move a ROI by ~3e-5; the ERT's by ~1e-5)."""
    if js._buf:
        np.testing.assert_allclose(torch.stack(ps._buf).numpy(),
                                   np.stack(js._buf), atol=1e-4,
                                   err_msg=f"chunk {k}")


def _run_both(js, ps, frames, sizes):
    """Feed both the same chunks; the states and the buffered ROIs after
    every feed and the final transcripts must be equal -> the port's
    transcriber."""
    lo = 0
    for k, n in enumerate(sizes):
        chunk = frames[lo:lo + n]
        lo += n
        assert ps.feed(chunk) == js.feed(chunk), k
        assert _state(ps) == _state(js), (k, _state(ps), _state(js))
        _same_buffer(ps, js, k)
    assert lo >= frames.shape[0]
    assert ps.finish() == js.finish()
    assert _state(ps) == _state(js)
    return ps


def _chunks(n, size):
    return [size] * (-(-n // size))


def _video(name):
    if name == "clip0":
        return make_clip(0).frames
    if name == "clip0_32":  # fits one window of 32
        return make_clip(0).frames[:32]
    if name == "gap":       # a 40-frame cutaway between two clips
        return np.concatenate([make_clip(5501).frames,
                               render_faceless_frames(7, 40),
                               make_clip(5502).frames])
    if name == "cut":       # two clips back to back: a hard cut
        return np.concatenate([make_clip(6601).frames,
                               make_clip(6602).frames])
    if name == "seam":      # a gap over the 16-frame chunk seam
        return blank_out_frames(make_clip(8901), list(range(14, 19)), seed=4)
    raise KeyError(name)


# (model, video, chunk sizes (None: 16s), transcriber kwargs, counts that
# must be > 0)
CONFIGS = {
    "greedy_window32": ("bigru", "clip0_32", [8] * 4,
                        dict(window=32, decode_every=8), ()),
    "window16_commits": ("bigru", "clip0", None,
                         dict(window=16, decode_every=8), ("commits",)),
    "ragged": ("bigru", "clip0", [3, 7, 1, 11, 5, 2, 13, 16, 16],
               dict(window=32, decode_every=8), ("commits",)),
    "untracked_conv_landmarker": ("bigru", "clip0", None,
                                  dict(window=32, landmarker="conv"), ()),
}


def check_config(models, prep, config):
    """Stream ``config`` = (model, video, chunk sizes, kwargs, counts that
    must be > 0) through both transcribers."""
    model, video, sizes, kw, nonzero = config
    frames = _video(video)
    js, ps = _streams(models, prep, model, **kw)
    ps = _run_both(js, ps, frames, sizes or _chunks(len(frames), 16))
    for k in nonzero:
        assert ps.counts[k] > 0, (k, ps.counts)
    if video == "cut":          # the splice fires the hard-cut flush once
        assert ps.cut_events == 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stream_matches_jax_after_every_feed(models, prep, name):
    check_config(models, prep, CONFIGS[name])


def test_greedy_stream_equals_batch_decode(models, prep):
    """tests/test_streaming.py's first case: a clip that fits one window
    streams to the batch decode of its ROIs."""
    m, p = models["bigru"], prep["port"]
    frames = make_clip(0).frames[:32]
    st = streaming.StreamingTranscriber(m["model"], m["cfg"], p["det"],
                                        p["ert"], window=32, decode_every=8)
    for lo in range(0, 32, 8):
        st.feed(frames[lo:lo + 8])
    got = st.finish()
    with torch.inference_mode():
        rois = preprocess_frames(p["det"], p["ert"], torch.as_tensor(frames),
                                 m["cfg"].preprocess)
    want = transcribe(m["model"], m["cfg"], rois[None],
                      np.asarray([32], np.int32), beam=1)[0]
    assert got == want
    jrois = jstreaming.preprocess_frames(prep["jax"]["det"],
                                         prep["jax"]["ert"], frames,
                                         m["jcfg"].preprocess)
    assert want == j_transcribe(m["params"], m["jcfg"],
                                np.asarray(jrois)[None],
                                np.asarray([32], np.int32), beam=1)[0]


def test_ragged_chunks_reach_preprocessing_as_one_shape(models, prep,
                                                        monkeypatch):
    """Ragged chunks pad to the 16-frame bucket by repeating their last
    frame: preprocessing sees one shape, and the padded frames are the
    last real one."""
    seen = []
    real = streaming.preprocess_frames

    def spy(det, ert, frames, cfg):
        seen.append(frames.clone())
        return real(det, ert, frames, cfg)

    monkeypatch.setattr(streaming, "preprocess_frames", spy)
    m, p = models["bigru"], prep["port"]
    st = streaming.StreamingTranscriber(m["model"], m["cfg"], p["det"],
                                        p["ert"], window=32, decode_every=64,
                                        chunk_bucket=16)
    frames = make_clip(0).frames
    lo = 0
    for n in (3, 7, 1, 11, 5, 2, 13):
        st.feed(frames[lo:lo + n])
        assert (seen[-1][n:] == seen[-1][n - 1]).all()
        np.testing.assert_array_equal(seen[-1][:n].numpy(),
                                      frames[lo:lo + n])
        lo += n
    assert {tuple(f.shape) for f in seen} == {(16,) + frames.shape[1:]}
    assert len(st._buf) == lo


def test_refuses_a_model_without_a_ctc_head(models, prep):
    m, p = models["hybrid"], prep["port"]
    with pytest.raises(ValueError, match="CTC head"):
        streaming.StreamingTranscriber(
            m["model"], m["cfg"].override(decoder="attention"), p["det"],
            p["ert"])
    with pytest.raises(ValueError, match="presence"):
        streaming.StreamingTranscriber(m["model"], m["cfg"], p["det"],
                                       p["ert"], tracked=True)
