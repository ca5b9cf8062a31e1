"""The port's preprocessor training (``lipreading_tpu_torch.preproc_training``
and ``oracle.ert_train``) against the JAX package's on the CPU, at small
sizes: one short fixture clip, batch 8, 3 steps.

Tolerances, each with its reason:
* ``_collect_frames``, ``detector_targets``, ERT boosting and its
  ``landmark_error``: exact (the same numpy code on the same bytes);
* the detector after 3 steps and the presence head after 3 steps from
  JAX's draw: every weight within 1e-5 absolute. Both run float32
  convolutions and products summed in other orders (~1e-7 on a gradient);
  Adam's first steps move a weight by ~lr whatever the gradient's size,
  so a rounding shows only where a gradient is near 0;
* the conv landmarker after 3 steps, ``roi_loss_weight`` 0 and 1: every
  weight within 1e-6, and the 3 updates together (weights minus their
  start) within 1e-3 of JAX's relative to their norm. The warmup schedule
  gives lr 0, 2e-5 and 4e-5, so the weights themselves barely move;
* the ROI term's gradient with respect to the landmarks: 1e-4 relative to
  its largest entry, at landmarks that reach the frame's edge and a box
  whose taps sit on the clamps' bounds (float32 products in other orders);
* the gate metrics from the shipped ``landmarker_conv.npz``: the px error
  within 1e-5 relative (float32 landmarks one ulp apart), the rounded-box
  agreement exact;
* the plain Adam against ``optax.adam``: rtol 1e-6 / atol 1e-8
  (elementwise float32 that may round one ulp apart);
* ``sigmoid_bce`` against optax's: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lipreading_tpu import metrics as jmetrics
from lipreading_tpu import preproc_training as jpt
from lipreading_tpu.fixtures import make_clip as jmake_clip
from lipreading_tpu.oracle import detector as jodet
from lipreading_tpu.oracle import ert_train as jert_train
from lipreading_tpu.oracle.ert import ERTModel as JERTModel
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch import metrics as tmetrics
from lipreading_tpu_torch import preproc_training as tpt
from lipreading_tpu_torch.config import TrainConfig
from lipreading_tpu_torch.fixtures import make_clip
from lipreading_tpu_torch.oracle import detector as todet
from lipreading_tpu_torch.oracle import ert_train as tert_train
from lipreading_tpu_torch.train.optim import Adam
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_helpers import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

CLIP = 7            # a short fixture clip (64 frames)
CPU = "cpu"


@pytest.fixture(scope="module")
def clips():
    return [make_clip(CLIP)], [jmake_clip(CLIP)]


@pytest.fixture(scope="module")
def frames(clips):
    return tpt._collect_frames(clips[0])


@pytest.fixture(scope="module")
def shipped():
    det, ert = tio.load_assets()
    return det, ert, tio.load_landmarker()


def _max_abs(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in a)


def test_collect_frames_and_detector_targets_equal(clips, frames):
    want = jpt._collect_frames(clips[1], stride=3)
    got = tpt._collect_frames(clips[0], stride=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    gray, boxes, _ = frames
    for g, w in zip(tpt.detector_targets(boxes, *gray.shape[1:]),
                    jpt.detector_targets(boxes, *gray.shape[1:])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_init_draws_equal():
    from lipreading_tpu.ops import landmarker as jlmk
    from lipreading_tpu_torch.ops import landmarker as tlmk

    for seed in (0, 3):
        a, b = todet.init_detector(seed), jodet.init_detector(seed)
        assert _max_abs(a, b) == 0.0
        ms = np.random.default_rng(seed).uniform(0, 1, (68, 2))
        for width in (1.0, 0.5):
            a = tlmk.init_landmarker(seed, ms, width)
            b = jlmk.init_landmarker(seed, ms, width)
            assert _max_abs(a, b) == 0.0


def test_sigmoid_bce_is_optax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 6, (257,)).astype(np.float32)
    y = (rng.uniform(size=257) < 0.3).astype(np.float32)
    got = tpt.sigmoid_bce(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(optax.sigmoid_binary_cross_entropy(x, y))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("schedule", [False, True])
def test_plain_adam_three_steps_match_optax(schedule):
    """A constant lr, and the landmarker's warmup-cosine schedule (lr 0 at
    the first update), over a flat dict of tensors."""
    rng = np.random.default_rng(1)
    start = {"a/w": rng.normal(0, 0.3, (6, 5)).astype(np.float32),
             "a/b": np.zeros(5, np.float32),
             "c": np.float32(0.7) * np.ones((), np.float32)}
    lr = 2e-3
    if schedule:
        sched = optax.warmup_cosine_decay_schedule(0.0, lr, 100, 101,
                                                   lr * 0.05)
        tx = optax.adam(sched)
        opt_lr = TrainConfig(learning_rate=lr, warmup_steps=100,
                             total_steps=101)
    else:
        tx, opt_lr = optax.adam(lr), lr
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in start.items()}
    opt = Adam(tp, opt_lr)
    for step, scale in enumerate((1.0, 1e-3, 5.0)):
        g = {k: np.asarray(rng.normal(0, 1, np.shape(v)) * scale, np.float32)
             for k, v in start.items()}
        g["a/b"][0] = 0.0                           # a zero gradient
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.update()
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                              state, jp)
        jp = optax.apply_updates(jp, up)
        for k in start:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-8, err_msg=f"{step} {k}")
            assert tp[k].grad is None
    assert opt.count == 3


def test_train_detector_three_steps_match_jax(frames):
    gray, boxes, _ = frames
    want = jpt.train_detector(gray, boxes, seed=2, steps=3, batch=8)
    got = tpt.train_detector(gray, boxes, seed=2, steps=3, batch=8,
                             device=CPU)
    start = todet.init_detector(2)
    assert _max_abs(want, start) > 1e-3          # the steps moved it
    assert _max_abs(got, want) <= 1e-5


DEAD_CONV1_SEED = 15364    # init_detector's conv1: every channel's taps sum
                           # > 0, on every window the padding cuts too


def test_train_detector_where_units_see_zero_matches_jax(frames):
    """On black frames (normalised to exactly -1) every conv1 unit of
    ``init_detector(DEAD_CONV1_SEED)`` is negative, so every conv2 and conv3
    unit of the zero-bias start sees exactly 0. JAX's ``maximum(x, 0)``
    passes half the gradient there (``torch.relu`` would pass none, and
    conv2's and conv3's biases would not move)."""
    gray, boxes, _ = frames
    black = np.zeros((4,) + gray.shape[1:], np.float32)
    kw = dict(seed=DEAD_CONV1_SEED, steps=2, batch=4)
    want = jpt.train_detector(black, boxes[:4], **kw)
    got = tpt.train_detector(black, boxes[:4], device=CPU, **kw)
    assert np.abs(want["conv2/b"]).min() > 1e-3
    assert _max_abs(got, want) <= 1e-5


def test_detector_box_error_matches_jax(shipped, frames):
    gray, boxes, _ = frames
    want = jpt.detector_box_error(shipped[0], gray, boxes)
    got = tpt.detector_box_error(shipped[0], gray, boxes, device=CPU)
    assert got == pytest.approx(want, rel=1e-5)


def _jax_presence_init(seed: int, C: int) -> dict:
    """``train_presence_head``'s draw from ``jax.random.PRNGKey(seed)``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    Hd = 16
    return {"w1": np.asarray(jax.random.normal(k1, (C, Hd)) * np.sqrt(2.0 / C)),
            "b1": np.zeros((Hd,), np.float32),
            "w2": np.asarray(jax.random.normal(k2, (Hd,)) * np.sqrt(1.0 / Hd)),
            "b2": np.zeros((), np.float32)}


def test_fit_presence_head_from_jax_draw_matches_jax(shipped, frames):
    from lipreading_tpu.fixtures import render_faceless_frames
    from lipreading_tpu.oracle.roi import grayscale

    gray, boxes, _ = frames
    neg = np.stack([grayscale(f) for f in render_faceless_frames(5, 6)])
    want = jpt.train_presence_head(shipped[0], gray, neg, boxes, seed=4,
                                   steps=3)
    feats, y = tpt.presence_features(shipped[0], gray, neg, boxes, CPU)
    init = _jax_presence_init(4, feats.shape[-1])
    assert _max_abs(want, init) > 1e-2           # 3 steps at lr 5e-2
    got = tpt.fit_presence_head(init, feats, y, steps=3)
    assert _max_abs(got, want) <= 1e-5
    # the port's own draw: the torch generator's, the same on every call
    own = tpt.init_presence_head(feats.shape[-1], 4)
    assert _max_abs(own, tpt.init_presence_head(feats.shape[-1], 4)) == 0
    assert {k: v.shape for k, v in own.items()} == {
        k: v.shape for k, v in init.items()}


def _rel_update(got: dict, want: dict, start: dict) -> float:
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float(((want[k] - start[k]) ** 2).sum()) for k in want)
    return float(np.sqrt(num / den))


@pytest.mark.parametrize("roi_loss_weight", [0.0, 1.0])
def test_train_conv_landmarker_three_steps_match_jax(shipped, clips,
                                                     roi_loss_weight):
    det, ert, _ = shipped
    jdet, jert = jpt.load_assets()
    kw = dict(seed=1, steps=3, batch=8, verbose=False,
              roi_loss_weight=roi_loss_weight)
    want = jpt.train_conv_landmarker(jdet, jert, clips[1], **kw)
    got = tpt.train_conv_landmarker(det, ert, clips[0], device=CPU, **kw)
    targets = tpt.teacher_pass(det, ert, tpt._collect_frames(
        clips[0], stride=1)[0], CPU)[1]
    from lipreading_tpu_torch.ops.landmarker import init_landmarker

    start = init_landmarker(1, mean_shape=targets.mean(axis=0))
    assert _max_abs(got, want) <= 1e-6
    assert _rel_update(got, want, start) <= 1e-3


def test_roi_term_gradient_at_the_clamps_matches_jax():
    """The ROI term's gradient with respect to the landmarks where the mouth
    reaches past the frame's edges (the taps clamp into the frame), and the
    sampler's gradient with respect to float boxes whose taps sit exactly
    on the clamps' bounds (origin 0 and size R: the first tap at 0 and the
    last at size - 1; a box flush with the far edge: the last tap at
    W - 1), where JAX splits the gradient between the two sides."""
    from lipreading_tpu.ops.preprocess import mouth_boxes_float as jboxes
    from lipreading_tpu.ops.roi import sample_rois_xla
    from lipreading_tpu_torch.ops.roi import sample_rois_reference

    rng = np.random.default_rng(3)
    B, H, W, R = 3, 40, 48, 16
    gray = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    lm = rng.uniform(0.2, 0.8, (B, 68, 2)).astype(np.float32)
    lm[0, 48:68] += np.float32(0.5)                # past the right/bottom edge
    lm[1, 48:68] -= np.float32(0.6)                # past the left/top edge
    org = np.asarray([[10, 8], [0, 0], [4, 2]], np.float32)
    sz = np.asarray([36, 30, 28], np.float32)
    wts = rng.normal(size=(B, R, R)).astype(np.float32)

    def jax_loss(lm_):
        fl = lm_ * sz[:, None, None] + org[:, None, :]
        rois = sample_rois_xla(jnp.asarray(gray), jboxes(fl, 0.30), R,
                               subpixel=True)
        return (rois * wts).sum()

    jg = np.asarray(jax.grad(jax_loss)(jnp.asarray(lm)))
    lt = torch.tensor(lm, requires_grad=True)
    loss = (tpt.roi_term_rois(lt, torch.from_numpy(gray),
                              torch.from_numpy(org), torch.from_numpy(sz),
                              0.30, R) * torch.from_numpy(wts)).sum()
    loss.backward()
    assert loss.item() == pytest.approx(float(jax_loss(jnp.asarray(lm))),
                                        rel=1e-5)
    assert np.abs(jg[:, 48:68]).max() > 0
    np.testing.assert_allclose(lt.grad.numpy(), jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())

    boxes = np.asarray([[0, 0, R], [W - R, H - R, R], [3.25, 5.5, 20.5]],
                       np.float32)

    def jax_box_loss(b):
        return (sample_rois_xla(jnp.asarray(gray), b, R, subpixel=True)
                * wts).sum()

    jb = np.asarray(jax.grad(jax_box_loss)(jnp.asarray(boxes)))
    bt = torch.tensor(boxes, requires_grad=True)
    (sample_rois_reference(torch.from_numpy(gray), bt, R, subpixel=True)
     * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(bt.grad.numpy(), jb, rtol=0,
                               atol=1e-4 * np.abs(jb).max())


def test_mouth_box_gradients_split_ties_as_jax():
    """``_mouth_box`` (and ``mouth_boxes_float``) where mouth points tie for
    the min or the max: JAX's reductions split the gradient evenly over the
    tied points, as ``amin``/``amax`` do (``min(dim)`` would send it all to
    one). The JAX side is the trainer's own ``_mouth_box`` formula
    (``lipreading_tpu/preproc_training.py``) and ``mouth_boxes_float``."""
    from lipreading_tpu.ops.preprocess import mouth_boxes_float as jboxes
    from lipreading_tpu_torch.ops.preprocess import mouth_boxes_float

    rng = np.random.default_rng(4)
    lm = rng.uniform(0.3, 0.7, (2, 68, 2)).astype(np.float32)
    lm[:, 50:53, 0] = lm[:, 48:68, 0].min(axis=1)[:, None]   # tied minima
    lm[:, 60:62, 1] = lm[:, 48:68, 1].max(axis=1)[:, None]   # tied maxima
    lm[0, 55, 0] = lm[0, 48:68, 0].max()
    wts = rng.normal(size=(2, 3)).astype(np.float32)

    def jax_mouth_box(x, margin=0.30):
        pts = x[:, 48:68]
        mn, mx = pts.min(axis=1), pts.max(axis=1)
        size = (mx - mn).max(axis=-1) * (1.0 + margin)
        return jnp.concatenate([(mn + mx) / 2.0, size[:, None]], axis=-1)

    for jfn, tfn in ((jax_mouth_box, tpt._mouth_box),
                     (lambda x: jboxes(x, 0.30),
                      lambda x: mouth_boxes_float(x, 0.30))):
        jg = np.asarray(jax.grad(lambda x: (jfn(x) * wts).sum())(
            jnp.asarray(lm)))
        lt = torch.tensor(lm, requires_grad=True)
        (tfn(lt) * torch.from_numpy(wts)).sum().backward()
        assert (np.abs(jg[:, 50:53, 0]) > 0).all()
        np.testing.assert_allclose(lt.grad.numpy(), jg, rtol=1e-6,
                                   atol=1e-7)


def test_ert_boosting_byte_equal_and_landmark_error(frames):
    gray, boxes, lms = frames
    kw = dict(seed=5, stages=1, trees=4, depth=2, pool=32)
    got = tert_train.train_ert(gray, boxes, lms, **kw)
    want = jert_train.train_ert(gray, boxes, lms, **kw)
    for k in ("mean_shape", "anchors", "offsets", "feat1", "feat2", "thresh",
              "leaves"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    assert (tert_train.landmark_error(got, gray, boxes, lms)
            == jert_train.landmark_error(want, gray, boxes, lms))


def test_gate_metrics_from_the_shipped_landmarker_match_jax(shipped, clips):
    det, ert, lm = shipped
    jdet, jert = jpt.load_assets()
    jlm = jpt.load_landmarker()
    want = jpt.conv_landmarker_error(jlm, jdet, jert, clips[1])
    got = tpt.conv_landmarker_error(lm, det, ert, clips[0], device=CPU)
    assert got == pytest.approx(want, rel=1e-5)
    assert (tpt.conv_box_agreement(lm, det, ert, clips[0], device=CPU)
            == jpt.conv_box_agreement(jlm, jdet, jert, clips[1]))


def test_npz_files_read_across_both_packages(tmp_path, shipped, frames):
    """What each package writes, the other's loaders read, array for array."""
    det, ert, lm = shipped
    gray, boxes, lms = frames
    model = tert_train.train_ert(gray, boxes, lms, stages=1, trees=2,
                                 depth=2, pool=16)
    head = tpt.init_presence_head(32, 0)
    for side, d in (("port", tmp_path / "port"), ("jax", tmp_path / "jax")):
        d.mkdir()
        if side == "port":
            todet.save_params(det, d / "detector.npz")
            model.save(d / "ert.npz")
            tpt.save_landmarker(lm, d / "landmarker_conv.npz")
            tpt.save_presence(head, d / "presence.npz")
            loaded = (*jpt.load_assets(str(d)), jpt.load_landmarker(str(d)),
                      jpt.load_presence(str(d)))
        else:
            jodet.save_params(det, d / "detector.npz")
            JERTModel(**vars(model)).save(d / "ert.npz")
            jpt.save_landmarker(lm, d / "landmarker_conv.npz")
            jpt.save_presence(head, d / "presence.npz")
            loaded = (*tio.load_assets(str(d)), tio.load_landmarker(str(d)),
                      tio.load_presence(str(d)))
        for got, want in zip(loaded, (det, model, lm, head)):
            got = got if isinstance(got, dict) else vars(got)
            want = want if isinstance(want, dict) else vars(want)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


@pytest.mark.parametrize("hyp,ref", [
    ("the cat", "the cat sat"), ("x", ""), ("", ""), ("", "a b"),
    ("bin blue at f two now", "bin blue at f two now"),
    ("set red  by", "set  red with q"), ("a b c d", "d c b a")])
def test_wer_matches_jax(hyp, ref):
    assert tmetrics.wer(hyp, ref) == jmetrics.wer(hyp, ref)
    assert tmetrics.cer(hyp, ref) == jmetrics.cer(hyp, ref)
