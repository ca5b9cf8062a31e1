"""The port's tracking pieces against the JAX package on the CPU:
``ops.tracking.track_boxes`` and ``compact_valid_frames``, the detector's
``presence_logits`` and ``decode_boxes_topk``, and the robustness fixtures
(``render_faceless_frames``, ``blank_out_frames``, ``paste_second_face``).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: tracking, compaction and the fixtures exact (selection and
copies, no arithmetic that rounds apart); ``presence_logits`` 1e-4 (two
float32 products summed in another order); ``decode_boxes_topk``'s cell
indices exact and its boxes 1e-3 px (a few float32 ulps of exp and sigmoid
at ~100 px, as ``detect``'s test holds)."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu import fixtures as jfix
from lipreading_tpu.ops import detector as jdet
from lipreading_tpu.ops import tracking as jtrk
from lipreading_tpu_torch import fixtures as tfix
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.ops import detector as tdet
from lipreading_tpu_torch.ops import tracking as ttrk
from tests.test_torch_helpers import file_hang_guard  # noqa: F401

pytestmark = pytest.mark.usefixtures("file_hang_guard")


def _t(a):
    return torch.from_numpy(np.array(a))


def _candidates(seed, B, T, K, ties):
    """Seeded candidates [B, T, K, 3] and confidences [B, T, K]. With
    ``ties``, confidences come from a few levels (equal maxima within a
    frame) and boxes from an integer grid (equal distances to the track)."""
    rng = np.random.default_rng(seed)
    if ties:
        xy = rng.integers(0, 6, size=(B, T, K, 2)).astype(np.float32) * 4.0
        size = np.full((B, T, K, 1), 20.0, np.float32)
        conf = rng.choice(np.float32([0.1, 0.5, 0.7, 0.9]), size=(B, T, K))
    else:
        xy = rng.uniform(0, 120, size=(B, T, K, 2)).astype(np.float32)
        size = rng.uniform(20, 60, size=(B, T, K, 1)).astype(np.float32)
        conf = rng.uniform(0, 1, size=(B, T, K)).astype(np.float32)
    conf[0, :3] = 0.05                 # a leading run without a face
    conf[-1, T // 2:T // 2 + 4] = 0.2  # a gap inside the clip
    return np.concatenate([xy, size], -1), conf.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_track_boxes_matches_jax(seed, ties):
    boxes, conf = _candidates(seed, 3, 17, 4, ties)
    if ties:   # the tie cases must happen
        d = np.linalg.norm(boxes[..., :2][:, 1:, :, None]
                           - boxes[..., :2][:, 1:, None, :], axis=-1)
        assert (d[..., ~np.eye(4, dtype=bool)] == 0).any()
        assert any((c == c.max()).sum() > 1 for c in conf.reshape(-1, 4))
    want, wvalid = jtrk.track_boxes(jnp.asarray(boxes), jnp.asarray(conf), 0.5)
    got, valid = ttrk.track_boxes(_t(boxes), _t(conf), 0.5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not valid[0, :3].any() and valid.dtype == torch.bool


@pytest.mark.parametrize("live", [False, True])
def test_track_boxes_state_matches_jax(live):
    """``init_state`` and ``return_state`` chain two chunks as one clip."""
    boxes, conf = _candidates(3, 2, 12, 3, False)
    init = (np.asarray([live, False]),
            np.asarray([[30, 40, 25], [0, 0, 0]], np.float32))
    want = jtrk.track_boxes(jnp.asarray(boxes), jnp.asarray(conf), 0.5,
                            init_state=tuple(map(jnp.asarray, init)),
                            return_state=True)
    got = ttrk.track_boxes(_t(boxes), _t(conf), 0.5,
                           init_state=tuple(map(_t, init)), return_state=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a chunk chained from the state of the first half equals the whole
    half = ttrk.track_boxes(_t(boxes[:, :6]), _t(conf[:, :6]), 0.5,
                            return_state=True)
    rest = ttrk.track_boxes(_t(boxes[:, 6:]), _t(conf[:, 6:]), 0.5,
                            init_state=half[2])
    whole = ttrk.track_boxes(_t(boxes), _t(conf), 0.5)
    np.testing.assert_array_equal(rest[1].numpy(), whole[1][:, 6:].numpy())


def test_track_boxes_cases_of_the_jax_tests():
    """The carried gap, the back-filled lead and the nearer of two faces."""
    boxes = np.zeros((1, 6, 2, 3), np.float32)
    conf = np.full((1, 6, 2), 0.01, np.float32)
    for t in range(6):
        boxes[0, t, 0] = [10.0 + t, 12.0, 40.0]
        conf[0, t, 0] = 0.95
    conf[0, 2:4] = 0.01
    boxes[0, 2, 0] = [140, 140, 10]
    got, valid = ttrk.track_boxes(_t(boxes), _t(conf), 0.5)
    assert valid[0].tolist() == [True, True, False, False, True, True]
    np.testing.assert_array_equal(got[0, 2].numpy(), [11, 12, 40])
    np.testing.assert_array_equal(got[0, 4].numpy(), [14, 12, 40])

    lead = np.tile(np.float32([20, 20, 30]), (1, 4, 1, 1))
    lead[0, 2, 0] = [25, 25, 32]
    got, valid = ttrk.track_boxes(
        _t(lead), _t(np.float32([[[0.01], [0.01], [0.9], [0.9]]])), 0.5)
    assert valid[0].tolist() == [False, False, True, True]
    np.testing.assert_array_equal(got[0, :2].numpy(), [[25, 25, 32]] * 2)

    two = np.zeros((1, 3, 2, 3), np.float32)
    c2 = np.zeros((1, 3, 2), np.float32)
    two[0, 0] = [[10, 10, 40], [100, 100, 30]]
    c2[0, 0] = [0.9, 0.2]
    for t in (1, 2):
        two[0, t] = [[100, 100, 30], [11 + t, 10, 40]]
        c2[0, t] = [0.99, 0.8]
    got, _ = ttrk.track_boxes(_t(two), _t(c2), 0.5)
    np.testing.assert_array_equal(got[0, 1:].numpy(), [[12, 10, 40],
                                                       [13, 10, 40]])


@pytest.mark.parametrize("trail", [(), (5,), (2, 3)])
def test_compact_valid_frames_matches_jax(trail):
    rng = np.random.default_rng(len(trail))
    B, T = 4, 11
    x = rng.normal(size=(B, T) + trail).astype(np.float32)
    valid = rng.uniform(size=(B, T)) > 0.4
    valid[0] = True
    valid[1] = False
    lengths = np.asarray([T, 7, 0, 9], np.int32)
    wx, wl = jtrk.compact_valid_frames(jnp.asarray(x), jnp.asarray(valid),
                                       jnp.asarray(lengths))
    gx, gl = ttrk.compact_valid_frames(_t(x), _t(valid), _t(lengths))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert gl.dtype == torch.int32


@pytest.fixture(scope="module")
def presence():
    return tio.load_presence()


def test_presence_logits_matches_jax(presence):
    rng = np.random.default_rng(7)
    feats = np.maximum(rng.normal(0, 1.5, size=(5, 8, 8, 32)), 0).astype(
        np.float32)
    want = np.asarray(jdet.presence_logits(
        {k: jnp.asarray(v) for k, v in presence.items()}, jnp.asarray(feats)))
    got = tdet.presence_logits(tdet.params_to_torch(presence, "cpu"),
                               _t(feats))
    assert got.shape == (5, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_scores", [False, True])
def test_decode_boxes_topk_matches_jax(with_scores):
    """A head with tied scores: lax.top_k's order (the lower cell first)."""
    rng = np.random.default_rng(11)
    head = rng.normal(0, 1, size=(6, 8, 8, 4)).astype(np.float32)
    head[..., 0] = rng.integers(0, 3, size=(6, 8, 8))      # many ties
    scores = (rng.integers(0, 2, size=(6, 8, 8)).astype(np.float32)
              if with_scores else None)
    wb, ws = jdet.decode_boxes_topk(
        jnp.asarray(head), 160, 120, 5,
        None if scores is None else jnp.asarray(scores))
    gb, gs = tdet.decode_boxes_topk(_t(head), 160, 120, 5,
                                    None if scores is None else _t(scores))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-3)
    # the cells themselves: their decoded offsets tell them apart
    s = (head[..., 0] if scores is None else scores).reshape(6, 64)
    order = np.argsort(-s, axis=1, kind="stable")[:, :5]
    cx = (order % 8 + 1 / (1 + np.exp(-np.take_along_axis(
        head.reshape(6, 64, 4)[..., 1], order, 1)))) * 8 * 120 / 64
    size = gb[..., 2].numpy()
    np.testing.assert_allclose(gb[..., 0].numpy() + size / 2, cx, atol=1e-3)


def test_fixture_copies_are_byte_equal():
    np.testing.assert_array_equal(tfix.render_faceless_frames(7, 6),
                                  jfix.render_faceless_frames(7, 6))
    np.testing.assert_array_equal(
        tfix.render_faceless_frames(3, 2, variation=0.6),
        jfix.render_faceless_frames(3, 2, variation=0.6))
    np.testing.assert_array_equal(
        tfix.blank_out_frames(tfix.make_clip(61), [4, 5, 6], seed=2),
        jfix.blank_out_frames(jfix.make_clip(61), [4, 5, 6], seed=2))
    np.testing.assert_array_equal(
        tfix.paste_second_face(tfix.make_clip(62), donor_seed=901),
        jfix.paste_second_face(jfix.make_clip(62), donor_seed=901))
    for seed in (100, 101, 5501, 6602):
        assert tfix.clip_text(seed) == jfix.make_clip(seed).text
