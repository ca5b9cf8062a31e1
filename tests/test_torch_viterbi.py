"""``ops.ctc.ctc_viterbi_align`` against the JAX package's on the CPU, and
the streaming transcriber's beam-commit machinery (the CTC prefix beam's
hypothesis, its specials stripped, forced back onto the frames).

Tolerances: the paths exact (int ids, frame for frame); the brute-force
score within 1e-4 nats, as the JAX package's own test holds it."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.ops.ctc import ctc_viterbi_align as j_align
from lipreading_tpu_torch.ops.ctc import ctc_viterbi_align
from lipreading_tpu_torch.ops.joint_decode import ctc_prefix_beam_device
from lipreading_tpu_torch.text import Vocab
from tests.test_torch_helpers import file_hang_guard  # noqa: F401

pytestmark = pytest.mark.usefixtures("file_hang_guard")


def _logp(rng, shape, scale=2.0):
    x = rng.normal(0, scale, shape).astype(np.float32)
    return np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


def _both(logp, labels, in_len, lab_len, blank=0):
    want = np.asarray(j_align(jnp.asarray(logp), jnp.asarray(labels),
                              jnp.asarray(in_len), jnp.asarray(lab_len),
                              blank=blank))
    got = ctc_viterbi_align(torch.from_numpy(logp), torch.from_numpy(labels),
                            torch.from_numpy(in_len),
                            torch.from_numpy(lab_len), blank=blank)
    assert got.dtype == torch.int32 and got.shape == logp.shape[:2]
    return got.numpy(), want


def _collapse(row):
    out = [row[0]] + [c for i, c in enumerate(row[1:]) if c != row[i]]
    return [int(c) for c in out if c != 0]


# (B, T, V, L, input lengths, label lengths, forced labels or None)
CASES = {
    "ragged": (3, 12, 8, 4, [12, 10, 9], [4, 3, 2], None),
    "repeated_labels": (2, 10, 6, 4, [10, 8], [4, 3],
                        [[3, 3, 5, 5], [2, 2, 2, 0]]),
    "label_length_0": (3, 7, 5, 3, [7, 5, 0], [0, 2, 0], None),
    "input_lt_T": (2, 16, 31, 5, [9, 3], [5, 2], None),
    "infeasible": (2, 5, 6, 4, [3, 5], [4, 4], [[1, 1, 1, 1], [2, 3, 2, 3]]),
    "T_1": (2, 1, 4, 2, [1, 0], [1, 0], None),
    "stream_shape": (1, 64, 31, 48, [40], [11], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_viterbi_align_matches_jax(case, seed):
    B, T, V, L, in_len, lab_len, forced = CASES[case]
    rng = np.random.default_rng(seed)
    logp = _logp(rng, (B, T, V))
    labels = (np.asarray(forced, np.int32) if forced is not None
              else rng.integers(1, V, (B, L)).astype(np.int32))
    got, want = _both(logp, labels, np.asarray(in_len, np.int32),
                      np.asarray(lab_len, np.int32))
    np.testing.assert_array_equal(got, want)


def test_viterbi_align_ties_break_as_jax():
    """Equal log-probs everywhere: every choice is a tie, so the path is
    set by the tie rules alone (stay over move over skip; the last state
    over the one before it)."""
    B, T, V = 2, 9, 5
    logp = np.full((B, T, V), -np.log(V), np.float32)
    labels = np.asarray([[1, 2, 2], [3, 4, 0]], np.int32)
    got, want = _both(logp, labels, np.asarray([9, 7], np.int32),
                      np.asarray([3, 2], np.int32))
    np.testing.assert_array_equal(got, want)


def test_viterbi_align_nonzero_blank_matches_jax():
    rng = np.random.default_rng(5)
    logp = _logp(rng, (2, 10, 6))
    labels = np.asarray([[0, 1, 1], [2, 0, 4]], np.int32)
    got, want = _both(logp, labels, np.asarray([10, 8], np.int32),
                      np.asarray([3, 3], np.int32), blank=5)
    np.testing.assert_array_equal(got, want)


def test_viterbi_align_collapses_to_labels():
    """tests/test_ctc.py's property on the port: a feasible forced
    alignment collapses to exactly its labels; frames past the input
    length emit blank."""
    rng = np.random.default_rng(7)
    B, T, V, L = 3, 12, 8, 4
    logp = _logp(rng, (B, T, V))
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    in_len = np.asarray([12, 10, 9], np.int32)
    lab_len = np.asarray([4, 3, 2], np.int32)
    path = ctc_viterbi_align(torch.from_numpy(logp), torch.from_numpy(labels),
                             torch.from_numpy(in_len),
                             torch.from_numpy(lab_len)).numpy()
    for b in range(B):
        assert _collapse(path[b, :in_len[b]]) == list(labels[b, :lab_len[b]])
        assert (path[b, in_len[b]:] == 0).all()


def test_viterbi_align_matches_bruteforce_score():
    """tests/test_ctc.py's property on the port: the path scores as the
    best of every feasible alignment, by exhaustive enumeration."""
    rng = np.random.default_rng(3)
    T, V = 6, 5
    labels = [2, 4]
    logp = _logp(rng, (1, T, V), scale=1.5)
    best = -1e30
    for path in itertools.product(range(V), repeat=T):
        if _collapse(list(path)) == labels:
            best = max(best, sum(logp[0, t, path[t]] for t in range(T)))
    got = ctc_viterbi_align(torch.from_numpy(logp),
                            torch.tensor([labels], dtype=torch.int32),
                            torch.tensor([T]), torch.tensor([2]))[0].numpy()
    got_score = sum(logp[0, t, got[t]] for t in range(T))
    assert got_score == pytest.approx(best, abs=1e-4)


def test_beam_commit_path_attributes_beam_text():
    """tests/test_streaming.py's case on the port's prefix beam: where the
    per-frame argmax collapses to "" but the beam reads "a", the beam's
    labels, stripped and sorted as the streaming transcriber does, align
    to a path that collapses to "a"."""
    vocab = Vocab()
    V = vocab.size
    a = int(vocab.encode("a")[0])
    T = 2
    p = np.full((1, T, V), 1e-9, np.float32)
    p[0, :, vocab.blank_id] = 0.40
    p[0, :, a] = 0.35
    p /= p.sum(-1, keepdims=True)
    lp = torch.from_numpy(np.log(p))
    lengths = torch.tensor([T], dtype=torch.int32)
    assert vocab.decode_ctc_greedy(torch.argmax(lp, -1)[0].numpy()) == ""

    ids, n = ctc_prefix_beam_device(lp, lengths, beam=4, max_len=4,
                                    blank=vocab.blank_id, sos=vocab.sos_id,
                                    eos=vocab.eos_id)
    assert vocab.decode(ids[0, :int(n[0])].numpy()) == "a"
    pos = torch.arange(ids.shape[1])[None, :]
    keep = ((ids != vocab.blank_id) & (ids != vocab.sos_id)
            & (ids != vocab.eos_id) & (pos < n[:, None]))
    order = torch.argsort((~keep).int(), dim=1, stable=True)
    labels = torch.gather(ids, 1, order)
    path = ctc_viterbi_align(lp, labels, lengths, keep.sum(1),
                             blank=vocab.blank_id)[0].numpy()
    assert vocab.decode_ctc_greedy(path) == "a"
    want = np.asarray(j_align(jnp.asarray(lp.numpy()),
                              jnp.asarray(labels.numpy()),
                              jnp.asarray(lengths.numpy()),
                              jnp.asarray(keep.sum(1).numpy())))[0]
    np.testing.assert_array_equal(path, want)
