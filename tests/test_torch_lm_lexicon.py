"""The port's copies of the char LM (``lm.py``), the lexicon DFA
(``lexicon.py``) and the numpy CTC prefix beam (``ops/ctc_beam.py``)
against the JAX package's, on the CPU.

Tolerance: none. The numpy code is the same code, so tables, scores and
labelings are compared for equality; the context indices are integers."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu import lexicon as jlex
from lipreading_tpu import lm as jlm
from lipreading_tpu.fixtures import sample_text as j_sample_text
from lipreading_tpu.ops import ctc_beam as jbeam
from lipreading_tpu_torch import infer
from lipreading_tpu_torch import lexicon as tlex
from lipreading_tpu_torch import lm as tlm
from lipreading_tpu_torch.fixtures import LEXICON, sample_text
from lipreading_tpu_torch.io import ASSETS_DIR
from lipreading_tpu_torch.ops import ctc_beam as tbeam
from lipreading_tpu_torch.text import Vocab

TEXTS = ["the way they write", "how had this", "their time will"]


def _fixture_texts():
    """Transcripts as the fixture corpus draws them (without rendering)."""
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    texts = [sample_text(rng) for _ in range(12)]
    assert texts == [j_sample_text(jrng) for _ in range(12)]
    return texts


@pytest.mark.parametrize("order", [2, 4])
def test_train_char_lm_matches_jax(order):
    texts = _fixture_texts()
    want = jlm.train_char_lm(texts, order=order)
    got = tlm.train_char_lm(texts, order=order)
    np.testing.assert_array_equal(got, want)
    assert tlm.lm_perplexity(got, order, TEXTS) == \
        jlm.lm_perplexity(want, order, TEXTS)


def test_shipped_lm_loads_and_scores_as_jax(tmp_path):
    table, order = tlm.load_lm(os.path.join(ASSETS_DIR, "char_lm.npz"))
    jt, jo = jlm.load_lm(os.path.join(ASSETS_DIR, "char_lm.npz"))
    assert table.shape == (31 ** 3, 31) and table.dtype == np.float32
    assert order == jo == 4
    np.testing.assert_array_equal(table, jt)
    for t in TEXTS + ["tht", "", "xqz zzq"]:
        assert tlm.lm_nll_per_char(table, order, t) == \
            jlm.lm_nll_per_char(jt, jo, t)
    # save_lm / load_lm round trip, and the device cache of the serving path
    path = str(tmp_path / "lm.npz")
    tlm.save_lm(table[:31], path, order=2)
    back, o2 = jlm.load_lm(path)
    np.testing.assert_array_equal(back, table[:31])
    assert o2 == 2
    dev_table, dev_order = infer.load_char_lm("cpu")
    assert dev_order == order and infer.load_char_lm("cpu")[0] is dev_table
    np.testing.assert_array_equal(dev_table.numpy(), table)


@pytest.mark.parametrize("order", [2, 4])
def test_context_indices_match_jax(order):
    rng = np.random.default_rng(order)
    V = Vocab().size
    got = tlm.initial_context(5, order, device="cpu")
    want = jlm.initial_context(5, order)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for _ in range(7):
        tok = rng.integers(0, V, 5).astype(np.int32)
        got = tlm.advance_context(got, torch.from_numpy(tok), order, V)
        want = jlm.advance_context(want, jnp.asarray(tok), order, V)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < V ** (order - 1)


@pytest.mark.parametrize("counts", [None, {"the": 9, "way": 3}])
def test_lexicon_tables_match_jax(counts):
    words = list(LEXICON) if counts is None else ["the", "they", "way", "w"]
    want = jlex.build_lexicon(words, counts)
    got = tlex.build_lexicon(words, counts)
    assert got.keys() == want.keys() == {"next_state", "bonus"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    fix = tlex.fixture_lexicon()
    for k, v in jlex.fixture_lexicon().items():
        np.testing.assert_array_equal(fix[k], v)
    dev = tlex.to_torch(fix, "cpu")
    assert dev["next_state"].dtype == torch.int32
    np.testing.assert_array_equal(dev["bonus"].numpy(), fix["bonus"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_prefix_beam_matches_jax_copy(seed):
    rng = np.random.default_rng(seed)
    T, V = 9, 6
    lp = rng.normal(0, 1.5, (T, V)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    for width, prune in ((4, 16), (16, 3)):
        assert tbeam.ctc_prefix_beam_search(lp, width, prune_topk=prune) == \
            jbeam.ctc_prefix_beam_search(lp, width, prune_topk=prune)
    batch = np.stack([lp, lp[::-1]])
    lens = np.asarray([T, 5])
    assert tbeam.ctc_beam_decode_batch(batch, lens, 4) == \
        jbeam.ctc_beam_decode_batch(batch, lens, 4)
    assert tbeam.ctc_brute_force_best(lp[:4, :3]) == \
        jbeam.ctc_brute_force_best(lp[:4, :3])
