"""The port's incremental transformer decoder (``models/transformer.py``),
its beams (``ops/decode.py``) and the joint CTC/attention beam
(``ops/joint_decode.py``) against the JAX package on the CPU, at a small
size: weights from the JAX package's ``init_model`` carried across by
``io.from_jax_params``, inputs made with numpy from a seed.

Tolerances: ids and lengths exactly equal. Decoder logits 1e-5 in float32,
where both sides run the same operations and only summation order differs,
and 5e-2 in bfloat16, where each dense layer and the attention round to
bfloat16 at places the two frameworks do not share (as in
``test_torch_models.py``). CTC prefix scores and lattices rtol 1e-5 / atol
1e-4: the same operations in the same order (``lax.associative_scan``'s
recursion), but XLA's exp and log1p are not PyTorch's, an ulp apart, over
sums of up to a hundred terms. The hoisted cross K/V and the bf16 KV cache
are bit-identical, as in the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu import lexicon as jlex
from lipreading_tpu.config import Config as JConfig
from lipreading_tpu.config import ModelConfig as JModel
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.models import transformer as jtf
from lipreading_tpu.ops import decode as jdec
from lipreading_tpu.ops import joint_decode as jjd
from lipreading_tpu_torch import infer
from lipreading_tpu_torch.config import Config, ModelConfig
from lipreading_tpu_torch.io import from_jax_params
from lipreading_tpu_torch.lexicon import to_torch
from lipreading_tpu_torch.models import lipreader as tlr
from lipreading_tpu_torch.models import transformer as ttf
from lipreading_tpu_torch.ops import decode as tdec
from lipreading_tpu_torch.ops import joint_decode as tjd
from lipreading_tpu_torch.ops.ctc_beam import ctc_prefix_beam_search

SCORE_TOL = dict(rtol=1e-5, atol=1e-4)
V = 31                                   # the vocabulary of lexicon and LM


def _t(a):
    return torch.from_numpy(np.array(a))


def _decoder(dtype="float32", seed=0, layers=2):
    """A tiny hybrid model's attention decoder in both packages."""
    kw = dict(frontend="patchify", patch_dim=16, frontend_dim=24, tf_dim=32,
              tf_heads=2, tf_mlp=64, tf_layers=1, tf_dec_layers=layers,
              dtype=dtype)
    cfg = Config(encoder="transformer", decoder="hybrid",
                 model=ModelConfig(**kw))
    jcfg = JConfig(encoder="transformer", decoder="hybrid", model=JModel(**kw))
    tree = jax.tree_util.tree_map(
        np.asarray, jlr.init_model(jax.random.PRNGKey(seed), jcfg))
    model = tlr.LipReader(cfg)
    model.load_state_dict(from_jax_params(tree, cfg))
    return model.eval().att_decoder, tree["att_decoder"], cfg.model


def _step_inputs(seed, m, B=3, T=12, L=6):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1, (B, T, m.tf_dim)).astype(np.float32)
    lens = np.asarray([T, T - 3, 5][:B], np.int32)
    toks = rng.integers(3, m.vocab_size, (L, B)).astype(np.int32)
    return enc, lens, toks


def _run_port(p, m, enc, lens, toks, dtype, cache_dtype, hoist=True):
    enc = _t(enc).to(dtype or torch.float32)
    lens = _t(lens)
    cache = ttf.decoder_init_cache(p, enc.shape[0], toks.shape[0], m.tf_heads,
                                   cache_dtype)
    ckv = ttf.decoder_cross_kv(p, enc, m.tf_heads, dtype) if hoist else None
    outs = []
    with torch.inference_mode():
        for t in range(toks.shape[0]):
            cache, lg = ttf.decoder_step(p, cache, _t(toks[t]), enc, lens,
                                         m.tf_heads, dtype, cross_kv=ckv)
            assert lg.dtype == torch.float32
            outs.append(lg)
    return torch.stack(outs).numpy(), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_step_matches_jax(dtype):
    p, jp, m = _decoder(dtype)
    enc, lens, toks = _step_inputs(1, m)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jenc = jnp.asarray(enc).astype(jdt)
    cache = jtf.decoder_init_cache(jp, 3, toks.shape[0], m.tf_heads, jdt)
    ckv = jtf.decoder_cross_kv(jp, jenc, m.tf_heads, jdt)
    step = jax.jit(lambda c, tok: jtf.decoder_step(
        jp, c, tok, jenc, jnp.asarray(lens), m.tf_heads, jdt, cross_kv=ckv))
    want = []
    for t in range(toks.shape[0]):
        cache, lg = step(cache, jnp.asarray(toks[t]))
        want.append(np.asarray(lg))
    got, tcache = _run_port(p, m, enc, lens, toks, tdt, tdt)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=tol)
    assert tcache["pos"] == toks.shape[0]
    k = tcache["layers"][1]["k"]
    assert k.dtype == tdt and k.shape == (3, toks.shape[0], m.tf_heads, 16)
    np.testing.assert_allclose(k.float().numpy(), np.asarray(
        cache["layers"][1]["k"]).astype(np.float32), rtol=0, atol=tol)


def test_decoder_cross_kv_hoist_parity():
    """The hoisted cross-attention K/V give bit-identical logits to the
    per-step recompute (the port's counterpart of the JAX test)."""
    p, _, m = _decoder("float32", seed=7)
    enc, lens, toks = _step_inputs(8, m)
    a, _ = _run_port(p, m, enc, lens, toks, None, torch.float32, hoist=False)
    b, _ = _run_port(p, m, enc, lens, toks, None, torch.float32, hoist=True)
    np.testing.assert_array_equal(a, b)


def test_kv_cache_dtype_decode_identity():
    """A bf16 KV cache is bit-identical to a float32 one under bf16
    activations: the cache only ever holds exact bf16 values."""
    p, _, m = _decoder("bfloat16", seed=17)
    enc, lens, toks = _step_inputs(18, m, L=8)
    a, _ = _run_port(p, m, enc, lens, toks, torch.bfloat16, torch.float32)
    b, _ = _run_port(p, m, enc, lens, toks, torch.bfloat16, torch.bfloat16)
    np.testing.assert_array_equal(a, b)


def _lattice_inputs(seed, N=3, T=11, Vs=7):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (N, T, Vs)).astype(np.float32)
    lens = np.asarray([T, T - 4, 1][:N], np.int32)
    return logits, lens


def test_ctc_prefix_state_functions_match_jax():
    logits, lens = _lattice_inputs(0)
    jlp = jjd.mask_ctc_logp(jnp.asarray(logits), jnp.asarray(lens), 0)
    tlp = tjd.mask_ctc_logp(_t(logits), _t(lens), 0)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **SCORE_TOL)
    js = jjd.init_ctc_prefix_state(jlp, 0)
    ts = tjd.init_ctc_prefix_state(tlp, 0)
    for k in js:
        assert ts[k].shape == js[k].shape, k
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   **SCORE_TOL)
    # the empty prefix, then the prefix of one chosen token per sequence
    tok = np.asarray([3, 1, 5])
    for step in range(2):
        jpsi, jfull, jemit = jjd.ctc_candidate_scores(js, jlp, 0)
        tpsi, tfull, temit = tjd.ctc_candidate_scores(ts, tlp, 0)
        for got, want in ((tpsi, jpsi), (tfull, jfull), (temit, jemit)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **SCORE_TOL)
        rows = np.arange(3)
        jr = jjd.ctc_chosen_lattice(jemit[rows, :, tok], jlp[rows, :, tok],
                                    jlp[:, :, 0])
        tr = tjd.ctc_chosen_lattice(temit[rows, :, tok], tlp[rows, :, tok],
                                    tlp[:, :, 0])
        for got, want in zip(tr, jr):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **SCORE_TOL)
        js = {"r_n": jr[0], "r_b": jr[1], "psi": jpsi[rows, tok],
              "last": jnp.asarray(tok, jnp.int32),
              "empty": jnp.zeros((3,), bool)}
        ts = {"r_n": tr[0], "r_b": tr[1], "psi": tpsi[rows, tok],
              "last": _t(tok.astype(np.int32)),
              "empty": torch.zeros((3,), dtype=torch.bool)}
        tok = np.asarray([2, 3, 3])


@pytest.mark.parametrize("T", [1, 2, 3, 8, 13, 100])
def test_semiring_scan_matches_jax(T):
    rng = np.random.default_rng(T)
    a = rng.normal(-1, 1, (T, 5)).astype(np.float32)
    b = rng.normal(-2, 2, (T, 5)).astype(np.float32)
    b[::3, 1] = -1e30
    a[:, 2] = -1e30
    want = np.asarray(jjd._semiring_scan(jnp.asarray(a), jnp.asarray(b)))
    got = tjd._semiring_scan(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    # the recurrence it solves, sequentially in float64
    r = np.full(5, -np.inf)
    for t in range(T):
        r = np.logaddexp(a[t] + r, b[t].astype(np.float64))
        np.testing.assert_allclose(got[t], np.maximum(r, -1e30), rtol=1e-5,
                                   atol=1e-4)


def test_logaddexp_handles_infinities_as_jax():
    x = np.asarray([0.0, -np.inf, np.inf, -np.inf, np.nan, -1e30, 3.0],
                   np.float32)
    y = np.asarray([0.0, -np.inf, np.inf, 1.0, 1.0, -1e30, -2.0], np.float32)
    want = np.asarray(jnp.logaddexp(jnp.asarray(x), jnp.asarray(y)))
    got = tjd.logaddexp(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_top_k_breaks_ties_as_lax():
    """-1e30 + x is -1e30 in float32 for every small x: dead beams tie with
    each other and with masked candidates, and the lowest index must come
    first, as in lax.top_k."""
    x = np.full((3, 40), -1e30, np.float32)
    x[0, [5, 9, 30]] = -2.5
    x[1, :] = np.float32(-1e30) + np.float32(7.0)
    x[2, [0, 1, 2, 35]] = [1.0, 2.0, 2.0, 2.0]
    x[2, 10:20] = -1e30 + np.arange(10, dtype=np.float32)
    for k in (1, 4, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tdec.top_k(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _toy_att(seed, Vs, BW):
    """A stateful toy attention decoder: logits from the previous token."""
    table = np.random.default_rng(seed).normal(0, 1.5, (Vs, Vs)).astype(
        np.float32)
    jt, tt = jnp.asarray(table), _t(table)

    def jstep(state, toks):
        return state, jt[toks]

    def tstep(state, toks):
        return state, tt[toks.long()]

    return (jstep, {"h": jnp.zeros((BW, 1))},
            tstep, {"h": torch.zeros((BW, 1))})


def test_greedy_and_beam_search_match_jax():
    B, beam, Vs, L = 2, 4, 7, 6
    jstep, jst, tstep, tst = _toy_att(3, Vs, B)
    ji, jl = jdec.greedy_decode(jstep, jst, B, L, 1, 2)
    ti, tl = tdec.greedy_decode(tstep, tst, B, L, 1, 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    jstep, jst, tstep, tst = _toy_att(3, Vs, B * beam)
    for lp in (0.0, 0.6):
        ji, jl = jdec.beam_search(jstep, jst, B, beam, L, 1, 2,
                                  length_penalty=lp)
        ti, tl = tdec.beam_search(tstep, tst, B, beam, L, 1, 2,
                                  length_penalty=lp)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    tiled = tdec.tile_for_beams({"a": torch.arange(6).reshape(2, 3), "p": 4},
                                3)
    assert tiled["p"] == 4
    np.testing.assert_array_equal(tiled["a"].numpy(), np.asarray(
        jdec.tile_for_beams({"a": jnp.arange(6).reshape(2, 3)}, 3)["a"]))


def test_early_exit_stops_when_every_row_finishes():
    """A decoder that emits eos at once: one step, then the prefilled eos
    rows, whatever max_len is."""
    def step(state, toks):
        lg = torch.zeros((toks.shape[0], 5))
        lg[:, 2] = 9.0
        return state, lg

    before = tdec.early_exit_scan.steps
    ids, lens = tdec.greedy_decode(step, {"h": torch.zeros(3)}, 3, 40, 1, 2)
    assert tdec.early_exit_scan.steps == before + 1
    assert lens.tolist() == [1, 1, 1] and (ids == 2).all()


def _strip_eos(ids, n, eos=2):
    return [int(x) for x in ids[:n] if x != eos]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lambda1_equals_ctc_prefix_beam(seed):
    """ctc_weight 1 with a flat attention model finds the labeling of the
    exact numpy prefix beam (the port's counterpart of the JAX test)."""
    rng = np.random.default_rng(seed)
    B, T, Vs, beam = 2, 7, 6, 16
    logits = rng.normal(0, 1.5, (B, T, Vs)).astype(np.float32)
    logits[:, :, 1:3] = -20.0        # sos / eos never in the CTC lattice
    lens = np.asarray([7, 5], np.int32)
    BW = B * beam
    flat = torch.zeros((BW, Vs))
    ids, out_len = tjd.joint_beam_search(
        lambda s, t: (s, flat), {"h": torch.zeros((BW, 1))},
        torch.repeat_interleave(_t(logits), beam, dim=0),
        torch.repeat_interleave(_t(lens), beam, dim=0), B, beam, max_len=8,
        sos=1, eos=2, blank=0, ctc_weight=1.0, length_penalty=0.0)
    for b in range(B):
        lp = torch.log_softmax(_t(logits[b, :lens[b]]), -1).numpy()
        want, _ = ctc_prefix_beam_search(lp, beam_width=4096, prune_topk=Vs)
        assert _strip_eos(ids[b].numpy(), out_len[b]) == want


def test_lambda0_matches_attention_beam():
    """ctc_weight 0 reproduces the attention beam (same scoring, same
    tie-breaking)."""
    B, T, Vs, beam = 2, 5, 7, 4
    _, _, tstep, tst = _toy_att(3, Vs, B * beam)
    a_ids, a_len = tdec.beam_search(tstep, tst, B, beam, 6, 1, 2,
                                    length_penalty=0.0)
    j_ids, j_len = tjd.joint_beam_search(
        tstep, tst, torch.zeros((B * beam, T, Vs)),
        torch.full((B * beam,), T, dtype=torch.int32), B, beam, 6, 1, 2,
        blank=0, ctc_weight=0.0, length_penalty=0.0)
    np.testing.assert_array_equal(a_len.numpy(), j_len.numpy())
    for b in range(B):
        assert _strip_eos(a_ids[b].numpy(), a_len[b]) == \
            _strip_eos(j_ids[b].numpy(), j_len[b])


def _fusion(kind):
    """(JAX lm, JAX lexicon, port lm, port lexicon) for a case."""
    jl = tl = jx = tx = None
    if "lm" in kind:
        table, order = infer.load_char_lm_host()
        jl, tl = (jnp.asarray(table), order), (_t(table), order)
    if "lex" in kind:
        lex = jlex.fixture_lexicon()
        jx, tx = jlex.to_jax(lex), to_torch(lex, "cpu")
    return jl, jx, tl, tx


# ctc logits that favour a fixture word per sample, so the lexicon leaves
# live beams
def _word_logits(seed, words, T):
    from lipreading_tpu_torch.text import Vocab

    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 0.7, (len(words), T, V)).astype(np.float32)
    for b, w in enumerate(words):
        ids = Vocab().encode(w)
        for i, c in enumerate(ids):
            logits[b, 2 * i + 1, c] += 5.0
        logits[b, :, 0] += 2.5
    return logits


@pytest.mark.parametrize("kind", ["plain", "lm", "lex", "lm+lex"])
def test_joint_beam_search_matches_jax(kind):
    B, T, beam, L = 2, 16, 4, 10
    logits = _word_logits(11, ["the way", "hod"], T)
    lens = np.asarray([T, 12], np.int32)
    jl, jx, tl, tx = _fusion(kind)
    lm_w = 0.4 if tl is not None else 0.0
    jstep, jst, tstep, tst = _toy_att(5, V, B * beam)
    ji, jlen = jjd.joint_beam_search(
        jstep, jst, jnp.repeat(jnp.asarray(logits), beam, axis=0),
        jnp.repeat(jnp.asarray(lens), beam, axis=0), B, beam, L, 1, 2,
        ctc_weight=0.5, length_penalty=0.6, lm=jl, lm_weight=lm_w,
        lexicon=jx)
    ti, tlen = tjd.joint_beam_search(
        tstep, tst, torch.repeat_interleave(_t(logits), beam, dim=0),
        torch.repeat_interleave(_t(lens), beam, dim=0), B, beam, L, 1, 2,
        ctc_weight=0.5, length_penalty=0.6, lm=tl, lm_weight=lm_w,
        lexicon=tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    scores = tdec.backtrack_best.last_scores
    assert scores.shape == (B, beam)


@pytest.mark.parametrize("kind", ["plain", "lm", "lex", "lm+lex"])
def test_ctc_prefix_beam_device_matches_jax(kind):
    T, beam, L = 16, 6, 10
    logits = _word_logits(12, ["they", "how had", "wen"], T)
    lens = np.asarray([T, T, 9], np.int32)
    jl, jx, tl, tx = _fusion(kind)
    lm_w = 0.4 if tl is not None else 0.0
    ji, jlen = jjd.ctc_prefix_beam_device(
        jnp.asarray(logits), jnp.asarray(lens), beam, L, lexicon=jx, lm=jl,
        lm_weight=lm_w)
    ti, tlen = tjd.ctc_prefix_beam_device(
        _t(logits), _t(lens), beam, L, lexicon=tx, lm=tl, lm_weight=lm_w)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
