"""The Auto-AVSR family (``models/resnet.py``, ``models/conformer.py``, the
ESPnet losses of ``models/lipreader.py``, ``loss="espnet"``) against its plain reference
(``oracle/conformer.py``) at a tiny size on seeded weights: d 32, 2 heads,
2 blocks, kernel 31, the ResNet-18 trunk on 32 x 32 crops, T 12-20,
vocabulary 40. The CTC and decoder logits (float32 and bf16), the loss
with label smoothing, every parameter's gradient and the BatchNorm running
statistics; the relative shift against the relative index i - j; two
planted faults the float32 tolerances catch; the configuration dicts of
every release and preset unchanged by the port-only ``loss`` field."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

from lipreading_tpu_torch import io, profiling
from lipreading_tpu_torch.config import (
    Config,
    ModelConfig,
    TrainConfig,
    from_dict,
    preset,
)
from lipreading_tpu_torch.models import conformer as C
from lipreading_tpu_torch.models.lipreader import (
    attention_logits,
    compute_loss,
    ctc_logits,
    encode,
    init_model,
)
from lipreading_tpu_torch.oracle import conformer as O
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 40
CFG = Config(
    name="tiny-avsr", encoder="conformer", decoder="hybrid",
    model=ModelConfig(frontend="resnet18", tf_dim=32, tf_heads=2, tf_mlp=64,
                      tf_layers=2, tf_dec_layers=2, vocab_size=V,
                      dtype="float32"),
    train=TrainConfig(ctc_weight=0.1, att_weight=0.9), loss="espnet")
# float32 on both sides: summation order only
TIGHT = {"logits": 1e-5, "loss": 1e-5, "grad": 1e-4, "stats": 1e-5}


def _batch():
    g = torch.Generator().manual_seed(11)
    lengths = torch.tensor([20, 12, 17])
    B, T = 3, 20
    rois = torch.randn(B, T, 32, 32, generator=g)
    rois = rois * (torch.arange(T)[None, :, None, None]
                   < lengths[:, None, None, None])
    n = (lengths // 6).clamp(min=1)
    L = int(n.max())
    cl = torch.zeros((B, L), dtype=torch.long)
    tg = torch.zeros((B, L + 2), dtype=torch.long)
    for k in range(B):
        ids = torch.randint(1, V - 2, (int(n[k]),), generator=g)
        cl[k, :len(ids)] = ids
        tg[k, 0], tg[k, len(ids) + 1] = V - 1, V - 1
        tg[k, 1:len(ids) + 1] = ids
    return {"rois": rois, "frame_lengths": lengths, "targets": tg,
            "target_lengths": n + 2, "ctc_labels": cl, "ctc_lengths": n}


@pytest.fixture(scope="module")
def setup():
    model = init_model(CFG, device="cpu")
    return model, {k: v.detach().clone()
                   for k, v in model.state_dict().items()}, _batch()


def _cfg_dict(cfg):
    return json.loads(json.dumps(cfg.to_dict()))


def _rel(a, b) -> float:
    return float((a.float() - b).norm() / b.norm())


def _oracle_logits(P, batch):
    d = _cfg_dict(CFG)
    nodrop = O._NoDrop()
    lens = batch["frame_lengths"]
    enc = O.encode(P, d, batch["rois"], lens, O.Plain(), nodrop, {})
    return (O.ctc_logits(P, enc, O.Plain(), nodrop),
            O.decoder_logits(P, d, batch["targets"][:, :-1], enc, lens,
                             O.Plain(), nodrop))


def _port_logits(model, cfg, batch):
    with torch.no_grad():
        enc = encode(model, cfg, batch["rois"], batch["frame_lengths"])
        return (ctc_logits(model, enc),
                attention_logits(model, cfg, enc, batch["frame_lengths"],
                                 batch["targets"]))


def _valid(batch):
    """The real frames and target positions: padded rows of the logits are
    no part of any loss."""
    T = batch["rois"].shape[1]
    L = batch["targets"].shape[1] - 1
    return (torch.arange(T)[None] < batch["frame_lengths"][:, None],
            torch.arange(L)[None] < (batch["target_lengths"] - 1)[:, None])


# bf16 activations (parameters float32): every product and norm rounds its
# inputs to 8 bits of mantissa (2^-9 relative) through ~40 layers, the
# trunk's BatchNorms among them, so the logits part from float32 by 3.3e-2
# of their norm on this model (the CTC logits; the decoder's less); 0.1
# leaves room above that reading and catches a layer gone wrong in the
# bf16 path (a sign, a dropped branch), not a subtle formula error, which
# the float32 tolerances are for
@pytest.mark.parametrize("dtype,tol", [("float32", TIGHT["logits"]),
                                       ("bfloat16", 0.1)])
def test_logits_match_oracle(setup, dtype, tol):
    """Both in training mode: BatchNorm normalises by the batch."""
    model, P0, batch = setup
    model.load_state_dict(P0)
    got = _port_logits(model, CFG.override(**{"model.dtype": dtype}), batch)
    want = _oracle_logits(dict(P0), batch)
    fv, tv = _valid(batch)
    for g, w, m in zip(got, want, (fv, tv)):
        assert _rel(g[m], w[m]) < tol


def _step_readings(model, batch, rate, seed=5):
    """(port loss, ctc, att, grads, stats), (oracle's) of one training
    forward and backward with dropout ``rate``."""
    cfg = CFG.override(**{"model.dropout": rate})
    names = [k for k, _ in model.named_parameters()]
    P = {k: v.detach().clone().requires_grad_(k in names)
         for k, v in model.state_dict().items()}
    for p in model.parameters():
        p.grad = None
    loss, met = compute_loss(model, cfg, batch,
                             gen=torch.Generator().manual_seed(seed))
    loss.backward()
    port = (loss.detach(), met["ctc_loss"].detach(), met["att_loss"].detach(),
            {k: p.grad for k, p in model.named_parameters()},
            {k: v for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))})
    rl, lc, la, stats = O.losses(P, _cfg_dict(cfg), batch, draws=O.Draws(
        torch.Generator().manual_seed(seed), rate, batch["rois"].shape[0]))
    grads = dict(zip(names, torch.autograd.grad(rl, [P[k] for k in names])))
    return port, (rl.detach(), lc.detach(), la.detach(), grads, stats)


def _gaps(port, ref) -> dict:
    """Relative loss gaps, the worst leaf's gradient gap (over the larger of
    its norm and the median leaf's) and the statistics' largest gap."""
    med = float(np.median([float(g.norm()) for g in ref[3].values()]))
    return {
        "loss": max(abs(float(a - b)) / abs(float(b))
                    for a, b in zip(port[:3], ref[:3])),
        "grad": max(float((port[3][k] - g).norm()) / max(float(g.norm()), med)
                    for k, g in ref[3].items()),
        "stats": max(float((port[4][k] - v).abs().max())
                     for k, v in ref[4].items()),
    }


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_loss_gradients_and_statistics_match_oracle(setup, rate):
    model, P0, batch = setup
    model.load_state_dict(P0)
    port, ref = _step_readings(model, batch, rate)
    assert set(port[4]) == set(ref[4]) and len(ref[4]) == 44
    # the step moved the statistics away from 0 and 1
    assert all(float((v - P0[k]).abs().max()) > 1e-4
               for k, v in ref[4].items())
    gaps = _gaps(port, ref)
    assert all(gaps[k] < TIGHT[k] for k in gaps), gaps


def test_label_smoothing_is_smoothed_cross_entropy_less_its_entropy():
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(2, 3, V, generator=g)
    tgt = torch.randint(0, V, (2, 3), generator=g)
    lens = torch.tensor([4, 3])                      # 3 and 2 real positions
    from lipreading_tpu_torch.models.lipreader import label_smoothing_loss

    got = label_smoothing_loss(logits, tgt, lens, 0.1, torch.tensor(2.0))
    want = O.smoothed_kl(logits, tgt, lens, 0.1) / 2
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    logp = torch.log_softmax(logits, -1)
    td = torch.full_like(logp, 0.1 / (V - 1)).scatter_(2, tgt[..., None], 0.9)
    ce = -(td * logp).sum(-1)
    ent = -(td * td.log()).sum(-1)
    mask = torch.arange(3)[None] < (lens - 1)[:, None]
    assert float(got) == pytest.approx(float(((ce - ent) * mask).sum() / 2),
                                       rel=1e-5)


@pytest.mark.parametrize("T", [1, 2, 7])
def test_rel_shift_is_the_relative_index(T):
    x = torch.randn(2, 3, T, 2 * T - 1)
    out = C.rel_shift(x)
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    assert torch.equal(out, x[..., i, T - 1 - i + j])
    # column T-1-i+j of the positions encodes i - j
    pos = C.rel_positions(T, 8)
    for a in range(T):
        for b in range(T):
            assert torch.allclose(pos[T - 1 - a + b], _enc(a - b), atol=1e-6)


def _enc(r):
    """The sinusoidal encoding (dim 8) of the position ``r``."""
    div = torch.exp(torch.arange(0, 8, 2).float() * (-math.log(10000.0) / 8))
    out = torch.zeros(8)
    out[0::2] = torch.sin(r * div)
    out[1::2] = torch.cos(r * div)
    return out


def _fault(monkeypatch, model, kind):
    if kind == "rel_shift_off_by_one":
        orig = C.rel_shift
        monkeypatch.setattr(C, "rel_shift",
                            lambda x: orig(torch.roll(x, -1, dims=-1)))
    else:                                # the macaron FFN's 1/2 dropped
        for blk in model.encoder.blocks:
            f = blk.ffm.forward
            monkeypatch.setattr(blk.ffm, "forward",
                                lambda *a, f=f, **k: 2 * f(*a, **k))


@pytest.mark.parametrize("kind", ["rel_shift_off_by_one",
                                  "macaron_half_dropped"])
def test_planted_fault_is_caught(setup, monkeypatch, kind):
    model, P0, batch = setup
    model.load_state_dict(P0)
    _fault(monkeypatch, model, kind)
    port, ref = _step_readings(model, batch, 0.0)
    gaps = _gaps(port, ref)
    assert not all(gaps[k] < TIGHT[k] for k in gaps), gaps
    model.load_state_dict(P0)
    got = _port_logits(model, CFG, batch)
    want = _oracle_logits(dict(P0), batch)
    fv, tv = _valid(batch)
    assert max(_rel(g[m], w[m]) for g, w, m in
               zip(got, want, (fv, tv))) > 100 * TIGHT["logits"]


@pytest.mark.parametrize("conf", ["universal4.json", "hybrid.json"])
def test_benchmark_release_configs_unchanged(conf):
    """The releases' dicts equal the benchmark's configuration files, and
    the port-only ``loss`` holds its default and is left out."""
    with open(os.path.join(REPO, "portbench", "configs", conf)) as f:
        c = json.load(f)
    cfg = io.load_release(c["release"])[1]
    assert json.loads(json.dumps(cfg.to_dict())) == c["config"]
    assert cfg.loss == "mean" and "loss" not in cfg.to_dict()


def test_presets_hold_defaults_and_the_section_round_trips():
    for name in ("transformer-patchify", "transformer-attn", "bigru-ctc"):
        assert "loss" not in preset(name).to_dict()
    d = _cfg_dict(CFG)
    assert d["loss"] == "espnet"
    assert _cfg_dict(from_dict(d)) == d
    assert "loss" not in CFG.override(loss="mean").to_dict()
    with pytest.raises(ValueError, match="unknown loss"):
        init_model(CFG.override(loss="clips"), device="cpu")
    with open(os.path.join(REPO, "portbench", "configs",
                           "autoavsr_vsr.json")) as f:
        conf = json.load(f)["config"]
    assert _cfg_dict(from_dict(conf)) == conf


def test_traced_step_spans_and_trunk_dgrad_routing(setup, monkeypatch,
                                                    tmp_path):
    """A traced bf16 training step through ``Trainer``: the Conformer's
    spans (one over the blocks, one a block for the attention and for the
    convolution module) and the 13 stride-1 3x3 convolutions of the trunk
    routed to the data-gradient kernel's path (``conv3d.dgrad``)."""
    from lipreading_tpu_torch.train.loop import Trainer

    for name, empty in (("_spans", {}), ("_counters", {}), ("_units", 0),
                        ("_last", None)):
        monkeypatch.setattr(profiling, name, empty)
    tr = Trainer(CFG.override(**{"model.dtype": "bfloat16"}), str(tmp_path),
                 "cpu")
    stage = {}
    m = tr.train_step(setup[2], stage_ms=stage)
    assert torch.isfinite(m["loss"])
    t = profiling.trace_totals()
    assert t["units"] == 1 and t["counters"]["conv3d.dgrad"] == 13
    n = {k: v["n"] for k, v in t["spans"].items()}
    assert (n["model.stem"], n["model.conformer"], n["conformer.attn"],
            n["conformer.conv"]) == (1, 1, 2, 2)
    assert {"forward", "backward", "optimizer"} <= set(stage)
