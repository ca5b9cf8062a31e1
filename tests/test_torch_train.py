"""The port's training path at a small width on the CPU, against the JAX
package: the hybrid loss and every gradient leaf (``compute_loss`` with
``rng=None``), the optimizer against optax, the schedule, the FLOP counts,
the config overrides; and the port's own trainer: dropout, the step
generator, restore replay, logging, checkpoints and the refusals of what is
not ported yet.

Tolerances, each with its reason:
* float32 loss rtol 1e-5 and gradients rtol 1e-3 with atol 1e-6 + 1e-4 of
  the leaf's largest entry: the two frameworks sum in other orders, and
  some leaves (the k biases, whose true gradient is 0 since softmax ignores
  a constant shift) hold only rounding noise;
* bfloat16 loss rtol 1e-2 and a gradient cosine of at least 0.999: every
  dense layer rounds to bfloat16 (4e-3 relative) at places the two
  frameworks do not share;
* optimizer: parameters rtol 1e-6 / atol 1e-8 after 3 steps, moments rtol
  1e-5 with atol 1e-6 of the leaf's largest entry: elementwise float32
  arithmetic that may round one ulp apart, and a moment near 0 is the
  difference of two close products.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lipreading_tpu import flops as jflops
from lipreading_tpu.config import Config as JConfig
from lipreading_tpu.config import ModelConfig as JModel
from lipreading_tpu.config import TrainConfig as JTrain
from lipreading_tpu.config import preset as jpreset
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.train.loop import make_optimizer
from lipreading_tpu_torch import flops as tflops
from lipreading_tpu_torch.config import Config, ModelConfig, TrainConfig
from lipreading_tpu_torch.config import parse_overrides, preset
from lipreading_tpu_torch.io import from_jax_params, to_jax_params
from lipreading_tpu_torch.models import lipreader as tlr
from lipreading_tpu_torch.models import nn as tnn
from lipreading_tpu_torch.models.transformer import sinusoidal_positions
from lipreading_tpu_torch.train import optim
from lipreading_tpu_torch.train.checkpoint import latest_checkpoint
from lipreading_tpu_torch.train.loop import Trainer, eval_falls, step_seed

SMALL = dict(frontend="patchify", patch_dim=16, frontend_dim=24, tf_dim=32,
             tf_heads=2, tf_mlp=64, tf_layers=1, tf_dec_layers=1,
             highway_layers=1, framewise_norm=True)


def _cfgs(dtype="float32", **train):
    kw = dict(SMALL, dtype=dtype)
    tk = dict(dict(ctc_weight=0.3, att_weight=0.7), **train)
    return (Config(encoder="transformer", decoder="hybrid",
                   model=ModelConfig(**kw), train=TrainConfig(**tk)),
            JConfig(encoder="transformer", decoder="hybrid",
                    model=JModel(**kw), train=JTrain(**tk)))


def _batch(seed=0, B=3, T=16, L=10, weights=False):
    rng = np.random.default_rng(seed)
    b = {"rois": rng.normal(0, 1, (B, T, 96, 96)).astype(np.float32),
         "frame_lengths": np.array([T, T - 4, 7][:B], np.int32),
         "targets": rng.integers(3, 31, (B, L)).astype(np.int32),
         "target_lengths": np.array([L, 6, 3][:B], np.int32),
         "ctc_labels": rng.integers(3, 31, (B, L)).astype(np.int32),
         "ctc_lengths": np.array([5, 3, 0][:B], np.int32)}
    if weights:
        # sample 2 is infeasible (7 frames, 5 labels and no room) and
        # weighted out, as the tracked step weights out faceless samples
        b["ctc_lengths"][2] = 5
        b["sample_weight"] = np.array([1.0, 0.5, 0.0], np.float32)
    return b


def _jax_loss_and_grads(jcfg, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: jlr.compute_loss(p, jcfg, jb, rng=None), has_aux=True))
    (loss, metrics), grads = fn(params)
    return loss, metrics, jax.tree_util.tree_map(np.asarray, grads)


def _jax_init(jcfg, seed):
    return jlr.init_model(jax.random.PRNGKey(seed), jcfg)


def _port_model(cfg, jcfg, seed=0):
    params = _jax_init(jcfg, seed)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = tlr.LipReader(cfg)
    model.load_state_dict(from_jax_params(tree, cfg))
    return model, params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _port_loss_and_grads(model, cfg, batch):
    loss, metrics = tlr.compute_loss(
        model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        gen=None)
    loss.backward()
    grads = to_jax_params({k: p.grad for k, p in model.named_parameters()})
    return loss, metrics, grads


@pytest.mark.parametrize("weights", [False, True])
def test_compute_loss_and_grads_match_jax_float32(weights):
    cfg, jcfg = _cfgs()
    model, params = _port_model(cfg, jcfg)
    batch = _batch(weights=weights)
    jl, jm, jg = _jax_loss_and_grads(jcfg, params, batch)
    tl_, tm, tg = _port_loss_and_grads(model, cfg, batch)
    assert tl_.item() == pytest.approx(float(jl), rel=1e-5)
    for k in ("ctc_loss", "att_loss"):
        assert tm[k].item() == pytest.approx(float(jm[k]), rel=1e-5)
    want, got = dict(_leaves(jg)), dict(_leaves(tg))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=1e-3, atol=1e-6 + 1e-4 * np.abs(w).max(),
            err_msg=k)


def test_compute_loss_and_grads_match_jax_bfloat16():
    cfg, jcfg = _cfgs("bfloat16")
    model, params = _port_model(cfg, jcfg, seed=1)
    batch = _batch(1)
    jl, _, jg = _jax_loss_and_grads(jcfg, params, batch)
    tl_, _, tg = _port_loss_and_grads(model, cfg, batch)
    assert tl_.item() == pytest.approx(float(jl), rel=1e-2)
    want, got = dict(_leaves(jg)), dict(_leaves(tg))
    a = np.concatenate([got[k].ravel() for k in sorted(want)]).astype(np.float64)
    b = np.concatenate([want[k].ravel() for k in sorted(want)]).astype(np.float64)
    assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) >= 0.999


def test_dropout_keeps_and_scales():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = tnn.dropout(x, 0.25, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    same = tnn.dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(y, same)
    assert tnn.dropout(x, 0.25, None) is x and tnn.dropout(x, 0.0, g) is x
    assert tnn.dropout(x.bfloat16(), 0.5, g).dtype == torch.bfloat16


def test_training_draws_come_from_the_generator():
    """Dropout and the ROI jitter depend on the generator alone; without a
    generator (or with train=False) the loss is the deterministic one."""
    cfg, jcfg = _cfgs(roi_augment=0.15)
    model, _ = _port_model(cfg, jcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}

    def loss(gen, train=True):
        with torch.no_grad():
            return float(tlr.compute_loss(model, cfg, batch, train, gen)[0])

    a = loss(torch.Generator().manual_seed(1))
    assert a == loss(torch.Generator().manual_seed(1))
    assert a != loss(torch.Generator().manual_seed(2))
    det = loss(None)
    assert det == loss(torch.Generator().manual_seed(1), train=False)
    assert det != a


def test_init_model_shapes_and_ranges():
    cfg, jcfg = _cfgs()
    model = tlr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jtree = jax.tree_util.tree_map(np.asarray, _jax_init(jcfg, 0))
    want = {k: v.shape for k, v in _leaves(jtree)}
    got = {k: v.shape for k, v in _leaves(to_jax_params(model.state_dict()))}
    assert got == want
    p = dict(model.named_parameters())
    s = 1 / np.sqrt(SMALL["tf_dim"])
    w = p["encoder.layers.0.mlp.in.w"]
    assert w.abs().max() <= s and w.abs().max() > 0.9 * s
    hb = p["frontend.highway.0.t.b"]
    assert (hb + 2).abs().max() <= 1 / np.sqrt(SMALL["frontend_dim"])
    assert abs(p["att_decoder.embed.table"].std().item() - 1.0) < 0.1
    torch.testing.assert_close(p["att_decoder.pos"].detach(), torch.from_numpy(
        sinusoidal_positions(1024, SMALL["tf_dim"])))
    assert p["encoder.ln_out.scale"].eq(1).all()


@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 5), (200, 5000),
                                          (5, 5)])
def test_schedule_matches_optax(warmup, total):
    t = TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    jt = JTrain(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=jt.learning_rate,
        warmup_steps=jt.warmup_steps,
        decay_steps=max(jt.total_steps, jt.warmup_steps + 1),
        end_value=jt.learning_rate * 0.05)
    for c in list(range(0, 12)) + [warmup, total, total + 7, 4999]:
        assert optim.warmup_cosine_lr(c, t) == pytest.approx(
            float(sched(c)), rel=1e-6, abs=1e-12), c
    assert optim.warmup_cosine_lr(0, t) == (
        0.0 if warmup else pytest.approx(3e-4, rel=1e-7))


class _Leaves(torch.nn.Module):
    """A few parameters in the shapes of the model's: a dense layer in a
    list, a norm, and a ``pos`` table."""

    def __init__(self, tree):
        super().__init__()
        self.layers = torch.nn.ModuleList([torch.nn.Module()])
        for k in ("w", "b"):
            self.layers[0].register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(np.array(tree["layers"][0][k]))))
        self.ln = torch.nn.Module()
        self.ln.scale = torch.nn.Parameter(torch.from_numpy(
            np.array(tree["ln"]["scale"])))
        self.pos = torch.nn.Parameter(torch.from_numpy(np.array(tree["pos"])))


def test_three_adamw_steps_match_optax():
    """warmup_steps=2 (so the first update has lr 0) and a clip that
    triggers on steps 1 and 3 but not on step 2; weight decay on every leaf,
    ``pos`` included."""
    cfg, jcfg = _cfgs(warmup_steps=2, total_steps=10, grad_clip=1.0,
                      weight_decay=0.1, learning_rate=1e-2)
    rng = np.random.default_rng(0)
    params = {"layers": [{"w": rng.normal(0, 0.3, (32, 24)),
                          "b": rng.normal(0, 0.1, (24,))}],
              "ln": {"scale": np.ones(24)},
              "pos": rng.normal(0, 1, (64, 24))}
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    params)
    model = _Leaves(params)
    tx = make_optimizer(jcfg)
    state = tx.init(params)
    update = jax.jit(tx.update)
    opt = optim.AdamW(model, cfg.train)
    names = [k for k, _ in model.named_parameters()]
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    for step, scale in enumerate((1.0, 1e-3, 0.5)):
        gnp = {k: (rng.normal(0, 1, p.shape) * scale / np.sqrt(len(names)))
               .astype(np.float32) for k, p in model.named_parameters()}
        gnp["layers.0.w"] *= 20                   # norm ~ 10 * scale
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(gnp[k])
        norm = opt.update()
        jg = jax.tree_util.tree_map(jnp.asarray, _nest(gnp, params))
        assert (float(norm) < 1.0) == (step == 1)
        assert float(norm) == pytest.approx(float(optax.global_norm(jg)),
                                            rel=1e-6)
        updates, state = update(jg, state, params)
        params = optax.apply_updates(params, updates)
        want = dict(_leaves(jax.tree_util.tree_map(np.asarray, params)))
        got = dict(_leaves(to_jax_params(dict(model.named_parameters()))))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-8,
                                       err_msg=f"step {step} {k}")
        if step == 0:                    # lr 0: nothing moves
            for k, p in model.named_parameters():
                assert torch.equal(p.detach(), start[k]), k
    tree = opt.state_tree()
    jstate = jax.tree_util.tree_map(np.asarray, state)
    assert int(tree["1"]["0"]["count"]) == int(jstate[1][0].count) == 3
    assert int(tree["1"]["2"]["count"]) == int(jstate[1][2].count) == 3
    for name in ("mu", "nu"):
        want = dict(_leaves(getattr(jstate[1][0], name)))
        got = dict(_leaves(tree["1"]["0"][name]))
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{name} {k}")


def _nest(flat: dict, like):
    """Flat ``a.b.0.c`` numpy leaves -> the structure of the JAX tree."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        return flat[prefix[:-1]]
    return build(like, "")


def test_clip_is_optax_formula():
    """g / norm * max when norm >= max, g unchanged below; no 1e-6 term."""
    cfg, _ = _cfgs(grad_clip=2.0, warmup_steps=0, weight_decay=0.0)
    lin = torch.nn.Linear(3, 1, bias=False)
    opt = optim.AdamW(lin, cfg.train)
    lin.weight.grad = torch.tensor([[3.0, 4.0, 0.0]])
    assert float(opt.update()) == 5.0
    # first Adam step moves each weight by lr * g / (|g| + eps)
    m = opt.mu["weight"]
    torch.testing.assert_close(m, 0.1 * torch.tensor([[3.0, 4.0, 0.0]])
                               / 5.0 * 2.0)


class _Batches:
    """A deterministic, resumable iterator of small model batches."""

    def __init__(self, pos=0):
        self.pos, self.epoch = pos, 0

    @property
    def state(self):
        return {"epoch": 0, "pos": self.pos, "seed": 0}

    def __next__(self):
        b = _batch(seed=100 + self.pos, T=12)
        b["frame_lengths"] = np.array([12, 9, 12], np.int32)
        self.pos += 1
        return b


def _trainer(tmp, cfg):
    return Trainer(cfg, str(tmp), device="cpu")


def test_restore_replays_the_run(tmp_path):
    """4 steps == 2 steps + save + restore (fresh trainer) + 2 steps, bit
    for bit, with dropout and the ROI jitter on."""
    cfg, _ = _cfgs(roi_augment=0.15, warmup_steps=1, log_every=1000)
    a = _trainer(tmp_path / "a", cfg)
    it = _Batches()
    ma = [a.train_step(next(it)) for _ in range(4)]

    b = _trainer(tmp_path / "b", cfg)
    it = _Batches()
    mb = [b.train_step(next(it)) for _ in range(2)]
    b.save(it)
    c = _trainer(tmp_path / "b", cfg)
    state = c.restore()
    assert state == {"epoch": 0, "pos": 2, "seed": 0} and c.step == 2
    it = _Batches(state["pos"])
    mb += [c.train_step(next(it)) for _ in range(2)]
    for x, y in zip(ma, mb):
        assert {k: float(v) for k, v in x.items()} == \
            {k: float(v) for k, v in y.items()}
    for (k, p), (_, q) in zip(a.model.named_parameters(),
                              c.model.named_parameters()):
        assert torch.equal(p, q), k
    for k in a.opt.mu:
        assert torch.equal(a.opt.mu[k], c.opt.mu[k])
        assert torch.equal(a.opt.nu[k], c.opt.nu[k])
    assert a.opt.count == c.opt.count == 4


def test_step_seed_depends_on_seed_and_step():
    assert step_seed(0, 3) == step_seed(0, 3)
    assert len({step_seed(s, t) for s in range(3) for t in range(3)}) == 9


def test_fit_logs_checkpoints_and_refuses_evaluation(tmp_path):
    cfg, _ = _cfgs(log_every=1, checkpoint_every=2, eval_every=3,
                   warmup_steps=1)
    tr = _trainer(tmp_path, cfg)
    with pytest.raises(NotImplementedError, match="joint"):
        tr.fit(_Batches(), steps=3)
    assert tr.step == 0                    # refused before any step
    last = tr.fit(_Batches(), steps=2)
    assert tr.step == 2 and np.isfinite(last["loss"])
    assert {"frames_per_sec", "tflops_per_sec", "grad_norm",
            "epoch"} <= set(last)
    lines = open(os.path.join(tmp_path, "logs", "metrics.jsonl")).readlines()
    assert len(lines) == 2
    assert latest_checkpoint(tr.ckpt_dir).endswith("ckpt_00000002.msgpack")
    with pytest.raises(NotImplementedError):
        tr.evaluate([])
    assert eval_falls(0, 500, 500) and not eval_falls(0, 499, 500)
    assert not eval_falls(10, 10 ** 6, 0) and eval_falls(499, 1, 500)


def test_trainer_refuses_remat(tmp_path):
    cfg, _ = _cfgs(remat=True)
    with pytest.raises(NotImplementedError, match="remat"):
        _trainer(tmp_path, cfg)


@pytest.mark.parametrize("argv,match", [
    (["fused=0"], "dataview"),
    (["dataview=runs/x"], "dataview"),
    (["tracked=1"], "tracked"),
    (["variation=0.5"], "variation"),
    (["preprocess.landmarker=conv"], "landmarker"),
    (["train.remat=1"], "remat"),
    (["device=cpu", "steps=600", "n_clips=1"], "joint"),
])
def test_entry_point_refuses_later_slices(argv, match, tmp_path):
    from lipreading_tpu_torch.train.__main__ import main

    with pytest.raises(NotImplementedError, match=match):
        main(argv + [f"workdir={tmp_path}"])


def test_entry_point_defaults_to_the_card(tmp_path):
    from lipreading_tpu_torch.train.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would use it")
    with pytest.raises(SystemExit, match="device=cpu"):
        main([f"workdir={tmp_path}", "steps=1"])


def test_flops_match_jax():
    for decoder in ("hybrid", "ctc"):
        cfg = preset("transformer-patchify").override(decoder=decoder)
        jcfg = jpreset("transformer-patchify").override(decoder=decoder)
        for B, T, L in ((8, 32, 12), (8, 128, 40), (2, 96, 7)):
            assert tflops.train_step_flops(cfg, B, T, L) == \
                jflops.train_step_flops(jcfg, B, T, L)
    if not torch.cuda.is_available():
        assert tflops.device_peak_flops() is None
    assert tflops._product("NVIDIA H100 80GB HBM3") == "H100 SXM"
    assert tflops._product("NVIDIA H100 PCIe") == "H100 PCIe"
    assert tflops._product("NVIDIA A100-SXM4-80GB") is None


def test_config_override_and_preset_match_jax():
    argv = ["train.seed=3", "model.dtype=float32", "data.time_buckets=32,64",
            "train.remat=1", "train.learning_rate=1e-3",
            "model.framewise_norm=true"]
    got = preset("transformer-patchify").override(**parse_overrides(argv))
    want = jpreset("transformer-patchify").override(**parse_overrides(argv))
    for part in ("data", "preprocess", "model", "train"):
        a, b = getattr(got, part), getattr(want, part)
        for f in a.__dataclass_fields__:
            assert getattr(a, f) == getattr(b, f), (part, f)
    assert (got.name, got.encoder, got.decoder) == \
        (want.name, want.encoder, want.decoder)
    with pytest.raises(KeyError):
        got.override(**{"train.nope": 1})
    with pytest.raises(KeyError, match="not yet ported"):
        preset("bigru-ctc")
