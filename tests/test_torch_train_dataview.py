"""The port's dataview ``Trainer`` on the CPU at a small width, against the
JAX package's: three steps on dataview batches, ``evaluate`` on the joint
beam, ``fit`` with a held-out evaluation, and ``train.remat``.

Tolerances, each with its reason (those of ``tests/test_torch_train.py``):
* float32 loss rtol 1e-5 and gradients rtol 1e-3 with atol 1e-6 + 1e-4 of
  the leaf's largest entry: the two frameworks sum in other orders, and
  the k biases hold only rounding noise;
* parameters: each step's update is optax's on the port's own gradients
  (rtol 1e-6 / atol 1e-8, the optimizer test's limits); against the JAX
  trainer's parameters no more than 2 lr a step apart, since Adam turns a
  gradient entry that is rounding noise (below the gradient limit) into a
  step of either sign and full size;
* transcripts: string-identical;
* remat: exact (the recompute runs the same operations on the same
  inputs with the same dropout draws).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from lipreading_tpu.config import Config as JConfig
from lipreading_tpu.config import DataConfig as JData
from lipreading_tpu.config import ModelConfig as JModel
from lipreading_tpu.config import TrainConfig as JTrain
from lipreading_tpu.data import dataset as jds
from lipreading_tpu.data import dataview as jdv
from lipreading_tpu.models import lipreader as jlr
from lipreading_tpu.train.loop import Trainer as JTrainer
from lipreading_tpu_torch.config import Config, DataConfig, ModelConfig
from lipreading_tpu_torch.config import TrainConfig
from lipreading_tpu_torch.data import dataset as tds
from lipreading_tpu_torch.data import dataview as tdv
from lipreading_tpu_torch.io import to_jax_params
from lipreading_tpu_torch.models import lipreader as tlr
from lipreading_tpu_torch.train.checkpoint import latest_checkpoint
from lipreading_tpu_torch.train.loop import Trainer
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

SMALL = dict(frontend="patchify", patch_dim=16, frontend_dim=24, tf_dim=32,
             tf_heads=2, tf_mlp=64, tf_layers=1, tf_dec_layers=1,
             highway_layers=1, framewise_norm=True)
BUCKETS = (64,)           # one shape: the JAX step compiles once
LR = 1e-3


def _cfgs(dropout=0.0, **train):
    tk = dict(ctc_weight=0.3, att_weight=0.7, warmup_steps=0,
              learning_rate=LR, log_every=1, checkpoint_every=0,
              eval_every=0, max_decode_len=12)
    tk.update(train)
    model = dict(SMALL, dtype="float32", dropout=dropout)
    cfg = Config(encoder="transformer", decoder="hybrid",
                 data=DataConfig(time_buckets=BUCKETS, batch_size=2),
                 model=ModelConfig(**model), train=TrainConfig(**tk))
    jcfg = JConfig(encoder="transformer", decoder="hybrid",
                   data=JData(time_buckets=BUCKETS, batch_size=2),
                   model=JModel(**model), train=JTrain(**tk))
    jcfg.mesh.data_parallel = 1
    return cfg, jcfg


@pytest.fixture(scope="module")
def view(tmp_path_factory):
    """2 fixture clips (10 samples) from their own landmarks."""
    path = str(tmp_path_factory.mktemp("view") / "v")
    return tdv.build_fixture_dataview(path, 2, seed=7,
                                      use_ground_truth_landmarks=True,
                                      device="cpu")


def _batches(path, cfg, jcfg, n):
    """The first ``n`` batches of both packages' iterators (equal, as
    ``tests/test_torch_dataview.py`` holds)."""
    jit = jds.BatchIterator(jds.BucketedDataset(jdv.Dataview(path),
                                                jcfg.data), 2, seed=0)
    tit = tds.BatchIterator(tds.BucketedDataset(tdv.Dataview(path),
                                                cfg.data), 2, seed=0)
    return [next(jit) for _ in range(n)], [next(tit) for _ in range(n)]


def _pair(tmp_path, cfg, jcfg):
    """A JAX Trainer and a port Trainer with the same parameters."""
    jt = JTrainer(jcfg, str(tmp_path / "j"))
    tt = Trainer(cfg, str(tmp_path / "t"), device="cpu")
    tt.logger.echo = jt.logger.echo = False
    tt.warm_start(jax.tree_util.tree_map(np.asarray, jt.params))
    return jt, tt


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _grads_close(got, want):
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=1e-3, atol=1e-6 + 1e-4 * np.abs(w).max(),
            err_msg=k)


def _jax_grads(jcfg, params, jbatch, fns={}):
    """Loss and gradient leaves of JAX's ``compute_loss`` (one jitted
    function per config)."""
    if id(jcfg) not in fns:
        fns[id(jcfg)] = jax.jit(jax.value_and_grad(
            lambda p, b: jlr.compute_loss(p, jcfg, b, rng=None),
            has_aux=True))
    dev = jds.batch_to_device(jbatch, jcfg.preprocess.normalize_mean,
                              jcfg.preprocess.normalize_std)
    (loss, _), g = fns[id(jcfg)](params, dev)
    return float(loss), dict(_leaves(jax.tree_util.tree_map(np.asarray, g)))


def _nest(flat: dict, like):
    """Flat ``/a/b/0`` leaves -> a tree shaped as ``like``."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        return jax.numpy.asarray(flat[prefix])
    return build(like, "")


def test_three_steps_on_dataview_batches_match_jax(view, tmp_path):
    import optax

    from lipreading_tpu.train.loop import make_optimizer

    cfg, jcfg = _cfgs()
    jbs, tbs = _batches(view.path, cfg, jcfg, 3)
    jt, tt = _pair(tmp_path, cfg, jcfg)
    tx = make_optimizer(jcfg)
    update = jax.jit(tx.update)
    mine = jax.tree_util.tree_map(jax.numpy.array, jt.params)   # donated
    opt = tx.init(mine)
    for step, (jb, tb) in enumerate(zip(jbs, tbs)):
        jl, jg = _jax_grads(jcfg, jt.params, jb)
        jm = jt.train_step(jb)
        tm = tt.train_step(tb)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(jm["loss"]) == pytest.approx(jl, rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        got = dict(_leaves(to_jax_params(
            {k: p.grad for k, p in tt.model.named_parameters()})))
        assert sorted(got) == sorted(jg)
        _grads_close(got, jg)
        # the step's update: optax's, on the port's gradients
        upd, opt = update(_nest(got, mine), opt, mine)
        mine = optax.apply_updates(mine, upd)
        want = dict(_leaves(jax.tree_util.tree_map(np.asarray, mine)))
        theirs = dict(_leaves(jax.tree_util.tree_map(np.asarray, jt.params)))
        have = dict(_leaves(to_jax_params(tt.model.state_dict())))
        for k, w in want.items():
            np.testing.assert_allclose(have[k], w, rtol=1e-6, atol=1e-8,
                                       err_msg=f"step {step} {k}")
            assert np.abs(have[k] - theirs[k]).max() <= 2 * LR * (step + 1)
    assert tt.step == jt.step == 3


def _jax_tree(model, jcfg):
    """The port model's parameters as the JAX package's tree (lists where
    it has lists)."""
    from flax import serialization

    template = jlr.init_model(jax.random.PRNGKey(0), jcfg)
    return serialization.from_state_dict(
        template, to_jax_params(model.state_dict()))


@pytest.fixture(scope="module")
def fitted(view, tmp_path_factory):
    """A port trainer after 30 steps from its seeded initialisation, its
    parameters as a JAX tree, and 2 held-out batches of each package."""
    cfg, jcfg = _cfgs(learning_rate=3e-3)
    tt = Trainer(cfg, str(tmp_path_factory.mktemp("fit")), device="cpu")
    tt.logger.echo = False
    it = tds.BatchIterator(tds.BucketedDataset(tdv.Dataview(view.path),
                                               cfg.data), 2, seed=0)
    for _ in range(30):
        tt.train_step(next(it))
    jds_ = jds.BucketedDataset(jdv.Dataview(view.path), jcfg.data)
    tds_ = tds.BucketedDataset(tdv.Dataview(view.path), cfg.data)
    idx = list(range(len(tds_)))
    return (tt, _jax_tree(tt.model, jcfg), jcfg,
            [jds_.make_batch(idx[:4]), jds_.make_batch(idx[4:8])],
            [tds_.make_batch(idx[:4]), tds_.make_batch(idx[4:8])])


def test_evaluate_on_the_joint_beam_matches_jax(fitted):
    """``Trainer.evaluate`` at beam 8 (the joint CTC/attention beam): the
    transcripts of the JAX package's ``transcribe`` (which its
    ``Trainer.evaluate`` calls) from the same parameters, so the same CER
    and WER, and the sample decode in the log."""
    import json

    from lipreading_tpu.infer import transcribe as jtranscribe
    from lipreading_tpu.metrics import corpus_cer, corpus_wer

    tt, jparams, jcfg, jbs, tbs = fitted
    want, refs = [], []
    for jb in jbs:
        dev = jds.batch_to_device(jb, 0.421, 0.165)
        want += jtranscribe(jparams, jcfg, dev["rois"], dev["frame_lengths"],
                            beam=8)
        refs += jb.texts
    m = tt.evaluate(tbs, beam=8)
    assert m == {"eval_cer": corpus_cer(want, refs),
                 "eval_wer": corpus_wer(want, refs)}
    with open(os.path.join(tt.workdir, "logs", "metrics.jsonl")) as f:
        last = json.loads(f.readlines()[-1])
    assert last["sample_decode"] == f"hyp={want[0]!r} ref={refs[0]!r}"


def test_fit_evaluates_at_eval_every(view, tmp_path):
    cfg, _ = _cfgs(eval_every=2, checkpoint_every=2)
    tt = Trainer(cfg, str(tmp_path), device="cpu")
    tt.logger.echo = False
    ds = tds.BucketedDataset(tdv.Dataview(view.path), cfg.data)
    it = tds.BatchIterator(ds, 2, seed=0)
    held = [ds.make_batch([0, 1])]
    last = tt.fit(it, steps=2, eval_batches=held)
    assert tt.step == 2 and np.isfinite(last["loss"])
    with open(os.path.join(tmp_path, "logs", "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    evals = [x for x in lines if "eval_cer" in x]
    assert [x["step"] for x in evals] == [2]
    assert evals[0]["eval_cer"] >= 0 and evals[0]["eval_wer"] >= 0
    decodes = [x for x in lines if "sample_decode" in x]
    assert [x["step"] for x in decodes] == [2]
    assert {"eval_cer", "eval_wer"} <= set(last)
    assert latest_checkpoint(tt.ckpt_dir).endswith("00000002.msgpack")


def _remat_grads(cfg, batch, seed=11):
    """Loss and gradients of one training-mode loss with dropout drawn from
    a generator seeded with ``seed``."""
    model = tlr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(seed)
    loss, _ = tlr.compute_loss(model, cfg, batch, train=True, gen=gen)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}, gen


def test_remat_equals_the_plain_step_with_dropout(view):
    cfg, _ = _cfgs(dropout=0.3)
    remat, _ = _cfgs(dropout=0.3, remat=True)
    b = tds.BucketedDataset(tdv.Dataview(view.path), cfg.data).make_batch(
        [0, 1, 2])
    batch = tds.batch_to_device(b, 0.421, 0.165, "cpu")
    l0, g0, gen0 = _remat_grads(cfg, batch)
    l1, g1, gen1 = _remat_grads(remat, batch)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    # the generator ends where the plain step leaves it
    assert torch.equal(gen0.get_state(), gen1.get_state())
    # another generator gives other masks: the test sees the dropout
    l2, g2, _ = _remat_grads(remat, batch, seed=12)
    assert not torch.equal(l1, l2)


def test_remat_matches_jax_remat(view):
    cfg, jcfg = _cfgs(remat=True)
    b = tds.BucketedDataset(tdv.Dataview(view.path), cfg.data).make_batch(
        [0, 1, 2])
    params = jlr.init_model(jax.random.PRNGKey(2), jcfg)
    jl, jg = _jax_grads(jcfg, params, b)
    from lipreading_tpu_torch.io import from_jax_params

    model = tlr.LipReader(cfg)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    loss, _ = tlr.compute_loss(model, cfg,
                               tds.batch_to_device(b, 0.421, 0.165, "cpu"),
                               gen=None)
    loss.backward()
    assert loss.item() == pytest.approx(jl, rel=1e-5)
    got = dict(_leaves(to_jax_params(
        {k: p.grad for k, p in model.named_parameters()})))
    _grads_close(got, jg)
