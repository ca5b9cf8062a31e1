"""The port's ``Trainer`` over a mesh of 4 gloo ranks on the CPU
(``tests/torch_dist_work.trainer_cases``, spawned once for the file):
DP 4, DP 2 x TP 2, DP 2 x SP 2 and DP 2 x PP 2, each 3 steps on the same
global batches as the one-process trainer here, from one seeded
initialisation. The batches have ragged frame and target lengths and a
sample of weight 0, so each loss's global denominator differs from every
rank's local one. Also a DP 4 step against the JAX ``Trainer`` on 4 of
conftest's devices, the tensor-parallel checkpoint and its resume, and the
refusals with the JAX package's texts.

Model: the patchify flagship at tf_dim 32, 4 heads, MLP 64, 2 + 1 layers,
float32, dropout off, ROIs 32 x 32, T 16, B 8. Tolerances: losses and
norms 1e-5 relative (summation order); gradients per leaf within 1e-5 of
the leaf's largest entry plus 1e-7; parameters after 3 steps likewise,
except the k biases: their true gradient is 0 (softmax ignores a constant
shift), so their gradients are rounding noise (held below 1e-6 here) that
Adam turns into steps of the learning rate's size. Ranks must hold the
same parameters to the byte. The DP step against JAX: 1e-4, as
``tests/test_sharding.py`` holds its layouts.
"""

import filecmp

import jax
import numpy as np
import pytest
import torch

from lipreading_tpu.config import preset as jpreset
from lipreading_tpu.models.lipreader import encode as jencode
from lipreading_tpu.models.lipreader import init_model as jinit
from lipreading_tpu.parallel.mesh import make_mesh as jmake_mesh
from lipreading_tpu.train.loop import Trainer as JTrainer
from lipreading_tpu_torch.config import MeshConfig, preset
from lipreading_tpu_torch.data.dataset import Batch
from lipreading_tpu_torch.models.lipreader import LipReader, encode
from lipreading_tpu_torch.parallel.mesh import make_mesh
from lipreading_tpu_torch.train.loop import Trainer
from tests.test_sharding import fake_batch, tiny_cfg
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_helpers import few_torch_threads  # noqa: F401
from tests.torch_dist_work import (
    LAYOUTS,
    SMALL,
    ragged_batch,
    run_steps,
    small_cfg,
    spawn,
    trainer_cases,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

STEPS = 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    cfg = small_cfg()
    batches = [ragged_batch(i) for i in range(STEPS)]
    jcfg = tiny_cfg(4)
    jcfg.model.dropout = 0.0
    jtr = JTrainer(jcfg, str(tmp / "jax"))
    tree = jax.tree_util.tree_map(lambda a: np.array(a), jtr.params)
    fb = fake_batch()
    batch = Batch(fb.rois_u8, fb.frame_lengths, fb.targets, fb.target_lengths,
                  fb.ctc_labels, fb.ctc_lengths, list(fb.texts))
    jloss = float(jtr.train_step(fb)["loss"])
    ranks = spawn(4, trainer_cases,
                  (cfg.to_dict(), batches, str(tmp / "ranks"),
                   (jcfg.to_dict(), tree, batch)), str(tmp / "spawn"))
    ref = run_steps(Trainer(cfg, str(tmp / "one"), device="cpu"), batches)
    return dict(cfg=cfg, ranks=ranks, ref=ref, jax_loss=jloss, tmp=tmp)


def _close(got, want, rtol=1e-5, atol=1e-7, skip=()):
    for name, w in want.items():
        if name.endswith(skip):
            continue
        err = np.abs(got[name] - w).max()
        assert err <= rtol * np.abs(w).max() + atol, (name, err)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gradients_match_the_one_process_step(run, layout):
    ref = run["ref"]["grads"]
    for o in run["ranks"]:
        got = o[layout]["grads"]
        assert set(got) == set(ref)
        _close(got, ref)
    for name, g in ref.items():
        if name.endswith(".k.b"):
            assert np.abs(g).max() < 1e-6, name


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loss_and_norm_match_on_every_rank(run, layout):
    ref = run["ref"]
    for o in run["ranks"]:
        for key in ("loss", "ctc_loss", "att_loss", "grad_norm"):
            np.testing.assert_allclose(o[layout][key], ref[key], rtol=1e-5)
        assert o[layout]["loss"] == run["ranks"][0][layout]["loss"]
        assert o[layout]["grad_norm"] == run["ranks"][0][layout]["grad_norm"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_parameters_after_three_steps(run, layout):
    _close(run["ranks"][0][layout]["params"], run["ref"]["params"],
           skip=(".k.b",))
    assert len({o[layout]["digest"] for o in run["ranks"]}) == 1


def test_dp4_step_matches_the_jax_trainer(run):
    for o in run["ranks"]:
        assert abs(o["jax_dp4_loss"] - run["jax_loss"]) < 1e-4, (
            o["jax_dp4_loss"], run["jax_loss"])


def test_tp_checkpoint_is_the_one_process_file(run, tmp_path):
    path = run["ranks"][0]["ckpt"]
    one = Trainer(run["cfg"], str(tmp_path), device="cpu")
    one.restore(path)
    assert one.step == STEPS
    assert filecmp.cmp(one.save(), path, shallow=False)
    _close({k: v.numpy() for k, v in one.model.state_dict().items()},
           run["ref"]["params"], skip=(".k.b",))


def test_tp_resume_is_bit_identical_and_sharded(run):
    for o in run["ranks"]:
        assert o["resume_state_equal"] and o["resume_step"] == STEPS
        assert o["resume_equal"]
        assert o["tp_local_shape"] == (32, 32)       # mlp.in: 64 columns / 2


_BIGRU_SMALL = {"model.frontend_channels": (4, 8, 12),
                "model.frontend_dim": 16, "model.gru_hidden": 8,
                "model.gru_layers": 1}


@pytest.mark.parametrize("flag", ["sequence_parallel", "pipeline_parallel"])
def test_trainer_refuses_the_bigru_with_the_jax_text(tmp_path, flag):
    jcfg = jpreset("bigru-ctc")
    setattr(jcfg.mesh, flag, True)
    for k, v in _BIGRU_SMALL.items():
        section, field = k.split(".")
        setattr(getattr(jcfg, section), field, v)
    cfg = preset("bigru-ctc").override(**{f"mesh.{flag}": True},
                                       **_BIGRU_SMALL)
    with pytest.raises(ValueError) as want:
        JTrainer(jcfg, str(tmp_path / "jax"))
    with pytest.raises(ValueError) as got:
        Trainer(cfg, str(tmp_path / "port"), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,flags", [
    ("transformer-patchify", ("sequence_parallel", "pipeline_parallel")),
    ("bigru-ctc", ("sequence_parallel",)), ("bigru-ctc", ("pipeline_parallel",))])
def test_encode_refuses_as_jax(name, flags):
    jcfg = jpreset(name)
    cfg = preset(name)
    for k, v in {**SMALL, **_BIGRU_SMALL, "preprocess.roi_size": 96}.items():
        section, field = k.split(".")
        setattr(getattr(jcfg, section), field, v)
        cfg = cfg.override(**{k: v})
    for f in flags:
        setattr(jcfg.mesh, f, True)
        setattr(jcfg.mesh, "model_parallel", 2)
        cfg = cfg.override(**{f"mesh.{f}": True, "mesh.model_parallel": 2})
    rois = np.zeros((1, 2, 96, 96), np.float32)
    lengths = np.full(1, 2, np.int32)
    with pytest.raises(ValueError) as want:
        jencode(jinit(jax.random.PRNGKey(0), jcfg), jcfg, rois, lengths,
                mesh=jmake_mesh(jcfg.mesh))
    with pytest.raises(ValueError) as got:
        encode(LipReader(cfg), cfg, torch.from_numpy(rois),
               torch.from_numpy(lengths),
               mesh=make_mesh(MeshConfig(model_parallel=2), world=2))
    assert str(got.value) == str(want.value)
