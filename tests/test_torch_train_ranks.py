"""``python -m lipreading_tpu_torch.train`` on 4 gloo ranks on the CPU, as
``torch.distributed.run --nproc_per_node=4`` starts it (``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` set; the ranks are spawned by
``tests/torch_dist_work.spawn`` and their group rendezvous on a file, as
the entry would on ``MASTER_ADDR``): the fused path at a small width under
DP 2 x TP 2, each rank preprocessing its own rows of every global batch,
2 steps and an evaluation at the second, against the same entry in one
process. Only rank 0 logs and writes the checkpoint.

Tolerances: the second step's loss, norm and evaluation within 1e-3
relative. The layouts sum in other orders, and Adam turns the rounding
noise of the k biases' gradients (truly 0: softmax ignores a constant
shift) into steps of the learning rate's size, which the second step
reads.
"""

import json
import os

import numpy as np
import pytest

from lipreading_tpu_torch.train.__main__ import main
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_helpers import few_torch_threads  # noqa: F401
from tests.torch_dist_work import entry_case, spawn

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

ARGS = ["device=cpu", "steps=2", "n_clips=2", "data.batch_size=4",
        "data.time_buckets=32", "model.tf_dim=32", "model.tf_heads=2",
        "model.tf_mlp=64", "model.patch_dim=16", "model.frontend_dim=24",
        "model.tf_layers=2", "model.tf_dec_layers=1", "model.dropout=0",
        "train.roi_augment=0", "train.eval_every=2", "train.beam_width=1",
        "train.log_every=1", "train.checkpoint_every=0"]
MESH = ["mesh.data_parallel=2", "mesh.model_parallel=2", "dist_backend=gloo"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry")
    ranked = spawn(4, entry_case, (ARGS + MESH + [f"workdir={tmp / 'dist'}"],),
                   str(tmp / "spawn"), threads=1)
    one = main(ARGS + [f"workdir={tmp / 'one'}"])
    return ranked, one, tmp


HOST_CLOCK = ("frames_per_sec", "tflops_per_sec")


def test_every_rank_reads_the_same_metrics(runs):
    ranked, _, _ = runs
    for r in ranked:
        assert set(r) == set(ranked[0])
        for k, v in r.items():
            if k not in HOST_CLOCK:
                assert v == ranked[0][k], k
    assert np.isfinite(ranked[0]["loss"])


def test_the_steps_and_evaluation_match_one_process(runs):
    ranked, one, _ = runs
    for key in ("loss", "ctc_loss", "att_loss", "grad_norm", "eval_cer"):
        np.testing.assert_allclose(ranked[0][key], one[key], rtol=1e-3,
                                   err_msg=key)


def test_rank_zero_alone_writes(runs):
    _, _, tmp = runs
    work = tmp / "dist"
    assert sorted(os.listdir(work / "ckpt")) == ["ckpt_00000002.json",
                                                 "ckpt_00000002.msgpack"]
    with open(work / "config.json") as f:
        assert json.load(f)["mesh"]["model_parallel"] == 2
    lines = (work / "logs" / "metrics.jsonl").read_text().splitlines()
    steps = [json.loads(x)["step"] for x in lines]
    # steps 1 and 2, the evaluation and its sample decode: once each
    assert steps == [1, 2, 2, 2]
