"""``python -m lipreading_tpu_torch.demo`` against ``scripts/demo.py`` on the
CPU: the untracked batch, the tracked batch and the ``stream=16`` modes on
fixture clip 3 with the shipped ``bigru_ctc`` release (the demo's
defaults, beam 8). The printed transcript lines (each chunk's in the
stream, the transcript, the reference and CER, the no-face count and the
shots) must be equal, string for string."""

import importlib.util
import os

import pytest
import torch

from lipreading_tpu_torch.demo import main
from tests.test_torch_helpers import file_hang_guard  # noqa: F401

pytestmark = pytest.mark.usefixtures("file_hang_guard")

REPO = os.path.join(os.path.dirname(__file__), "..")
KEPT = ("transcript:", "reference :", "  t=", "  shot [")


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_script", os.path.join(REPO, "scripts", "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _lines(out: str) -> list[str]:
    return [x for x in out.splitlines()
            if x.startswith(KEPT) or "frames flagged no-face" in x]


@pytest.mark.parametrize("mode", [[], ["tracked=1"], ["stream=16"],
                                  ["stream=16", "beam=1"]],
                         ids=["batch", "tracked", "stream", "stream_beam1"])
def test_demo_prints_the_jax_scripts_transcripts(jax_demo, capsys, tmp_path,
                                                 mode):
    argv = [f"workdir={tmp_path / 'none'}", "fixture_seed=3"] + mode
    jax_demo(argv)
    want = _lines(capsys.readouterr().out)
    got_text = main(argv + ["device=cpu"])
    got = _lines(capsys.readouterr().out)
    assert got == want
    assert any(x.startswith("transcript:") for x in got)
    assert f"transcript: {got_text!r}" in got
    if "stream=16" in mode:
        assert sum(x.startswith("  t=") for x in got) >= 4
