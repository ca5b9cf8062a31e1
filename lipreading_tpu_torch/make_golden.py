"""Write the per-stage tensors of the per-frame oracle on fixture clip 0
(counterpart of ``scripts/make_golden.py``):

    python -m lipreading_tpu_torch.make_golden [out.npz]

The default is ``runs/golden/clip0.npz`` in the repository. The checked-in
dump ``tests/golden/clip0.npz`` is the one every run is held to, so this
entry refuses to write there; a fresh dump must equal it array for array.
Prints the oracle's frames/s and the landmarks' mean error against the
fixture's ground truth.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "runs", "golden", "clip0.npz")
CHECKED_IN = os.path.join(ROOT, "tests", "golden", "clip0.npz")


def make_golden(out: str = DEFAULT_OUT):
    """Run the oracle on ``make_clip(0)`` and dump it to ``out`` -> the
    oracle's ``PreprocResult``."""
    import numpy as np

    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.io import load_assets
    from lipreading_tpu_torch.oracle.pipeline import golden_dump, run_clip

    if os.path.realpath(out) == os.path.realpath(CHECKED_IN):
        raise SystemExit(f"refusing to overwrite the checked-in dump {out}")
    det, ert = load_assets()
    clip = make_clip(0)
    res = run_clip(clip.frames, det, ert)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    golden_dump(res, out)
    print(f"oracle {res.frames_per_sec:.1f} frames/s (host)")
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")
    err = float(np.abs(res.landmarks - clip.landmarks).mean())
    print(f"landmark error against the fixture's ground truth: {err:.4f} px")
    return res


if __name__ == "__main__":
    make_golden(*sys.argv[1:2])
