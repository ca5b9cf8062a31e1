"""Train the face detector, the ERT landmarker and the face-presence head on
the synthetic fixture corpus (counterpart of
``scripts/train_preprocessor.py``):

    python -m lipreading_tpu_torch.train_preprocessor [seed=0] [n_clips=40]
        [det_steps=1500] [out_dir=assets] [device=cuda]

Writes ``detector.npz``, ``ert.npz`` and ``presence.npz`` into ``out_dir``
(by default the shipped ``assets/``, which it overwrites) and prints the
held-out detector box error and ERT landmark error. The detector and the
presence head train on the GPU unless ``device=cpu`` is given; the ERT
boosts on the host.
"""

from __future__ import annotations

import sys
import time

INT_ARGS = ("seed", "n_clips", "det_steps")


def parse_args(argv: list[str]) -> dict:
    """``key=value`` arguments -> ``train_all``'s keywords."""
    from lipreading_tpu_torch.config import parse_overrides

    args = parse_overrides(argv)
    kw = {"device": args.pop("device", "cuda"),
          "out_dir": args.pop("out_dir", None)}
    unknown = set(args) - set(INT_ARGS)
    if unknown:
        raise SystemExit(f"unknown arguments {sorted(unknown)}")
    kw.update({k: int(v) for k, v in args.items()})
    return kw


def main(argv: list[str]):
    import torch

    from lipreading_tpu_torch.preproc_training import report_time, train_all

    kw = parse_args(argv)
    if kw["device"].startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to train on the CPU")
    t0 = time.perf_counter()
    out = train_all(**kw, verbose=True)
    report_time("train_preprocessor", t0, kw["device"])
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
