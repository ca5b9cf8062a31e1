"""Export a training run as a params-only release (counterpart of
``scripts/export_model.py``):

    python -m lipreading_tpu_torch.export_model workdir=runs/ctc \\
        name=bigru_ctc [preset=bigru-ctc]

Writes ``assets/<name>.msgpack`` (the parameters of the workdir's latest
checkpoint, no optimizer state, byte for byte what flax's
``msgpack_serialize`` writes for them) and ``assets/<name>.json`` (the
config the trainer wrote to the workdir, or the preset where it wrote none,
and the step), which ``io.load_release`` and the JAX package's
``load_release_model`` both read. The parameters must load strictly into
the config's model.
"""

from __future__ import annotations

import json
import os
import sys


def export(workdir: str, name: str = "model", preset_name: str = "bigru-ctc",
           out_dir: str | None = None) -> str:
    """Write ``<name>.msgpack`` and ``<name>.json`` into ``out_dir``
    (default ``assets/``) from the latest checkpoint of ``workdir`` ->
    the ``.msgpack`` path."""
    from lipreading_tpu_torch.config import load_workdir_config, preset
    from lipreading_tpu_torch.io import (
        ASSETS_DIR,
        from_jax_params,
        msgpack_serialize,
    )
    from lipreading_tpu_torch.models.lipreader import LipReader
    from lipreading_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )

    cfg = load_workdir_config(workdir) or preset(preset_name)
    path = latest_checkpoint(os.path.join(workdir, "ckpt"))
    if not path:
        raise SystemExit(f"no checkpoint in {workdir}/ckpt")
    step, params, _, _, _ = load_checkpoint(path)
    LipReader(cfg).load_state_dict(from_jax_params(params, cfg))
    out_dir = out_dir or ASSETS_DIR
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{name}.msgpack")
    with open(out, "wb") as f:
        f.write(msgpack_serialize(params))
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump({"config": cfg.to_dict(), "step": step}, f, indent=1,
                  default=str)
    print(f"exported step-{step} params ({os.path.getsize(out) >> 20} MiB) "
          f"-> {out}")
    return out


def main(argv: list[str]) -> str:
    from lipreading_tpu_torch.config import parse_overrides

    args = parse_overrides(argv)
    if "workdir" not in args:
        raise SystemExit("workdir= is required")
    return export(args["workdir"], args.get("name", "model"),
                  args.get("preset", "bigru-ctc"))


if __name__ == "__main__":
    main(sys.argv[1:])
