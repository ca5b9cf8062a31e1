"""A tiny release and asset directory for the CPU tests: the shipped
preprocessing weights and char LM linked, and a freshly drawn lip reader of
the release's family at small widths in float32, written as a release
(``<name>.json`` and ``<name>.msgpack``) that the program and the
reference both read."""

from __future__ import annotations

import json
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHARED = ("detector.npz", "presence.npz", "landmarker_conv.npz",
          "char_lm.npz", "ert.npz")
SMALL = {"model.tf_dim": 32, "model.tf_heads": 2, "model.tf_mlp": 64,
         "model.patch_dim": 16, "model.frontend_dim": 24,
         "model.frontend_channels": [4, 8, 12], "model.tf_layers": 1,
         "model.tf_dec_layers": 1, "model.dtype": "float32"}


def make_assets(tmp, conf_path: str, name: str = "tiny") -> tuple[str, dict]:
    """-> (assets dir, the configuration dict of a tiny model of the
    family of ``conf_path``'s release)."""
    from lipreading_tpu_torch import io
    from lipreading_tpu_torch.models.lipreader import init_model

    d = os.path.join(str(tmp), "assets")
    os.makedirs(d, exist_ok=True)
    for f in SHARED:
        os.symlink(os.path.join(ROOT, "assets", f), os.path.join(d, f))
    with open(os.path.join(ROOT, conf_path)) as f:
        conf = json.load(f)
    cfg = io.load_release(conf["release"])[1].override(**SMALL)
    model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    with open(os.path.join(d, f"{name}.msgpack"), "wb") as f:
        f.write(io.msgpack_serialize(io.to_jax_params(model.state_dict())))
    with open(os.path.join(d, f"{name}.json"), "w") as f:
        json.dump({"config": cfg.to_dict()}, f, default=list)
    conf = dict(conf, release=name,
                config=json.loads(json.dumps(cfg.to_dict(), default=list)))
    return d, conf


def point_program_at(monkeypatch, assets_dir: str) -> None:
    """The program's release and asset loaders read ``assets_dir``."""
    from lipreading_tpu_torch import infer, io

    monkeypatch.setattr(io, "ASSETS_DIR", assets_dir)
    monkeypatch.setattr(infer, "ASSETS_DIR", assets_dir)
    infer._LM_CACHE.clear()
