"""Checkpoints in the JAX package's layout (counterpart of
``lipreading_tpu/train/checkpoint.py``).

``ckpt_<step:08d>.msgpack`` holds ``{"step", "params", "opt_state"}`` as
flax's ``msgpack_serialize`` writes it (``io.msgpack_serialize``): the
params are the nested tree a flax checkpoint stores (``io.to_jax_params``),
the optimizer state the tree of ``train.optim.AdamW.state_tree``. A JSON
sidecar keeps the step, the iterator state and extras. The JAX package's
``load_checkpoint`` reads these files, and ``load_checkpoint`` here reads
the JAX package's. Writes are atomic (rename), and only the last ``keep``
checkpoints stay.
"""

from __future__ import annotations

import json
import os
import re

from lipreading_tpu_torch.io import msgpack_restore, msgpack_serialize

_CKPT = re.compile(r"ckpt_\d+\.msgpack")


def save_checkpoint(ckpt_dir: str, step: int, params: dict,
                    opt_state: dict | None = None,
                    iterator_state: dict | None = None,
                    extra: dict | None = None, keep: int = 3) -> str:
    """Write one checkpoint of numpy trees; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = msgpack_serialize({"step": int(step), "params": params,
                              "opt_state": opt_state if opt_state else {}})
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.msgpack")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    meta = {"step": step, "iterator_state": iterator_state or {},
            "extra": extra or {}}
    with open(path.replace(".msgpack", ".json"), "w") as f:
        json.dump(meta, f)
    _prune(ckpt_dir, keep)
    return path


def _checkpoints(ckpt_dir: str) -> list[str]:
    return sorted(f for f in os.listdir(ckpt_dir) if _CKPT.fullmatch(f))


def _prune(ckpt_dir: str, keep: int) -> None:
    for f in _checkpoints(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))
        sidecar = os.path.join(ckpt_dir, f.replace(".msgpack", ".json"))
        if os.path.exists(sidecar):
            os.remove(sidecar)


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def load_checkpoint(path: str):
    """-> (step, params tree, opt_state tree or None, iterator_state,
    extra); the trees are nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        state = msgpack_restore(f.read())
    meta_path = path.replace(".msgpack", ".json")
    iterator_state, extra = {}, {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        iterator_state = meta.get("iterator_state", {})
        extra = meta.get("extra", {})
    return (int(state["step"]), state["params"], state.get("opt_state") or None,
            iterator_state, extra)
