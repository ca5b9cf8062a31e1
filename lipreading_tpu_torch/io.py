"""Reading and writing flax's msgpack trees without JAX, flax or msgpack.

* ``msgpack_restore``: a pure-Python msgpack decoder for what flax's
  ``serialization.msgpack_serialize`` writes (maps, arrays, strings, bytes,
  integers, floats, nil and booleans, and flax's ndarray extension: ext type 1
  holding a packed ``(shape, dtype name, raw bytes)`` triple).
* ``msgpack_serialize``: its inverse, byte for byte what flax writes for the
  same tree (checkpoints, ``train/checkpoint.py``).
* ``load_release``: a release checkpoint of ``assets/`` and its config.
* ``load_assets``: the preprocessing weights (``detector.npz``, ``ert.npz``).
* ``from_jax_params``: a numpy parameter tree, from a release or from the JAX
  package's ``init_model``, turned into the ``state_dict`` of
  ``models.lipreader.LipReader``; ``to_jax_params`` is its inverse, the
  nested tree a flax checkpoint stores.

Nothing converted is written to disk: a release is decoded in memory at every
load.
"""

from __future__ import annotations

import json
import os
import struct
from collections import OrderedDict

import numpy as np
import torch

from lipreading_tpu_torch.config import Config, from_dict
from lipreading_tpu_torch.models.lipreader import LipReader
from lipreading_tpu_torch.oracle.detector import load_params
from lipreading_tpu_torch.oracle.ert import ERTModel

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Cursor over one msgpack buffer (big-endian, as the format defines)."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, raw = _Reader(payload).value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode("ascii")
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def _pack_len(out: bytearray, n: int, small: int | None, small_max: int,
              codes: tuple[int, int, int]) -> None:
    """A length header: ``small | n`` when ``n <= small_max`` (if the type
    has a fixed form), else the 8-, 16- or 32-bit form in ``codes`` (None
    where the type has no such form)."""
    if small is not None and n <= small_max:
        out.append(small | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    for lo, hi, code, fmt in ((0x80, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
                              (0x100, 0xFFFF, 0xCD, ">H"),
                              (-0x8000, -0x81, 0xD1, ">h"),
                              (0x10000, 0xFFFFFFFF, 0xCE, ">I"),
                              (-0x80000000, -0x8001, 0xD2, ">i"),
                              (0x100000000, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -0x80000001, 0xD3, ">q")):
        if lo <= v <= hi:
            out += struct.pack(">B", code) + struct.pack(fmt, v)
            return
    raise OverflowError(f"msgpack: integer {v} does not fit in 64 bits")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _pack_ndarray(arr: np.ndarray) -> bytes:
    inner = bytearray()
    _pack(inner, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(inner)


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out += struct.pack(">Bd", 0xCB, v)
    elif type(v) is str:
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif type(v) is bytes:
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif type(v) is dict:
        # flax copies the tree with jax.tree_util.tree_map first, which
        # sorts every dict's keys
        _pack_len(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        for k in sorted(v):
            _pack(out, k)
            _pack(out, v[k])
    elif type(v) is list:
        _pack_len(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _pack_ndarray(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _pack_ndarray(np.asarray(v)))
    else:
        raise TypeError(f"msgpack: cannot serialise {type(v).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts, lists, numpy arrays and scalars, str, bytes,
    int, float, bool and None as ``flax.serialization.msgpack_serialize``
    does (dict keys sorted, ndarrays as ext type 1, numpy scalars as ext
    type 3). Arrays of
    2**30 bytes or more, which flax would cut into chunks, are refused."""
    def walk(x):
        if isinstance(x, np.ndarray) and x.nbytes >= 2 ** 30:
            raise ValueError("msgpack: arrays of 1 GiB or more are not "
                             "supported")
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(tree)
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def msgpack_restore(data: bytes):
    """Decode one msgpack document written by flax (the tree of dicts, lists
    and numpy arrays that ``flax.serialization.msgpack_restore`` returns)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes after the document")
    return out


def load_release(name: str, assets_dir: str | None = None):
    """``assets/<name>.msgpack`` + ``<name>.json`` -> (numpy tree, Config)."""
    d = assets_dir or ASSETS_DIR
    with open(os.path.join(d, f"{name}.json")) as f:
        cfg = from_dict(json.load(f)["config"])
    with open(os.path.join(d, f"{name}.msgpack"), "rb") as f:
        tree = msgpack_restore(f.read())
    return tree, cfg


def load_assets(assets_dir: str | None = None):
    """Preprocessing weights (``detector.npz``, ``ert.npz``) ->
    (detector params dict, ERTModel)."""
    d = assets_dir or ASSETS_DIR
    det = load_params(os.path.join(d, "detector.npz"))
    ert = ERTModel.load(os.path.join(d, "ert.npz"))
    return det, ert


def from_jax_params(tree, cfg: Config) -> "OrderedDict[str, torch.Tensor]":
    """Numpy parameter tree -> ``LipReader(cfg).state_dict()``.

    The port's modules keep the JAX package's parameter names and layouts
    (dense ``w`` is [in, out], conv ``w`` is DHWIO), so a leaf's path joined
    with "." is its ``state_dict`` key. Lists (from ``init_model``) and
    dicts keyed "0", "1", ... (from a msgpack release) give the same keys.
    Leaves of the attention decoder are dropped: that decoder is not ported
    yet. Leaves may be numpy arrays or anything ``np.asarray`` reads.
    """
    if cfg.encoder != "transformer" or cfg.model.frontend != "patchify":
        raise NotImplementedError(
            "only the patchify + transformer model family is ported; the "
            "conv3d stem and the bi-GRU are a later slice")
    out: OrderedDict[str, torch.Tensor] = OrderedDict()

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = ((str(i), v) for i, v in enumerate(node))
        else:
            arr = np.asarray(node)
            if arr.dtype != np.float32:
                raise ValueError(f"{prefix}: expected float32, got {arr.dtype}")
            out[prefix] = torch.from_numpy(np.array(arr, copy=True))
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    return out


def to_jax_params(state: "dict[str, torch.Tensor]") -> dict:
    """A flat ``{"a.b.0.w": tensor}`` mapping (a ``state_dict``, or the
    optimizer's moments) -> the nested tree of numpy arrays that flax stores,
    with every list index a key "0", "1", ..."""
    root: dict = {}
    for name, t in state.items():
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().cpu().numpy()
    return root


def load_release_model(name: str = "transformer_hybrid_universal4",
                       device: str | torch.device = "cuda",
                       assets_dir: str | None = None):
    """A release checkpoint as a ``LipReader`` on ``device`` -> (model, cfg)."""
    tree, cfg = load_release(name, assets_dir)
    model = LipReader(cfg)
    model.load_state_dict(from_jax_params(tree, cfg))
    return model.to(device).eval(), cfg
