"""The reference's own reading of the weight files: flax's msgpack
(the release checkpoints under ``assets/``), the preprocessing ``.npz``
files and the release's config JSON. Imports nothing of the program; both
sides read the same raw files.

The msgpack reader follows the format (big-endian, flax's ndarray
extension 1 and numpy-scalar extension 3)."""

from __future__ import annotations

import json
import os
import struct

import numpy as np

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


def msgpack_restore(data: bytes):
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes after the document")
    return out


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts (or lists) of arrays -> {"a.b.0.w": array}."""
    out: dict[str, np.ndarray] = {}
    items = (tree.items() if isinstance(tree, dict)
             else ((str(i), v) for i, v in enumerate(tree)))
    for k, v in items:
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def load_release(assets_dir: str, name: str) -> tuple[dict, dict]:
    """``<name>.msgpack`` and ``<name>.json`` -> (flat float32 arrays,
    the release's config dict)."""
    with open(os.path.join(assets_dir, f"{name}.json")) as f:
        cfg = json.load(f)["config"]
    with open(os.path.join(assets_dir, f"{name}.msgpack"), "rb") as f:
        tree = msgpack_restore(f.read())
    return ({k: np.asarray(v, np.float32) for k, v in flatten(tree).items()},
            cfg)


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
