"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` files are compiled by one ``nvcc`` call into one shared
library with a plain C interface, which ``ctypes`` loads. The library lands
in ``_build/<hash of the sources and flags>/`` inside the package (listed in
``.gitignore``), so a second run with the same sources loads it without
rebuilding. A failed build raises with nvcc's output. Nothing is built or
loaded at import time: the first wrapper that launches a kernel calls
``lib()``.

Each C entry takes raw device pointers and the CUDA stream as ``void*``,
launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; ``check`` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from ctypes import c_float, c_int, c_void_p

import torch

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(__file__), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# C entry -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # gray, boxes, out, N, H, W, R, mean, std, normalize, subpixel, stream
    "roi_sample": [c_void_p, c_void_p, c_void_p, c_int, c_int, c_int, c_int,
                   c_float, c_float, c_int, c_int, c_void_p],
    # logits, lengths, ids, counts, B, T, V, blank, stream
    "ctc_greedy": [c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_int,
                   c_int, c_int, c_void_p],
    # lp_ext, skip, input_lengths, label_lengths, alpha, nll, B, T, S, stream
    "ctc_lattice_fwd": [c_void_p] * 6 + [c_int] * 3 + [c_void_p],
    # lp_ext, skip, input_lengths, label_lengths, alpha, nll, g, grad,
    # B, T, S, stream
    "ctc_lattice_bwd": [c_void_p] * 8 + [c_int] * 3 + [c_void_p],
}


class _State:
    """The loaded library and what its build printed."""

    lib: ctypes.CDLL | None = None
    build_seconds: float | None = None
    build_log: str = ""
    path: str | None = None


STATE = _State()


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine that has the GPU")
    return found


def build() -> str:
    """Compile ``csrc/*.cu`` unless a library for these sources exists;
    returns its path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "liblipreading_kernels.so")
    if os.path.exists(lib_path):
        STATE.build_seconds = 0.0
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp,
           *[s for s in srcs if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    STATE.build_seconds = time.perf_counter() - t0
    STATE.build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{STATE.build_log}")
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The kernels' library, built at first use."""
    if STATE.lib is None:
        path = build()
        so = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = c_int
        STATE.lib, STATE.path = so, path
    return STATE.lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
