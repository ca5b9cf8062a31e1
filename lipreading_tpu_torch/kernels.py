"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, which ``ctypes`` loads. The library lands
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
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # gray, boxes, out, N, H, W, R, mean, std, normalize, subpixel, tpr,
    # rpp, band, threads, smem (ops.roi.roi_plan), stream
    "roi_sample": [c_void_p] * 3 + [c_int] * 4 + [c_float] * 2
                  + [c_int] * 7 + [c_void_p],
    # differ (three uint32), stream
    "roi_div255_check": [c_void_p, c_void_p],
    # logits, lengths, ids, counts, B, T, V, blank, sV, chunk, nbuf,
    # buf_floats, threads, smem (ops.decode.greedy_plan), stream
    "ctc_greedy": [c_void_p] * 4 + [c_int] * 10 + [c_void_p],
    # lp_ext, skip, input_lengths, label_lengths, alpha, nll, B, T, S,
    # W, K (ops.ctc.lattice_plan), stream
    "ctc_lattice_fwd": [c_void_p] * 6 + [c_int] * 5 + [c_void_p],
    # lp_ext, skip, input_lengths, label_lengths, alpha, nll, g, grad,
    # B, T, S, W, K, stream
    "ctc_lattice_bwd": [c_void_p] * 8 + [c_int] * 5 + [c_void_p],
    # out, steps, backward, stream
    "ctc_chain_probe": [c_void_p, c_int, c_int, c_void_p],
    # differ (one uint32), stream
    "ctc_log1p_check": [c_void_p, c_void_p],
    # stream: an empty kernel of one block (the launch floor)
    "noop_kernel": [c_void_p],
    # q, k, v, lengths, out, lse (or NULL), B, T, H, D, bf16, scale, stream
    "flash_fwd": [c_void_p] * 6 + [c_int] * 5 + [c_float, c_void_p],
    # q, k, v, lengths, dout, delta, lse, dq, B, T, H, D, bf16, scale, stream
    "flash_bwd_dq": [c_void_p] * 8 + [c_int] * 5 + [c_float, c_void_p],
    # q, k, v, lengths, dout, delta, lse, dk, dv, B, T, H, D, bf16, scale,
    # stream
    "flash_bwd_dkv": [c_void_p] * 9 + [c_int] * 5 + [c_float, c_void_p],
    # q, k, v, lengths, dout, delta, lse, dq_ws, dq, dk, dv, B, T, H, D,
    # bf16, scale, stream
    "flash_bwd_fused": [c_void_p] * 11 + [c_int] * 5 + [c_float, c_void_p],
    # dy, wt, dx, B, T, H, W, Cin, Cout, kT, kH, kW, qT, qH, qW, stream
    "conv3d_dgrad": [c_void_p] * 3 + [c_int] * 12 + [c_void_p],
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
    """Compile ``csrc/*.cu`` (one ``nvcc`` per source, in parallel) and link
    them, unless a library for these sources exists; returns its path."""
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
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"== {os.path.basename(cmd[-1])}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    tmp = f"{lib_path}.{tag}"
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}): {' '.join(cmd)}")
    STATE.build_seconds = time.perf_counter() - t0
    STATE.build_log = "\n".join(logs)
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed) + "\n" + STATE.build_log)
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
    """Raise if a C entry reported a CUDA error (> 0) or refused its
    arguments (< 0: a launch plan it was not built for)."""
    if err < 0:
        raise RuntimeError(f"{name}: the C entry refused its launch plan "
                           f"({err})")
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream

