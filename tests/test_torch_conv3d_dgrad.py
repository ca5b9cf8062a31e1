"""The input gradient of the stride-1 convolutions (``models/nn.py``:
``conv3d_dgrad``, ``conv3d_dgrad_plain``, the autograd function that
``nn.conv3d`` routes bf16 calls through) on the CPU. The Hopper kernel
itself (``csrc/conv3d_dgrad.cu``) runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``[conv-dgrad]``);
here its schedule of slabs and shifted taps is replayed in float32.

Geometries: the stems' kernels (3x5x5 32 <- 64 and 3x3x3 64 <- 96 of the
conv3d stem, 3x3x3 256 <- 256 of the patchify stem with its channels cut
to 64 for time) at small clips, and an odd T, H and W.

Tolerances: float32 1e-5 of the largest value (the same products summed
in another order); bf16 one bf16 ulp at the largest value (2^-8 of it:
both sides sum in float32 and round once); the stem's loss and gradients
within ``tests/test_torch_bigru_family.py``'s limits (loss rtol 1e-5,
gradients rtol 1e-3 with atol 1e-6 + 1e-4 of the leaf's largest entry)."""

import pytest
import torch

from lipreading_tpu_torch import profiling
from lipreading_tpu_torch.config import preset
from lipreading_tpu_torch.models import frontend3d as tfe
from lipreading_tpu_torch.models import lipreader as tlr
from lipreading_tpu_torch.models import nn as lnn
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

# name -> (kernel, Cin, Cout, (B, T, H, W))
GEOMETRIES = {
    "conv1": ((3, 5, 5), 32, 64, (2, 4, 8, 8)),
    "conv2": ((3, 3, 3), 64, 96, (2, 4, 6, 6)),
    "convA_cut": ((3, 3, 3), 64, 64, (1, 3, 6, 6)),
    "odd": ((3, 5, 5), 8, 16, (1, 7, 5, 3)),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(name, dtype, seed=0):
    k, cin, cout, (B, T, H, W) = GEOMETRIES[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T, H, W, cin), generator=g).to(dtype)
    w = (torch.randn((*k, cin, cout), generator=g) * 0.1).to(dtype)
    b = torch.randn((cout,), generator=g).to(dtype)
    gy = torch.randn((B, T, H, W, cout), generator=g).to(dtype)
    return x, w, b, gy


def _old(x, w, b, strides=(1, 1, 1)):
    """The parent's convolution: autograd through cuDNN's (here the CPU's)
    convolution."""
    return lnn._conv(x, w, strides)[0] + b


def _close(got, want, dtype):
    scale = want.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plain_dgrad_matches_autograd(name, dtype):
    dt = DTYPES[dtype]
    x, w, b, gy = _inputs(name, dt)
    x.requires_grad_()
    want = torch.autograd.grad(_old(x, w, b), x, gy)[0]
    got = lnn.conv3d_dgrad_plain(gy, w)
    assert got.dtype == dt and got.shape == x.shape
    _close(got, want, dt)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(lnn.conv3d_dgrad(gy, w), got)


def _blocked_dgrad(dy, w):
    """The kernel's schedule (``csrc/conv3d_dgrad.cu``) in float32: blocks
    of BM positions; for each time tap and 64-channel chunk of Cout a slab
    of SR rows of dY from m0 + (jt - qT) H W - qH W - qW; for each spatial
    tap the slab's rows shifted by jh W + jw, a zero row where the tap
    falls outside the clip (or past M)."""
    B, T, H, W, Cout = dy.shape
    kT, kH, kW, Cin = w.shape[:4]
    wt, (qT, qH, qW) = lnn._dgrad_operands(w.float(), (T, H, W))
    NT = next((n for n in (32, 64, 128) if Cin <= n), 256)
    BM = 256 if NT <= 64 else 128
    M, HW = B * T * H * W, H * W
    SR = BM + (kH - 1) * W + (kW - 1)
    flat = dy.float().reshape(M, Cout)
    dx = torch.zeros(M, Cin)

    def inside(v, n):
        return (v >= 0) & (v < n)

    rb = torch.arange(BM)
    for m0 in range(0, M, BM):
        m = m0 + rb
        t, h, ww = (m // HW) % T, (m // W) % H, m % W
        acc = torch.zeros(BM, Cin)
        for jt in range(kT):
            for c0 in range(0, Cout, 64):
                n = min(64, Cout - c0)
                f = m0 + (jt - qT) * HW - qH * W - qW + torch.arange(SR)
                ok = (f >= 0) & (f < M)
                slab = torch.zeros(SR, n)
                slab[ok] = flat[f[ok], c0:c0 + n]
                for jh in range(kH):
                    for jw in range(kW):
                        valid = ((m < M) & inside(t + jt - qT, T)
                                 & inside(h + jh - qH, H)
                                 & inside(ww + jw - qW, W))
                        a = torch.where(valid[:, None],
                                        slab[rb + jh * W + jw], 0.0)
                        acc += a @ wt[:, jt, jh, jw, c0:c0 + n].T
        keep = m < M
        dx[m[keep]] = acc[keep]
    return dx.reshape(B, T, H, W, Cin)


@pytest.mark.parametrize("name", list(GEOMETRIES) + ["ragged"])
def test_kernel_schedule_matches_plain(name):
    """The slabs, their shifts and the zero rows cover every (position,
    tap) once: M not a multiple of the block (``ragged``: 3 x 5 x 7 x 9
    positions, 96 channels in two chunks, N tile 128)."""
    if name == "ragged":
        g = torch.Generator().manual_seed(1)
        dy = torch.randn((3, 5, 7, 9, 96), generator=g)
        w = torch.randn((3, 3, 5, 72, 96), generator=g) * 0.1
    else:
        _, w, _, dy = _inputs(name, torch.float32)
    want = lnn.conv3d_dgrad_plain(dy, w)
    _close(_blocked_dgrad(dy, w), want, torch.float32)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_function_forward_and_weight_gradient_are_the_old_paths(name):
    """In bf16 the routed convolution's output and weight gradient are the
    same bytes as autograd's through the same convolution; its input
    gradient is the plain version's."""
    x, w, b, gy = _inputs(name, torch.bfloat16)
    w32, b32 = w.float(), b.float()
    got, want = {}, {}
    for out, fn in ((got, lambda xr, wr: lnn.conv3d(xr, wr, b32, (1, 1, 1),
                                                    torch.bfloat16)),
                    (want, lambda xr, wr: _old(xr, wr.to(torch.bfloat16),
                                               b32.to(torch.bfloat16)))):
        xr, wr = x.clone().requires_grad_(), w32.clone().requires_grad_()
        y = fn(xr, wr)
        out["y"] = y
        out["dx"], out["dw"] = torch.autograd.grad(y, (xr, wr), gy)
    assert torch.equal(got["y"], want["y"])
    assert torch.equal(got["dw"], want["dw"])
    assert torch.equal(got["dx"], lnn.conv3d_dgrad_plain(gy, w))
    _close(got["dx"], want["dx"], torch.bfloat16)


def _routed(case):
    """How often ``conv3d.dgrad`` counts in one traced unit for ``case``."""
    x, w, b, _ = _inputs("odd", torch.bfloat16)
    strides = (1, 1, 1)
    if case == "float32":
        x, w, b = x.float(), w.float(), b.float()
    if case == "stride2":
        strides = (1, 2, 2)
    if case != "input_without_grad":
        x.requires_grad_()
    before = profiling.trace_totals()["counters"].get("conv3d.dgrad", 0)
    with profiling.unit("test.conv", "cpu"):
        if case == "no_grad":
            with torch.no_grad():
                lnn.conv3d(x, w, b, strides)
        else:
            lnn.conv3d(x, w, b, strides)
    return profiling.trace_totals()["counters"].get("conv3d.dgrad", 0) - before


@pytest.mark.parametrize("case,want", [
    ("bf16_grad", 1), ("stride2", 0), ("float32", 0), ("no_grad", 0),
    ("input_without_grad", 0)])
def test_routing_rule(case, want):
    """bf16 + grad mode + an input that needs a gradient + stride 1
    engages the function; every other call keeps autograd's path."""
    assert _routed(case) == want


def test_wrapper_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match=r"\[B, T, H, W, Cout\]"):
        lnn.conv3d_dgrad(torch.zeros(1, 2, 3, 3, 8), torch.zeros(3, 3, 3, 4, 6))
    # the plain version counts no launch
    before = lnn.conv3d_dgrad.launches
    lnn.conv3d_dgrad(torch.zeros(1, 2, 3, 3, 8), torch.zeros(3, 3, 3, 4, 8))
    assert lnn.conv3d_dgrad.launches == before


def _routed_float32(x, w, b, strides=(1, 1, 1), dtype=None):
    """``nn.conv3d`` with the routing rule's dtype condition left out: the
    function in float32 too."""
    if dtype is not None:
        w, b = w.to(dtype), b.to(dtype)
    if x.requires_grad and tuple(strides) == (1, 1, 1):
        return lnn._Conv3dDgrad.apply(x, w) + b
    return lnn._conv(x, w, strides)[0] + b


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv3d_stem_loss_and_gradients_match_the_old_path(dtype,
                                                           monkeypatch):
    """The conv3d stem (conv1 and conv2 through the function, conv0
    strided) against the same stem with the routing taken out: its loss
    and every parameter's gradient. Float32 (the function forced there)
    within the family's limits, but for a leaf whose gradient norm is under
    a thousandth of the median leaf's (round-off: conv0's bias, whose
    GroupNorm takes its mean away; the benchmark's training comparison
    leaves such leaves out too). bf16 routes by itself: its loss is the
    same bytes, and each leaf's gradient lies within 2^-8 (one bf16 ulp)
    of the larger of its norm and the median leaf's, by the norm of the
    difference: dX one ulp apart flips bf16 roundings upstream (conv0's
    and conv1's weight gradients, conv0's bias, a sum that cancels)."""
    dt = DTYPES[dtype]
    cfg = preset("bigru-ctc").override(**{
        "model.frontend_channels": (8, 16, 24), "model.frontend_dim": 32,
        "model.dropout": 0.0})
    model = tlr.init_model(cfg, torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(6)
    rois = torch.randn((2, 5, 96, 96), generator=g)
    r = torch.randn((2, 5, 32), generator=g)
    params = dict(model.frontend.named_parameters())

    def loss_and_grads():
        out = tfe.frontend_apply(model.frontend, rois, dt)
        loss = (out.float() * r).sum()
        return loss.item(), torch.autograd.grad(loss, list(params.values()))

    with monkeypatch.context() as mp:
        if dt == torch.float32:
            mp.setattr(lnn, "conv3d", _routed_float32)
        before = profiling.trace_totals()["counters"].get("conv3d.dgrad", 0)
        with profiling.unit("test.stem", "cpu"):
            loss, grads = loss_and_grads()
        counted = (profiling.trace_totals()["counters"].get("conv3d.dgrad", 0)
                   - before)
        launches = lnn.conv3d_dgrad.launches
        mp.setattr(lnn, "conv3d_dgrad", lambda dy, w: pytest.fail("routed"))
        mp.setattr(lnn._Conv3dDgrad, "apply",
                   lambda x, w: lnn._conv(x, w, (1, 1, 1))[0])
        loss_old, grads_old = loss_and_grads()
    assert counted == (2 if dt == torch.bfloat16 else 0)
    assert lnn.conv3d_dgrad.launches == launches
    if dt == torch.float32:
        assert abs(loss - loss_old) <= 1e-5 * abs(loss_old)
    else:
        assert loss == loss_old
    med = torch.stack([b.norm() for b in grads_old]).median().item()
    for name, a, b in zip(params, grads, grads_old):
        if dt == torch.float32:
            if b.norm().item() < 1e-3 * med:
                continue
            torch.testing.assert_close(
                a, b, rtol=1e-3, atol=1e-6 + 1e-4 * b.abs().max().item(),
                msg=lambda m, name=name: f"{name}: {m}")
        else:
            gap = (a - b).norm().item() / max(b.norm().item(), med)
            assert gap <= 2.0 ** -8, (name, gap)
