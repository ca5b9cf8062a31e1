"""The collectives of the multi-GPU layouts, over ``torch.distributed``.

The JAX package runs one SPMD program over a device mesh, and ``shard_map``
and the SPMD partitioner insert its collectives. Here each rank is a
process, and these functions are those collectives written out. Each takes
an ``Axis``: one axis of the mesh as this rank sees it (its process group,
the global ranks along it, this rank's index). The differentiable ones are
``torch.autograd.Function``s whose backward is JAX's transpose:

* ``ppermute(x, axis, shift)``: send to index + shift, receive from
  index - shift, around the ring; backward the inverse shift;
* ``psum(x, axis)``: all-reduce sum forward, identity backward (Megatron's
  "reduce": every rank downstream computes the same thing, so the
  cotangent is already whole on each);
* ``copy(x, axis)``: identity forward, all-reduce backward (Megatron's
  "copy": each rank's branch adds its share of the input's gradient);
* ``all_gather(x, axis, dim)``: the ranks' tensors concatenated along
  ``dim``; backward this rank's slice of the gradient (everything after the
  gather runs identically on every rank of the axis, so no reduce-scatter).

A differentiable collective's backward runs on every rank only if each
rank's graph holds it, so the callers keep every rank's graph the same
shape (``parallel/pipeline.py`` injects with ``torch.where``).

Every wait has a timeout (``Axis.timeout``, ``DIST_TIMEOUT_S`` by default),
and a collective that fails or times out raises: nothing carries on alone.
The backend is the caller's choice (``init``); none is tried after another
fails. Under gloo every collective stages a CUDA tensor through a host
tensor: gloo's send and receive refuse CUDA tensors ("writev ... Bad
address", which can abort the process), while its all-reduce, broadcast
and all-gather take them; staging all of them keeps one path. Sums
of bfloat16 or float16 run in float32 and round once; tensors that only
move cross the wire as their bytes (a ``uint8`` view; gloo's collectives
take no bfloat16 or int16), so every backend moves every dtype.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist

DIST_TIMEOUT_S = 300.0


def timeout(seconds: float = DIST_TIMEOUT_S) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def init(backend: str, rank: int, world_size: int, *, init_method=None,
         store=None, seconds: float = DIST_TIMEOUT_S) -> None:
    """``init_process_group`` with ``backend`` ("nccl" or "gloo") and a
    timeout on every collective; raises if it fails."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend must be nccl or gloo, got {backend!r}")
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size,
                            timeout=timeout(seconds))


@dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it. ``group`` is None when no
    process group exists (one process); collectives then need ``size``
    1."""

    group: "dist.ProcessGroup | None"
    ranks: tuple[int, ...]          # global ranks along the axis, in order
    index: int                      # this rank's position among them
    seconds: float = DIST_TIMEOUT_S

    @property
    def size(self) -> int:
        return len(self.ranks)

    def peer(self, shift: int) -> int:
        """The global rank ``shift`` places along the ring from this one."""
        return self.ranks[(self.index + shift) % self.size]


def _live(axis: Axis) -> bool:
    if axis.group is None:
        if axis.size != 1:
            raise RuntimeError(f"an axis of size {axis.size} without a "
                               "process group")
        return False
    return True


def _wait(works, axis: Axis) -> None:
    for w in works if isinstance(works, list) else [works]:
        if w is not None and not w.wait(timeout(axis.seconds)):
            raise TimeoutError(f"a collective over ranks {axis.ranks} did "
                               f"not finish in {axis.seconds:g} s")


def _staged(axis: Axis, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(axis.group) == "gloo"


_BYTES = (torch.bfloat16, torch.float16, torch.bool)


def _to_wire(axis: Axis, x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor holding ``x``'s bits, on the host under gloo (a
    uint8 view widens the last axis: a concatenation along any axis is
    still the elements' concatenation)."""
    x = x.contiguous()
    if x.dtype in _BYTES:
        x = x.view(torch.uint8)
    return x.cpu() if _staged(axis, x) else x


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype in _BYTES:
        w = w.view(like.dtype)
    return w.to(like.device)


# --- plain (non-differentiable) collectives ---------------------------------

def all_reduce_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``x`` over the axis in place (low-precision floats summed in
    float32); returns ``x``."""
    if not _live(axis):
        return x
    w = x.detach().float() if x.dtype in (torch.bfloat16, torch.float16) \
        else x.detach().contiguous()
    if _staged(axis, w):
        w = w.cpu()
    _wait(dist.all_reduce(w, group=axis.group, async_op=True), axis)
    with torch.no_grad():
        x.copy_(w.to(x.device, x.dtype))
    return x


def broadcast_(x: torch.Tensor, axis: Axis, src: int = 0) -> torch.Tensor:
    """Overwrite ``x`` with the tensor of the rank at index ``src``."""
    if not _live(axis):
        return x
    w = _to_wire(axis, x.detach())
    _wait(dist.broadcast(w, src=axis.ranks[src], group=axis.group,
                         async_op=True), axis)
    with torch.no_grad():
        x.copy_(_from_wire(w, x))
    return x


def gather_cat(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The axis's tensors (same shape on each rank) concatenated along
    ``dim``, in axis order."""
    if not _live(axis):
        return x
    w = _to_wire(axis, x.detach())
    parts = [torch.empty_like(w) for _ in range(axis.size)]
    _wait(dist.all_gather(parts, w, group=axis.group, async_op=True), axis)
    return torch.cat([_from_wire(p, x) for p in parts], dim=dim)


def send_recv(x: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    """Send ``x`` to index + shift and return what index - shift sent."""
    if not _live(axis) or axis.size == 1:
        return x.clone()
    w = _to_wire(axis, x.detach())
    out = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, axis.peer(shift), axis.group),
           dist.P2POp(dist.irecv, out, axis.peer(-shift), axis.group)]
    _wait(dist.batch_isend_irecv(ops), axis)
    return _from_wire(out, x)


def barrier(axis: Axis) -> None:
    """Wait until every rank of the axis arrives (an all-reduce of one
    value, so it honours the timeout on every backend)."""
    if _live(axis):
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(axis.group) == "nccl" else torch.device("cpu")
        all_reduce_(torch.zeros(1, device=dev), axis)


# --- differentiable collectives ---------------------------------------------

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return send_recv(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return send_recv(g, ctx.axis, -ctx.shift), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        return g.narrow(ctx.dim, ctx.axis.index * n, n), None, None


def ppermute(x: torch.Tensor, axis: Axis, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` around the ring: this rank receives the tensor of
    index - shift; the gradient travels the other way."""
    if x.requires_grad:
        return _PPermute.apply(x, axis, shift)
    return send_recv(x, axis, shift)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """All-reduce sum; the backward passes the gradient through."""
    return _PSum.apply(x, axis)


def copy(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity; the backward sums the gradient over the axis."""
    return _Copy.apply(x, axis)


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The axis's blocks concatenated along ``dim``; the backward returns
    this rank's block of the gradient."""
    return _AllGather.apply(x, axis, dim)
