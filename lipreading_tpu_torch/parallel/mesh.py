"""The data x model mesh over ``torch.distributed`` and the layouts on it
(counterpart of ``lipreading_tpu/parallel/mesh.py``).

One process per rank. Global rank r sits at (r // mp, r % mp) of a dp x mp
grid: its data axis is the ranks of its column (the same model index), its
model axis those of its row. ``make_mesh`` reads ``cfg.mesh`` as the JAX
package does (``data_parallel=-1`` takes world // mp) and creates every
process group on every rank in one order (``new_group`` needs all of them
to call it). Without a process group the mesh is one rank.

* ``replicate``: every parameter broadcast from global rank 0.
* ``shard_batch``: this rank's rows of a global batch;
  ``shard_host_local_batch``: a rank's own rows, their count checked.
* ``model_param_plan``: the tensor-parallel plan of ``model_param_shardings``
  (the Megatron column/row layout of the transformer layers' ``attn``,
  ``self``, ``cross`` and ``mlp``), as {parameter: axis it is split
  along}; ``shard_params_`` cuts a model's planned parameters to this
  rank's part and hands its attention and MLP modules the model axis, and
  ``TensorParallel`` gathers and cuts them back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from lipreading_tpu_torch.config import MeshConfig
from lipreading_tpu_torch.parallel import comm
from lipreading_tpu_torch.parallel.comm import Axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A dp x mp grid of global ranks as ``rank`` sees it."""

    dp: int
    mp: int
    rank: int
    data: Axis                  # this rank's column: the same model index
    model: Axis                 # this rank's row: the same data index
    world: Axis                 # every rank of the process group

    @property
    def data_index(self) -> int:
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    @property
    def distributed(self) -> bool:
        return self.world.group is not None

    @property
    def devices(self) -> int:
        return self.dp * self.mp

    def barrier(self) -> None:
        comm.barrier(self.world)


def mesh_shape(cfg: MeshConfig, world: int) -> tuple[int, int]:
    """(dp, mp) of ``cfg`` over ``world`` ranks; raises as the JAX
    package's ``make_mesh`` does when the grid needs more."""
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else world // mp
    if dp * mp > world:
        raise ValueError(f"mesh {dp}x{mp} needs {dp*mp} devices, have {world}")
    return dp, mp


def make_mesh(cfg: MeshConfig | None = None, world: int | None = None,
              rank: int | None = None) -> Mesh:
    """The mesh of ``cfg`` over the process group (``world`` and ``rank``
    from it), or, with no process group, a layout of ``world`` ranks (1 by
    default) seen from ``rank`` without collectives."""
    cfg = cfg or MeshConfig()
    live = dist.is_available() and dist.is_initialized()
    if live:
        world, rank = dist.get_world_size(), dist.get_rank()
    world = 1 if world is None else world
    rank = 0 if rank is None else rank
    dp, mp = mesh_shape(cfg, world)
    columns = [tuple(d * mp + m for d in range(dp)) for m in range(mp)]
    rows = [tuple(d * mp + m for m in range(mp)) for d in range(dp)]
    groups = {}
    if live:
        # every rank creates every group, in this order
        for ranks in columns + rows:
            groups[ranks] = dist.new_group(list(ranks),
                                           timeout=comm.timeout())
    if not 0 <= rank < dp * mp:
        raise ValueError(f"rank {rank} lies outside the {dp}x{mp} mesh")
    col, row = columns[rank % mp], rows[rank // mp]
    return Mesh(
        dp=dp, mp=mp, rank=rank,
        data=Axis(groups.get(col), col, col.index(rank)),
        model=Axis(groups.get(row), row, row.index(rank)),
        world=Axis(dist.group.WORLD if live else None,
                   tuple(range(world)), rank),
    )


def _flat_sync(tensors: list[torch.Tensor], fn) -> None:
    """Run ``fn`` (an in-place collective) once over the tensors laid end
    to end, then copy the result back into each."""
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    fn(flat)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to global rank 0's."""
    if mesh.distributed:
        _flat_sync(list(module.parameters()) + list(module.buffers()),
                   lambda flat: comm.broadcast_(flat, mesh.world))
    return module


def _rows(batch, lo: int, hi: int):
    if isinstance(batch, dict):
        return {k: v[lo:hi] for k, v in batch.items()}
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[lo:hi]
        for f in dataclasses.fields(batch)})


def batch_rows(batch) -> int:
    if isinstance(batch, dict):
        return len(batch["frame_lengths"])
    return len(batch.frame_lengths)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a dict, ``Batch`` or
    ``VideoBatch``): the data index's 1/dp of them, in order."""
    B = batch_rows(batch)
    if B % mesh.dp:
        raise ValueError(f"batch of {B} does not split over {mesh.dp} data "
                         "ranks")
    n = B // mesh.dp
    return _rows(batch, mesh.data_index * n, (mesh.data_index + 1) * n)


def shard_host_local_batch(batch, mesh: Mesh, global_rows: int):
    """A rank's own rows of a global batch of ``global_rows``, as its input
    pipeline made them; raises unless they are 1/dp of it."""
    B = batch_rows(batch)
    if B * mesh.dp != global_rows:
        raise ValueError(f"a rank's batch holds {B} rows; the global batch "
                         f"of {global_rows} over {mesh.dp} data ranks gives "
                         f"{global_rows / mesh.dp:g}")
    return batch


# --- tensor parallelism -------------------------------------------------------

def _tp_layers(model: torch.nn.Module):
    """The transformer layers ``model_param_shardings`` shards: those of the
    encoder and the attention decoder that have ``ln1``."""
    for side in ("encoder", "att_decoder"):
        sub = getattr(model, side, None)
        layers = getattr(sub, "layers", None)
        if layers is not None and len(layers) and hasattr(layers[0], "ln1"):
            for i, lp in enumerate(layers):
                yield f"{side}.layers.{i}", lp


def model_param_plan(model: torch.nn.Module) -> dict[str, int]:
    """{parameter name: the axis it is split along over the model axis}:
    q, k, v and ``mlp.in`` by output columns (w axis 1, b axis 0), ``o`` and
    ``mlp.out`` by input rows (w axis 0; their biases replicate). Every
    other parameter replicates."""
    plan = {}
    for prefix, lp in _tp_layers(model):
        for key in ("attn", "self", "cross"):
            if hasattr(lp, key):
                for d in ("q", "k", "v"):
                    plan[f"{prefix}.{key}.{d}.w"] = 1
                    plan[f"{prefix}.{key}.{d}.b"] = 0
                plan[f"{prefix}.{key}.o.w"] = 0
        if hasattr(lp, "mlp"):
            plan[f"{prefix}.mlp.in.w"] = 1
            plan[f"{prefix}.mlp.in.b"] = 0
            plan[f"{prefix}.mlp.out.w"] = 0
    return plan


def _part(t: torch.Tensor, axis: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[axis] // n
    return t.narrow(axis, i * size, size)


class TensorParallel:
    """The tensor-parallel layout on one rank: ``plan`` over ``axis``."""

    def __init__(self, plan: dict[str, int], axis: Axis):
        self.plan = plan
        self.axis = axis

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole parameter."""
        if name not in self.plan:
            return full
        return _part(full, self.plan[name], self.axis.size, self.axis.index)

    def full(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole parameter from every rank's part (a collective: every
        rank of the axis calls it, in the same order)."""
        if name not in self.plan:
            return part
        return comm.gather_cat(part, self.axis, self.plan[name])

    def full_state(self, named: dict[str, torch.Tensor]) -> dict:
        return {k: self.full(k, v.detach()) for k, v in named.items()}


def shard_params_(model: torch.nn.Module, mesh: Mesh) -> TensorParallel:
    """Cut ``model``'s planned parameters to this rank's part and give its
    sharded attention and MLP modules the model axis (``models/
    transformer.py`` then computes on the local heads and columns)."""
    cfg = model.cfg.model
    n = mesh.mp
    if cfg.tf_heads % n or cfg.tf_mlp % n:
        raise ValueError(f"tensor parallelism over {n} ranks needs tf_heads "
                         f"({cfg.tf_heads}) and tf_mlp ({cfg.tf_mlp}) "
                         f"divisible by {n}")
    tp = TensorParallel(model_param_plan(model), mesh.model)
    for name, axis in tp.plan.items():
        owner, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        p = getattr(mod, leaf)
        setattr(mod, leaf, torch.nn.Parameter(
            tp.local(name, p.detach()).clone()))
    for _, lp in _tp_layers(model):
        for key in ("attn", "self", "cross", "mlp"):
            if hasattr(lp, key):
                getattr(lp, key).model_axis = mesh.model
    return tp


def rank_generator(gen: torch.Generator, device, *coords: int
                   ) -> torch.Generator:
    """A generator on ``device`` seeded from ``gen``'s seed and ``coords``
    (the counterpart of ``jax.random.fold_in`` over mesh indices): the same
    coordinates give the same masks, others independent ones."""
    seed = int(np.random.SeedSequence([gen.initial_seed(), *coords])
               .generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)
