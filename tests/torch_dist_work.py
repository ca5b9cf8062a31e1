"""The ranks of the port's multi-process tests, importable without jax.

``spawn`` starts N rank processes over gloo (a ``FileStore`` under the
test's temporary directory, not a TCP port: the tier-1 run has 6 workers),
runs one work function on each and returns what each returned. A rank that
fails ends the run at once, its traceback in the raised error; every join
has a timeout, and ranks that outlive it are killed. The work functions
below are what the test files' ranks run: each runs all of its file's
cases in one spawn and returns numpy arrays, which the test process holds
against the JAX package and the one-process port.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np

JOIN_TIMEOUT = 240.0     # s a spawn may take, ranks started to ranks joined
RANK_TIMEOUT = 120.0     # s a rank's collective waits before it raises


def spawn(world: int, fn, args: tuple, tmp: str,
          timeout: float = JOIN_TIMEOUT, threads: int = 1) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks; returns
    their results in rank order."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    os.makedirs(tmp, exist_ok=True)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, tmp, fn, args, threads))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if not p.is_alive() and p.exitcode != 0]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"err{r}.txt")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if errors:
        raise RuntimeError("\n".join(errors))
    if any(p.is_alive() for p in procs):
        raise TimeoutError(f"ranks still running after {timeout:g} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, world, tmp, fn, args, threads):
    import torch
    import torch.distributed as dist

    from lipreading_tpu_torch.parallel import comm

    torch.set_num_threads(threads)
    try:
        comm.init("gloo", rank, world, seconds=RANK_TIMEOUT,
                  store=dist.FileStore(os.path.join(tmp, "store"), world))
        result = fn(rank, world, *args)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _np(t):
    """A float32 numpy copy (never a view of a live parameter)."""
    return t.detach().cpu().float().numpy().copy()


# --- test_torch_parallel_mesh: the collectives and replicate ----------------

def comm_cases(rank: int, world: int) -> dict:
    """The collectives on a 2 x 2 mesh of 4 ranks, forward and backward."""
    import torch

    from lipreading_tpu_torch.config import MeshConfig
    from lipreading_tpu_torch.parallel import comm
    from lipreading_tpu_torch.parallel.mesh import make_mesh, replicate

    mesh = make_mesh(MeshConfig(data_parallel=2, model_parallel=2))
    out = {"coords": (mesh.data_index, mesh.model_index),
           "data_ranks": mesh.data.ranks, "model_ranks": mesh.model.ranks}
    base = torch.arange(3, dtype=torch.float32) + 10 * rank

    x = base.clone().requires_grad_()
    y = comm.ppermute(x, mesh.model, 1)
    (y * (rank + 1)).sum().backward()
    out["ppermute"], out["ppermute_grad"] = _np(y), _np(x.grad)

    x = base.clone().requires_grad_()
    y = comm.psum(x, mesh.data)
    (y * (rank + 1)).sum().backward()
    out["psum"], out["psum_grad"] = _np(y), _np(x.grad)

    x = base.clone().requires_grad_()
    y = comm.copy(x, mesh.model)
    (y * (rank + 1)).sum().backward()
    out["copy"], out["copy_grad"] = _np(y), _np(x.grad)

    x = base.reshape(1, 3).clone().requires_grad_()
    y = comm.all_gather(x, mesh.world, 0)
    (y * torch.arange(world, dtype=torch.float32)[:, None]).sum().backward()
    out["all_gather"], out["all_gather_grad"] = _np(y), _np(x.grad)

    # low-precision and bool tensors cross the wire as their bits; sums of
    # bfloat16 run in float32
    xb = (base / 7).to(torch.bfloat16)
    out["ppermute_bf16"] = comm.ppermute(xb, mesh.model).float().numpy()
    out["psum_bf16"] = comm.psum(xb, mesh.world).float().numpy()
    out["ppermute_bool"] = comm.ppermute(
        torch.tensor([rank % 2 == 0, True]), mesh.world, 1).numpy()
    out["all_gather_bf16"] = comm.all_gather(
        xb.reshape(1, 3), mesh.world, 1).float().numpy()
    xb.requires_grad_()
    g = comm.all_gather(xb.reshape(1, 3), mesh.model, 0)
    (g.float() * 2).sum().backward()
    out["all_gather_bf16_grad"] = xb.grad.float().numpy()

    mod = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in mod.parameters():
            p.fill_(rank + 1.0)
    replicate(mod, mesh)
    out["replicated"] = np.concatenate(
        [_np(p).ravel() for p in mod.parameters()])
    mesh.barrier()
    return out


def timeout_case(rank: int, world: int) -> str:
    """Rank 0 waits for a message rank 1 never sends, with a 1 s limit."""
    import dataclasses

    import torch

    from lipreading_tpu_torch.config import MeshConfig
    from lipreading_tpu_torch.parallel import comm
    from lipreading_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(model_parallel=world))
    if rank == 0:
        short = dataclasses.replace(mesh.model, seconds=1.0)
        try:
            comm.send_recv(torch.zeros(2), short, 1)
        except (RuntimeError, TimeoutError) as e:
            return f"raised {type(e).__name__}"
        return "returned"
    time.sleep(3.0)
    return "idle"


# --- test_torch_ring and test_torch_pipeline_parallel: the encoders ---------

def encoder(model_kw: dict, in_dim: int, state: dict):
    """A ``TransformerEncoder`` of ``ModelConfig(**model_kw)`` holding
    ``state`` (numpy arrays by state_dict key)."""
    import torch

    from lipreading_tpu_torch.config import ModelConfig
    from lipreading_tpu_torch.models.transformer import TransformerEncoder

    enc = TransformerEncoder(ModelConfig(**model_kw), in_dim)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return enc


def _reduced_grads(enc, mesh, over_model, rows_split: bool) -> dict:
    """The encoder's gradients summed as the trainer sums them: the names
    ``over_model`` picks over the model axis, then every one over the data
    axis when each data rank held its own rows."""
    import torch

    from lipreading_tpu_torch.parallel import comm

    out = {}
    for name, p in enc.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if over_model(name):
            comm.all_reduce_(g, mesh.model)
        if rows_split:
            comm.all_reduce_(g, mesh.data)
        out[name] = _np(g)
    return out


def ring_cases(rank: int, world: int, model_kw: dict, state: dict, x, lengths,
               w, x3, lengths3) -> dict:
    """``ring_encoder_apply`` at mp 2 (data 2) and mp 4 over 4 ranks: the
    rows each rank computes and the gradients of ``sum(out * w)``; a batch
    of 3 that replicates over the data axis; dropout on identical data
    shards."""
    import torch

    from lipreading_tpu_torch.config import MeshConfig
    from lipreading_tpu_torch.parallel.mesh import make_mesh
    from lipreading_tpu_torch.parallel.ring import data_rows, ring_encoder_apply

    enc = encoder(model_kw, x.shape[-1], state)
    heads = model_kw["tf_heads"]
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    out = {}
    for mp in (2, 4):
        mesh = make_mesh(MeshConfig(model_parallel=mp))
        rows = data_rows(mesh, len(xt), False)
        enc.zero_grad(set_to_none=True)
        y = ring_encoder_apply(enc, xt, lt, heads, mesh)
        (y * torch.from_numpy(w[rows or slice(None)])).sum().backward()
        out[f"rows{mp}"] = (rows.start, rows.stop) if rows else (0, len(xt))
        out[f"fwd{mp}"] = _np(y)
        out[f"grad{mp}"] = _reduced_grads(enc, mesh, lambda n: True,
                                          rows is not None)
    mesh = make_mesh(MeshConfig(model_parallel=2))
    with torch.no_grad():
        out["fwd_b3"] = _np(ring_encoder_apply(
            enc, torch.from_numpy(x3), torch.from_numpy(lengths3), heads,
            mesh))
        gen = torch.Generator().manual_seed(3)
        same = xt[:1].repeat(2, 1, 1)
        out["dropout"] = _np(ring_encoder_apply(
            enc, same, lt[:1].repeat(2), heads, mesh, gen=gen, rate=0.5))
    return out


def pipeline_cases(rank: int, world: int, model_kw: dict, state: dict, x,
                   lengths, w) -> dict:
    """``pipeline_encoder_apply`` over 4 ranks at (mp, microbatches) (2, 2),
    (4, 2), (4, 4) and at (4, 2) with flash (its plain versions here): each
    rank's rows and the gradients of ``sum(out * w)``; dropout on identical
    data shards."""
    import torch

    from lipreading_tpu_torch.config import MeshConfig
    from lipreading_tpu_torch.parallel.mesh import make_mesh
    from lipreading_tpu_torch.parallel.pipeline import pipeline_encoder_apply
    from lipreading_tpu_torch.parallel.ring import data_rows

    enc = encoder(model_kw, x.shape[-1], state)
    heads = model_kw["tf_heads"]
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    out = {}
    for mp, mb, flash in ((2, 2, False), (4, 2, False), (4, 4, False),
                          (4, 2, True)):
        mesh = make_mesh(MeshConfig(model_parallel=mp))
        rows = data_rows(mesh, len(xt), False)
        key = f"{mp}_{mb}" + ("_flash" if flash else "")
        enc.zero_grad(set_to_none=True)
        y = pipeline_encoder_apply(enc, xt, lt, heads, mesh,
                                   microbatches=mb, flash=flash)
        (y * torch.from_numpy(w[rows or slice(None)])).sum().backward()
        out[f"rows{key}"] = (rows.start, rows.stop) if rows else (0, len(xt))
        out[f"fwd{key}"] = _np(y)
        out[f"grad{key}"] = _reduced_grads(
            enc, mesh, lambda n: n.startswith("layers."), rows is not None)
    mesh = make_mesh(MeshConfig(model_parallel=2))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(3)
        per = len(xt) // mesh.dp
        same_x = xt[:per].repeat(mesh.dp, 1, 1)
        same_l = lt[:per].repeat(mesh.dp)
        out["dropout"] = _np(pipeline_encoder_apply(
            enc, same_x, same_l, heads, mesh, microbatches=2, gen=gen,
            rate=0.5))
    return out


# --- test_torch_sharding: the Trainer over a mesh ---------------------------

SMALL = {"model.patch_dim": 16, "model.frontend_dim": 24, "model.tf_dim": 32,
         "model.tf_heads": 4, "model.tf_mlp": 64, "model.tf_layers": 2,
         "model.tf_dec_layers": 1, "model.highway_layers": 1,
         "model.framewise_norm": True, "model.dtype": "float32",
         "model.dropout": 0.0, "preprocess.roi_size": 32,
         "data.batch_size": 8, "train.warmup_steps": 0,
         "train.learning_rate": 1e-3}


def small_cfg():
    """The patchify flagship at tf_dim 32, 4 heads, MLP 64, 2 + 1 layers,
    float32, dropout off, 32 x 32 ROIs, a global batch of 8."""
    from lipreading_tpu_torch.config import preset

    return preset("transformer-patchify").override(**SMALL)


def ragged_batch(seed: int, B: int = 8, T: int = 16, L: int = 12) -> dict:
    """ROIs at random, ragged frame and target lengths (the CTC labels
    alignable), sample 5 weighted 0."""
    from lipreading_tpu_torch.text import Vocab

    rng = np.random.default_rng(seed)
    v = Vocab()
    fl = rng.integers(9, T + 1, B).astype(np.int32)
    fl[0] = T
    targets = np.zeros((B, L), np.int32)
    tl = np.zeros(B, np.int32)
    ctc = np.zeros((B, L), np.int32)
    cl = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(1, min(L - 2, (fl[i] - 1) // 2) + 1))
        ids = rng.integers(3, 31, n)
        targets[i, 0], targets[i, n + 1] = v.sos_id, v.eos_id
        targets[i, 1:n + 1] = ids
        tl[i] = n + 2
        ctc[i, :n] = ids
        cl[i] = n
    sw = np.ones(B, np.float32)
    sw[5] = 0.0
    return {"rois": rng.normal(0, 1, (B, T, 32, 32)).astype(np.float32),
            "frame_lengths": fl, "targets": targets, "target_lengths": tl,
            "ctc_labels": ctc, "ctc_lengths": cl, "sample_weight": sw}


LAYOUTS = {
    "dp4": {"mesh.data_parallel": 4},
    "dp2tp2": {"mesh.data_parallel": 2, "mesh.model_parallel": 2},
    "dp2sp2": {"mesh.data_parallel": 2, "mesh.model_parallel": 2,
               "mesh.sequence_parallel": True},
    "dp2pp2": {"mesh.data_parallel": 2, "mesh.model_parallel": 2,
               "mesh.pipeline_parallel": True,
               "mesh.pipeline_microbatches": 2},
    # flash attention's plain version here, on the local heads
    "dp2tp2flash": {"mesh.data_parallel": 2, "mesh.model_parallel": 2,
                    "model.flash_attention": True},
}


def whole_grads(tr) -> dict:
    """The trainer's reduced gradients, whole (gathered under tensor
    parallelism)."""
    out = {}
    for name, p in tr.model.named_parameters():
        g = p.grad.detach()
        out[name] = _np(tr.tp.full(name, g) if tr.tp is not None else g)
    return out


def whole_params(tr) -> dict:
    return {k: _np(v) for k, v in tr.whole_state_dict().items()}


def run_steps(tr, batches) -> dict:
    """Each global batch's rows of this rank through ``train_step``: the
    losses and norms of every step, the gradients of the first, the
    parameters after the last (whole), and a digest of those parameters'
    bytes to hold the ranks equal."""
    import hashlib

    from lipreading_tpu_torch.parallel.mesh import shard_batch

    keys = ("loss", "grad_norm", "ctc_loss", "att_loss")
    out = {k: [] for k in keys}
    for i, gb in enumerate(batches):
        m = tr.train_step(shard_batch(gb, tr.mesh))
        for k in keys:
            out[k].append(float(m[k]))
        if i == 0:
            out["grads"] = whole_grads(tr)
    out["params"] = whole_params(tr)
    out["digest"] = hashlib.sha256(b"".join(
        v.tobytes() for v in out["params"].values())).hexdigest()
    return out


def _state(tr) -> dict:
    """The trainer's whole parameters and Adam moments, and its counts."""
    opt = tr.opt.state_tree()["1"]
    flat = {f"p.{k}": v for k, v in whole_params(tr).items()}
    for name in ("mu", "nu"):
        for k, v in _leaves(opt["0"][name]):
            flat[f"{name}.{k}"] = v
    flat["count"] = np.asarray([opt["0"]["count"], opt["2"]["count"],
                                tr.step])
    return flat


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def trainer_cases(rank: int, world: int, cfg_dict: dict, batches: list,
                  tmp: str, jax_case: tuple | None, device: str = "cpu",
                  layouts: tuple = tuple(LAYOUTS)) -> dict:
    """Each of ``layouts`` over 4 ranks from one seeded initialisation:
    ``run_steps`` on ``batches``. Under DP 2 x TP 2 also a checkpoint after
    the steps and a trainer restored from it, both stepped once more on the
    first batch. ``jax_case`` (a config, a parameter tree, a ``Batch``):
    one DP 4 step's loss from that tree."""
    import torch

    from lipreading_tpu_torch.config import from_dict
    from lipreading_tpu_torch.parallel.mesh import shard_batch
    from lipreading_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    base = from_dict(cfg_dict)
    for name in layouts:
        cfg = base.override(**LAYOUTS[name])
        work = os.path.join(tmp, name)
        tr = Trainer(cfg, work, device=device)
        out[name] = run_steps(tr, batches)
        if name == "dp2tp2":
            out["ckpt"] = tr.save()
            again = Trainer(cfg, work, device=device)
            again.restore()
            out["resume_step"] = again.step
            out["resume_state_equal"] = _same(
                _state(tr), _state(again))
            for t in (tr, again):
                t.train_step(shard_batch(batches[0], t.mesh))
            a, b = whole_params(tr), whole_params(again)
            out["resume_equal"] = _same(a, b)
            # the k biases aside (their true gradient is 0)
            out["resume_rel"] = max(
                float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
                for k in a if not k.endswith(".k.b"))
            out["tp_local_shape"] = tuple(
                tr.model.encoder.layers[0].mlp.get_submodule("in").w.shape)
    if jax_case is None:
        return out
    jcfg, tree, batch = jax_case
    tr = Trainer(from_dict(jcfg), os.path.join(tmp, "jax"), device="cpu")
    tr.warm_start(tree)
    out["jax_dp4_loss"] = float(
        tr.train_step(shard_batch(batch, tr.mesh))["loss"])
    return out


# --- test_torch_train_ranks: the training entry on each rank ----------------

def entry_case(rank: int, world: int, argv: list) -> dict:
    """``python -m lipreading_tpu_torch.train`` on this rank as
    ``torch.distributed.run`` starts it (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` set; the group initialised by ``spawn``) -> its last
    metrics."""
    from lipreading_tpu_torch.train.__main__ import main

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    return main(argv)
