"""Training on the GPU (counterpart of ``scripts/train.py``):

    python -m lipreading_tpu_torch.train preset=transformer-patchify \\
        workdir=runs/ft init_from=transformer_hybrid_universal4 steps=10 \\
        [fused=1] [dataview=<dir>] [tracked=0] [n_clips=24] [data_seed=1] \\
        [variation=0.0] [variation_max=] [assets_variant=] [resume=1] \\
        [device=cuda] [key=value ...]

``preset`` is any preset of ``config.preset``: ``transformer-patchify``
(the default here), ``transformer-attn`` (the conv3d stem with the
transformer encoder and decoder) or ``bigru-ctc`` (the conv3d stem, the
bi-GRU and the CTC head; ``scripts/train.py``'s default), with
``init_from=bigru_ctc`` or ``init_from=transformer_hybrid_universal`` to
start from that family's release. Any decoder trains (``decoder=attention``
and ``decoder=hybrid`` give the bi-GRU the Bahdanau decoder).

Two paths, each evaluating on held-out clips every ``train.eval_every``
steps (the joint beam at ``train.beam_width`` for a hybrid model, the
model's own decoder otherwise):

* ``fused=1`` (the default here; ``scripts/train.py`` defaults to
  ``fused=0``): raw uint8 fixture frames rendered from ``data_seed`` ->
  detection, landmarks and ROIs on the device inside the step -> the model.
  ``tracked=1`` runs the tracked preprocessing (presence head, tracking,
  faceless frames compacted away). Held out: 4 clips from ``data_seed +
  999983``, up to 8 samples at the largest time bucket.
* ``fused=0`` or ``dataview=<dir>``: batches of a cached ROI dataview. With
  no ``index.json`` there (or no ``dataview=``, then ``workdir/dataview``)
  the fixture dataview of ``n_clips`` clips is built first, on the device;
  the held-out view (4 clips from ``data_seed + 999983``) goes to
  ``workdir/dataview_heldout``.

``variation`` (with ``variation_max``: a per-clip level drawn in [variation,
variation_max)) styles the clips of the dataviews it builds;
``assets_variant`` picks the preprocessing weights ("robust" whenever the
variation is above 0). On the fused path, as in ``scripts/train.py``, the
variation picks only the assets.
``preprocess.landmarker=conv`` takes the conv landmarker, ``train.remat=1``
recomputes the frontend in the backward, ``model.flash_attention=1`` runs
the encoder's attention through the flash kernels (``model.flash_bwd=auto|
xla|pallas|fused`` picks their backward). ``init_from=`` warm-starts the
parameters from a release in ``assets/`` or a checkpoint ``.msgpack`` (fresh
optimizer, step 0); ``resume=1`` continues from the latest checkpoint in
``workdir``, data position included. Any dotted config field can be
overridden (``train.learning_rate=1e-4``). It runs on the GPU unless
``device=cpu`` is given.

Several GPUs: one process a rank under ``torch.distributed.run``, the
``mesh.*`` overrides picking the layout of the model axis::

    python -m torch.distributed.run --nproc_per_node=4 \
        -m lipreading_tpu_torch.train mesh.data_parallel=2 \
        mesh.model_parallel=2 [mesh.sequence_parallel=1 | \
        mesh.pipeline_parallel=1 mesh.pipeline_microbatches=2] \
        [dist_backend=nccl|gloo] ...

With ``WORLD_SIZE`` set it reads ``RANK`` and ``LOCAL_RANK``, runs rank r on
``cuda:<LOCAL_RANK>`` (or the ``device=`` given: ``device=cuda:0`` puts
every rank on one card, which needs ``dist_backend=gloo``) and initialises
the process group over ``dist_backend`` (``nccl`` by default on the GPU,
``gloo`` on the CPU) with a timeout. Each rank draws its rows of every
global batch of ``data.batch_size``; rank 0 builds the fixture dataviews
(the others wait), prints, logs and writes the checkpoints. Without
``WORLD_SIZE`` it runs in this one process.
"""

from __future__ import annotations

import contextlib
import os
import sys

HELDOUT_SEED_OFFSET = 999_983
HELDOUT_CLIPS = 4
HELDOUT_SAMPLES = 8


def variation_args(args: dict):
    """Pop ``variation``, ``variation_max`` and ``assets_variant`` -> (a
    level or a (lo, hi) pair, the asset variant: "robust" by default when
    any level is above 0)."""
    variation = float(args.pop("variation", 0.0))
    vmax = args.pop("variation_max", None)
    if vmax is not None:
        variation = (variation, float(vmax))
    hi = variation[1] if isinstance(variation, tuple) else variation
    return variation, args.pop("assets_variant",
                               "robust" if hi > 0 else "default")


def _flag(args: dict, key: str, default: str) -> bool:
    return args.pop(key, default) in ("1", "true")


def _dataview_data(cfg, workdir, dataview_path, n_clips, data_seed,
                   variation, assets_variant, device):
    """The dataview path's dataset and held-out batches, building the
    fixture views where they are missing."""
    from lipreading_tpu_torch.data.dataset import BucketedDataset
    from lipreading_tpu_torch.data.dataview import (
        Dataview,
        build_fixture_dataview,
    )

    def view_at(path, clips, seed):
        if os.path.exists(os.path.join(path, "index.json")):
            return Dataview(path)
        print(f"building fixture dataview at {path} ...")
        return build_fixture_dataview(
            path, n_clips=clips, seed=seed, data_cfg=cfg.data,
            pre_cfg=cfg.preprocess, variation=variation,
            assets_variant=assets_variant, device=device)

    ds = BucketedDataset(
        view_at(dataview_path or os.path.join(workdir, "dataview"), n_clips,
                data_seed), cfg.data)
    ho = BucketedDataset(
        view_at(os.path.join(workdir, "dataview_heldout"), HELDOUT_CLIPS,
                data_seed + HELDOUT_SEED_OFFSET), cfg.data)
    return ds, [ho.make_batch(list(range(min(HELDOUT_SAMPLES, len(ho)))))]


def main(argv: list[str]) -> dict:
    from lipreading_tpu_torch.config import parse_overrides, preset

    args = parse_overrides(argv)
    cfg = preset(args.pop("preset", "transformer-patchify"))
    workdir = args.pop("workdir", f"runs/{cfg.name}")
    dataview_path = args.pop("dataview", None)
    fused = _flag(args, "fused", "1") and dataview_path is None
    tracked = _flag(args, "tracked", "0")
    steps = int(args.pop("steps", 0)) or None
    resume = _flag(args, "resume", "0")
    init_from = args.pop("init_from", None)
    n_clips = int(args.pop("n_clips", 24))
    data_seed = int(args.pop("data_seed", 1))
    device = args.pop("device", "cuda")
    backend = args.pop("dist_backend", None)
    variation, assets_variant = variation_args(args)
    if args:
        cfg = cfg.override(**args)
    if tracked and not fused:
        raise SystemExit("tracked=1 is a fused-path option; build a tracked "
                         "dataview with python -m "
                         "lipreading_tpu_torch.generate_dataview tracked=1")

    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to train on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False

    from lipreading_tpu_torch.io import load_preprocessors, load_release
    from lipreading_tpu_torch.parallel.mesh import make_mesh
    from lipreading_tpu_torch.train.checkpoint import load_checkpoint
    from lipreading_tpu_torch.train.loop import FusedTrainer, Trainer

    with ranks(device, backend) as device:
        mesh = make_mesh(cfg.mesh)
        chief = mesh.rank == 0
        shard = (mesh.data_index, mesh.dp)
        if fused:
            from lipreading_tpu_torch.data.pipeline import (
                FixtureVideoDataset,
                VideoBatchIterator as Iterator,
            )

            det, lmk, presence = load_preprocessors(
                cfg.preprocess.landmarker, assets_variant, tracked, device)
            trainer = FusedTrainer(cfg, workdir, det, lmk, device=device,
                                   presence=presence, tracked=tracked,
                                   mesh=mesh)
            ds = FixtureVideoDataset(n_clips, seed=data_seed, cfg=cfg.data)
            heldout = FixtureVideoDataset(
                HELDOUT_CLIPS, seed=data_seed + HELDOUT_SEED_OFFSET,
                cfg=cfg.data)
            eval_batches = [heldout.batch(
                list(range(min(HELDOUT_SAMPLES, len(heldout)))),
                max(cfg.data.time_buckets))]
        else:
            from lipreading_tpu_torch.data.dataset import (
                BatchIterator as Iterator,
            )

            def views():
                return _dataview_data(cfg, workdir, dataview_path, n_clips,
                                      data_seed, variation, assets_variant,
                                      device)

            # rank 0 builds the views that are missing; the others read them
            if chief:
                ds, eval_batches = views()
            if mesh.distributed:
                mesh.barrier()
            if not chief:
                ds, eval_batches = views()
            trainer = Trainer(cfg, workdir, device=device, mesh=mesh)
        if init_from:
            if os.path.exists(init_from):
                _, p0, _, _, _ = load_checkpoint(init_from)
            else:
                try:
                    p0, _ = load_release(init_from)
                except FileNotFoundError:
                    raise SystemExit(
                        f"init_from: no release asset {init_from!r}")
                init_from = f"assets/{init_from}"
            trainer.warm_start(p0)
            if chief:
                print(f"warm-started params from {init_from}")
        it_state = trainer.restore() if resume else {}
        if it_state and chief:
            print(f"resumed at step {trainer.step}")
        it = (Iterator.from_state(ds, cfg.data.batch_size, it_state, shard)
              if it_state else
              Iterator(ds, cfg.data.batch_size, seed=cfg.train.seed,
                       shard=shard))
        if chief:
            print(f"training {cfg.name} ({cfg.encoder}/{cfg.decoder}) on "
                  f"{len(ds)} samples ({'fused' if fused else 'dataview'}"
                  f"{', tracked' if tracked else ''}), device "
                  f"{trainer.device}, {mesh.devices} device(s)")
        last = trainer.fit(it, steps=steps, eval_batches=eval_batches)
        trainer.save(it)
        if chief:
            print("final:", last)
        return last


@contextlib.contextmanager
def ranks(device: str, backend: str | None):
    """Under ``torch.distributed.run`` (``WORLD_SIZE`` set), this rank's
    device, with its process group initialised (unless it already is) and
    destroyed after; otherwise ``device`` as given."""
    if "WORLD_SIZE" not in os.environ:
        yield device
        return
    import torch
    import torch.distributed as dist

    from lipreading_tpu_torch.parallel import comm

    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    if dist.is_initialized():
        yield device
        return
    comm.init(backend or ("nccl" if device.startswith("cuda") else "gloo"),
              int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
              init_method="env://")
    try:
        yield device
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
