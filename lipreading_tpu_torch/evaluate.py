"""CER and WER of a trained model on held-out fixture clips or on a dataview
split (counterpart of ``scripts/evaluate.py``):

    python -m lipreading_tpu_torch.evaluate [workdir=runs/ft] [ckpt=path] \\
        [release=transformer_hybrid_universal4] [n_clips=6] [seed=9090] \\
        [beam=8] [decode=ctc|cascade] [lm_weight=0.0] [lexicon=0] \\
        [variation=0.0] [assets_variant=] [device=cuda] [key=value ...]
    python -m lipreading_tpu_torch.evaluate workdir=runs/ft \\
        dataview=<dir> [split=val] ...

The model: ``ckpt=``, else the latest checkpoint of ``workdir``, with the
config the trainer wrote there (``preset=`` where there is none); else the
release ``release=``, with any ``key=value`` overrides applied to it.
Fixture clips (``make_clip(seed + i)``) go through ``preprocess_padded`` on
the device; ``decode=cascade`` decodes them as the server does (CTC greedy,
the joint beam only for the clips its triggers flag), batched by 64-frame
bucket (one batch where the model's norms are framewise), else each clip
alone through ``transcribe`` at ``beam``. ``decode=ctc`` decodes a hybrid
model through its CTC head (greedy at ``beam=1``, the CTC prefix beam
above). ``dataview=`` evaluates a clip-level split of a cached dataview in
batches of 8. Any family loads: ``preset=bigru-ctc release=bigru_ctc`` are
the JAX script's defaults; this one keeps ``transformer-patchify`` and
``transformer_hybrid_universal4``. It runs on the GPU unless ``device=cpu``
is given.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

EVAL_BATCH = 8
BUCKET = 64


def load_model(cfg, workdir: str, ckpt: str | None, release: str,
               overrides: dict, device):
    """The model to evaluate, on ``device`` -> (model, cfg, where it came
    from)."""
    from lipreading_tpu_torch.io import from_jax_params, load_release
    from lipreading_tpu_torch.models.lipreader import LipReader
    from lipreading_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )

    path = ckpt or latest_checkpoint(os.path.join(workdir, "ckpt"))
    if path:
        _, tree, _, _, _ = load_checkpoint(path)
        source = path
    else:
        try:
            tree, cfg = load_release(release, overrides=overrides or None)
        except FileNotFoundError:
            raise SystemExit(f"no checkpoint in {workdir} and no release "
                             f"asset {release!r}")
        source = f"assets/{release}.msgpack"
    model = LipReader(cfg)
    model.load_state_dict(from_jax_params(tree, cfg))
    return model.to(device).eval(), cfg, source


def _cascade(model, cfg, roi_list, beam, lm_weight, use_lexicon):
    """The clips batched by 64-frame bucket (one bucket when the norms are
    framewise, whose features do not depend on the padding) through
    ``transcribe_cascade`` -> (transcripts, clips rescored)."""
    from lipreading_tpu_torch.infer import transcribe_cascade

    lens = [r.shape[0] for r in roi_list]
    buckets = {}
    if cfg.model.framewise_norm:
        buckets[-(-max(lens) // BUCKET) * BUCKET] = list(range(len(lens)))
    else:
        for i, n in enumerate(lens):
            buckets.setdefault(-(-n // BUCKET) * BUCKET, []).append(i)
    hyps = [None] * len(lens)
    n_rescored = 0
    for tb, idxs in sorted(buckets.items()):
        batch = np.zeros((len(idxs), tb) + roi_list[0].shape[1:],
                         roi_list[0].dtype)
        for k, i in enumerate(idxs):
            batch[k, :lens[i]] = roi_list[i]
        sub, n_r = transcribe_cascade(
            model, cfg, batch, np.asarray([lens[i] for i in idxs], np.int32),
            beam=beam, lm_weight=lm_weight, use_lexicon=use_lexicon)
        for k, i in enumerate(idxs):
            hyps[i] = sub[k]
        n_rescored += n_r
    return hyps, n_rescored


def evaluate_fixture(model, cfg, det, lmk, n_clips: int, seed: int,
                     beam: int, decode: str | None = None,
                     lm_weight: float = 0.0, use_lexicon: bool = False,
                     variation: float = 0.0) -> dict:
    """CER and WER on ``n_clips`` fixture clips, printed clip by clip and
    for the corpus -> {"hyps", "refs", "cer", "wer", "rescored"}."""
    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.infer import transcribe
    from lipreading_tpu_torch.metrics import cer, corpus_cer, corpus_wer
    from lipreading_tpu_torch.ops.preprocess import preprocess_padded

    roi_list, refs = [], []
    for i in range(n_clips):
        clip = make_clip(seed + i, cfg.data, variation=variation)
        roi_list.append(preprocess_padded(det, lmk, clip.frames,
                                          cfg.preprocess))
        refs.append(clip.text)
    n_rescored = None
    if decode == "cascade":
        hyps, n_rescored = _cascade(model, cfg, roi_list, beam, lm_weight,
                                    use_lexicon)
        print(f"  cascade: {n_rescored}/{n_clips} clips beam-rescored")
    else:
        hyps = []
        for rois in roi_list:
            T = rois.shape[0]
            padded = np.pad(rois, ((0, -T % BUCKET), (0, 0), (0, 0)))
            hyps.append(transcribe(model, cfg, padded[None],
                                   np.asarray([T], np.int32), beam=beam,
                                   lm_weight=lm_weight,
                                   use_lexicon=use_lexicon)[0])
    for i, (hyp, ref) in enumerate(zip(hyps, refs)):
        print(f"  clip {i}: cer={cer(hyp, ref):.3f} hyp={hyp!r} ref={ref!r}")
    out = {"hyps": hyps, "refs": refs, "cer": corpus_cer(hyps, refs),
           "wer": corpus_wer(hyps, refs), "rescored": n_rescored}
    print(f"corpus CER={out['cer']:.4f} WER={out['wer']:.4f}")
    return out


def evaluate_dataview(model, cfg, dataview_path: str, split: str, beam: int,
                      lm_weight: float = 0.0, use_lexicon: bool = False,
                      decode: str | None = None) -> dict:
    """CER and WER over a clip-level split of a cached dataview, decoded as
    the fixture path decodes, in batches of 8: the ragged tail is padded
    by repeating its last sample, and the repeats are neither scored nor
    counted as rescored -> {"hyps", "refs", "cer", "wer", "rescored"}."""
    from lipreading_tpu_torch.data.dataset import (
        BucketedDataset,
        batch_to_device,
    )
    from lipreading_tpu_torch.data.dataview import Dataview, split_by_clip
    from lipreading_tpu_torch.infer import transcribe, transcribe_cascade
    from lipreading_tpu_torch.metrics import corpus_cer, corpus_wer

    view = Dataview(dataview_path)
    splits = split_by_clip(view, {"train": 0.9, "val": 0.1}, seed=0)
    if not splits.get(split):
        raise SystemExit(f"split {split!r} missing or empty; have "
                         f"{ {k: len(v) for k, v in splits.items()} }")
    ds = BucketedDataset(view, cfg.data, indices=splits[split])
    device = next(model.parameters()).device
    pre = cfg.preprocess
    hyps, refs = [], []
    n_rescored = 0
    for lo in range(0, len(ds), EVAL_BATCH):
        take = list(range(lo, min(lo + EVAL_BATCH, len(ds))))
        n_real = len(take)
        take += [take[-1]] * (EVAL_BATCH - n_real)
        b = ds.make_batch(take)
        dev = batch_to_device(b, pre.normalize_mean, pre.normalize_std,
                              device)
        if decode == "cascade":
            sub, flags = transcribe_cascade(
                model, cfg, dev["rois"], dev["frame_lengths"], beam=beam,
                lm_weight=lm_weight, use_lexicon=use_lexicon,
                return_flags=True)
            n_rescored += int(np.asarray(flags)[:n_real].sum())
        else:
            sub = transcribe(model, cfg, dev["rois"], dev["frame_lengths"],
                             beam=beam, lm_weight=lm_weight,
                             use_lexicon=use_lexicon)
        hyps.extend(sub[:n_real])
        refs.extend(b.texts[:n_real])
    out = {"hyps": hyps, "refs": refs, "cer": corpus_cer(hyps, refs),
           "wer": corpus_wer(hyps, refs),
           "rescored": n_rescored if decode == "cascade" else None}
    extra = (f"  rescored={n_rescored}/{len(hyps)}"
             if decode == "cascade" else "")
    print(f"{split} split: {len(hyps)} samples  CER={out['cer']:.4f} "
          f"WER={out['wer']:.4f}{extra}")
    return out


def main(argv: list[str]) -> dict:
    from lipreading_tpu_torch.config import (
        load_workdir_config,
        parse_overrides,
        preset,
    )

    args = parse_overrides(argv)
    preset_name = args.pop("preset", "transformer-patchify")
    workdir = args.pop("workdir", f"runs/{preset_name}")
    cfg = load_workdir_config(workdir) or preset(preset_name)
    ckpt = args.pop("ckpt", None)
    n_clips = int(args.pop("n_clips", 6))
    seed = int(args.pop("seed", 9090))
    beam = int(args.pop("beam", cfg.train.beam_width))
    decode = args.pop("decode", None)
    if decode not in (None, "ctc", "cascade"):
        raise SystemExit(f"decode={decode}: need ctc or cascade")
    lm_weight = float(args.pop("lm_weight", 0.0))
    use_lexicon = args.pop("lexicon", "0") in ("1", "true")
    release = args.pop("release", "transformer_hybrid_universal4")
    variation = float(args.pop("variation", 0.0))
    assets_variant = args.pop("assets_variant",
                              "robust" if variation > 0 else "default")
    dataview_path = args.pop("dataview", None)
    split = args.pop("split", "val")
    device = args.pop("device", "cuda")
    overrides = dict(args)
    if overrides:
        cfg = cfg.override(**overrides)

    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to evaluate on the "
                         "CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg, source = load_model(cfg, workdir, ckpt, release, overrides,
                                    device)
    print(f"loaded {source}")
    if decode == "ctc" and cfg.decoder == "hybrid":
        # decode through the CTC head; the model keeps its attention decoder
        cfg = dataclasses.replace(cfg, decoder="ctc")
    if dataview_path:
        return evaluate_dataview(model, cfg, dataview_path, split, beam,
                                 lm_weight, use_lexicon, decode)

    from lipreading_tpu_torch.io import load_preprocessors

    det, lmk, _ = load_preprocessors(cfg.preprocess.landmarker,
                                     assets_variant, device=device)
    return evaluate_fixture(model, cfg, det, lmk, n_clips, seed, beam,
                            decode, lm_weight, use_lexicon, variation)


if __name__ == "__main__":
    main(sys.argv[1:])
