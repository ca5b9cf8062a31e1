"""Where a bf16 training step on the GPU parts from the same step on the CPU.

    python -m lipreading_tpu_torch.parity_probe [out.txt]   # on the GPU

One step of universal4's hybrid loss at full width, without dropout or ROI
jitter, from the seeded initialisation, on two fixture clips (the batch of
``chip_smoke.py``'s ``[parity]`` phase), run on the card and on the CPU from
the same ROIs (the card's, copied to the host, so preprocessing is out of
the comparison). Every module's output is recorded on both sides, in the
order the modules finish, with two readings each:

* drift: the card's output against the CPU's (the module's own error plus
  what its inputs already carried);
* local: the CPU module run on the card's inputs against the card's output,
  the module's own error alone; ``frac`` is the share of elements that are
  not bit-equal.

A relative difference is ``max|a - b| / max|b|``. Then the step's loss and
gradients on the card against the CPU, with cuBLAS's reduced-precision bf16
reductions (``allow_bf16_reduced_precision_reduction``) on, as PyTorch
defaults, and off. The full table goes to ``out.txt`` (default
``runs/parity_probe.txt``); the standard output gets the summary.
"""

from __future__ import annotations

import copy
import os
import sys

import torch

RELEASE = "transformer_hybrid_universal4"
OVERRIDES = {"model.dropout": 0.0, "train.roi_augment": 0.0,
             "train.warmup_steps": 0}


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _record(model, keep_inputs: bool):
    """Forward hooks on every module -> (list of (name, args, kwargs, out)
    in completion order, the hook handles)."""
    calls, handles = [], []
    for name, mod in model.named_modules():
        if not name or isinstance(mod, torch.nn.ModuleList):
            continue

        def hook(m, args, kwargs, out, name=name):
            if not isinstance(out, torch.Tensor):
                return
            calls.append((name, _to(args, "cpu") if keep_inputs else None,
                          _to(kwargs, "cpu") if keep_inputs else None,
                          out.detach().cpu()))

        handles.append(mod.register_forward_hook(hook, with_kwargs=True))
    return calls, handles


def _step(model, cfg, batch):
    """The loss and the flat gradient (float64, on the host)."""
    from lipreading_tpu_torch.models.lipreader import compute_loss

    model.zero_grad(set_to_none=True)
    loss, _ = compute_loss(model, cfg, batch, train=True, gen=None)
    loss.backward()
    return loss.item(), torch.cat([p.grad.detach().double().cpu().reshape(-1)
                                   for p in model.parameters()])


def main(argv: list[str]) -> int:
    from lipreading_tpu_torch.data.pipeline import (
        FixtureVideoDataset,
        video_batch_to_device,
    )
    from lipreading_tpu_torch.io import load_assets, load_release
    from lipreading_tpu_torch.models.lipreader import init_model
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch
    from lipreading_tpu_torch.ops.preprocess import preprocess_clips

    if not torch.cuda.is_available():
        print("parity_probe: no CUDA device")
        return 1
    out_path = argv[0] if argv else os.path.join("runs", "parity_probe.txt")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, cfg = load_release(RELEASE, overrides=OVERRIDES)
    det_np, ert_np = load_assets()
    batch = FixtureVideoDataset(1, seed=2, cfg=cfg.data).batch([0, 1], 32)
    dev = video_batch_to_device(batch, "cuda")
    with torch.no_grad():
        rois = preprocess_clips(params_to_torch(det_np, "cuda"),
                                model_to_torch(ert_np, "cuda"),
                                dev.pop("frames"), cfg.preprocess)
    card_batch = dict(dev, rois=rois)
    cpu_batch = _to(card_batch, "cpu")

    cpu_model = init_model(cfg, torch.Generator().manual_seed(cfg.train.seed),
                           "cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")

    card_calls, h1 = _record(card_model, keep_inputs=True)
    card_loss, card_g = _step(card_model, cfg, card_batch)
    cpu_calls, h2 = _record(cpu_model, keep_inputs=False)
    cpu_loss, cpu_g = _step(cpu_model, cfg, cpu_batch)
    for h in h1 + h2:
        h.remove()

    mods = dict(cpu_model.named_modules())
    lines = [f"{'module':44} {'shape':>18} {'dtype':>9} {'drift':>10} "
             f"{'local':>10} {'frac':>8}"]
    first = None
    with torch.no_grad():
        for (name, args, kwargs, out), (cname, _, _, cout) in zip(card_calls,
                                                                  cpu_calls):
            assert name == cname, (name, cname)
            local_out = mods[name](*args, **kwargs)
            local = _rel(out, local_out)
            frac = float((out != local_out).float().mean())
            drift = _rel(out, cout)
            lines.append(f"{name:44} {str(tuple(out.shape)):>18} "
                         f"{str(out.dtype)[6:]:>9} {drift:10.3e} "
                         f"{local:10.3e} {frac:8.4f}")
            if first is None and frac > 0:
                first = (name, local, frac)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")

    def readings(loss, g):
        cos = torch.nn.functional.cosine_similarity(g, cpu_g, dim=0)
        return (f"loss_rel {abs(loss - cpu_loss) / abs(cpu_loss):.3e}, "
                f"1 - grad cosine {1.0 - float(cos):.3e}")

    print(f"[probe] {len(card_calls)} module outputs compared "
          f"({out_path}); loss card {card_loss:.6f} cpu {cpu_loss:.6f}")
    if first:
        print(f"[probe] first module whose own output differs on the card: "
              f"{first[0]} (local relative {first[1]:.3e}, "
              f"{first[2]:.2%} of elements)")
    worst = sorted(lines[1:], key=lambda s: -float(s.split()[-2]))[:12]
    print("[probe] largest local differences:\n  " + "\n  ".join(
        [lines[0]] + worst))
    print(f"[probe] default settings (bf16 reduced-precision reductions "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
          f"): {readings(card_loss, card_g)}")
    for reduced in (False, True):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
        loss, g = _step(card_model, cfg, card_batch)
        print(f"[probe] bf16 reduced-precision reductions {reduced}: "
              f"{readings(loss, g)}")
    cfg32 = cfg.override(**{"model.dtype": "float32"})
    loss32, g32 = _step(cpu_model, cfg32, cpu_batch)
    print(f"[probe] control, the CPU in float32 against the CPU in bf16: "
          f"{readings(loss32, g32)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
