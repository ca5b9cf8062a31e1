"""Plain reference of one fine-tuning step of the hybrid model: the loss
(ctc_weight times the mean over samples of the CTC negative
log-likelihood divided by the label count, plus att_weight times the
cross-entropy of the teacher-forced decoder over the real target tokens),
its gradients by autograd, clipping by the global norm and AdamW with
optax's semantics (learning rate read at the count before the update:
linear warmup from 0, then cosine to 5 % of the peak; bias corrections at
count + 1; eps outside the square root; weight decay added to the
direction of every parameter). The step's random draws (``StepDraws``)
are made as the configuration's training step makes them."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.frozen.rng import step_seed
from portbench.ref import model as M

B1, B2, EPS = 0.9, 0.999, 1e-8


class StepDraws:
    """The random draws of training step ``step`` over a batch of ``B``
    rows: a generator on ``device`` seeded from ``train.seed`` and the step
    (``frozen/rng.step_seed``) draws first the ROI jitter
    (``train.roi_augment`` a: a gain 1 + a u and a bias 2 a u a row, u
    uniform on [-1, 1), then pixel noise 0.5 a N(0, 1), in normalised
    units), then one dropout mask a residual branch (``model.dropout``:
    keep where a uniform draw is below 1 - rate, the kept values scaled by
    1 / (1 - rate)), in the order the forward reaches them. Every draw is
    made at all ``B`` rows; ``rows`` keeps those rows of each mask."""

    def __init__(self, cfg: dict, step: int, B: int, device, rows=None):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(step_seed(cfg["train"]["seed"], step))
        self.rate = cfg["model"]["dropout"]
        self.aug = cfg["train"].get("roi_augment", 0.0)
        self.B, self.rows = B, rows

    def jitter(self, rois: torch.Tensor) -> torch.Tensor:
        """All ``B`` rows' ROIs jittered."""
        a = self.aug
        if a <= 0.0:
            return rois
        shp = (rois.shape[0],) + (1,) * (rois.ndim - 1)

        def u(shape):
            return torch.rand(shape, generator=self.gen, device=rois.device,
                              dtype=rois.dtype) * 2 - 1

        gain = 1.0 + a * u(shp)
        bias = 2.0 * a * u(shp)
        noise = 0.5 * a * torch.randn(rois.shape, generator=self.gen,
                                      device=rois.device, dtype=rois.dtype)
        return rois * gain + bias + noise

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((self.B,) + tuple(x.shape[1:]), generator=self.gen,
                          device=x.device) < keep
        if self.rows is not None:
            mask = mask[self.rows]
        return torch.where(mask, x / keep, 0.0)


def losses(P, cfg, batch, prec, rows=None, draws=None):
    """-> (loss, ctc loss, attention loss) of ``batch`` (a dict of tensors:
    normalised ``rois``, ``frame_lengths``, ``targets``, ``target_lengths``,
    ``ctc_labels``, ``ctc_lengths``); ``rows`` limits it to those rows;
    ``draws`` (a ``StepDraws``) jitters the ROIs and drops out."""
    if draws is not None:
        batch = dict(batch, rois=draws.jitter(batch["rois"]))
    b = batch if rows is None else {k: v[rows] for k, v in batch.items()}
    drop = draws if draws is not None else (lambda x: x)
    t = cfg["train"]
    lens = b["frame_lengths"].long()
    enc = M.encode(P, cfg, b["rois"], lens, prec, drop)
    lp = M.ctc_log_probs(P, enc, prec)
    nll = F.ctc_loss(lp.transpose(0, 1), b["ctc_labels"].long(), lens,
                     b["ctc_lengths"].long(), blank=0, reduction="none")
    lc = (nll / b["ctc_lengths"].float().clamp(min=1.0)).mean()
    tg = b["targets"].long()
    alp = M.decoder_log_probs(P, cfg, tg[:, :-1], enc, lens, prec, drop)
    tok = -torch.gather(alp, 2, tg[:, 1:, None])[..., 0]
    L = tg.shape[1] - 1
    mask = (torch.arange(L, device=tok.device)[None, :]
            < (b["target_lengths"].long() - 1)[:, None]).float()
    la = (tok * mask).sum() / mask.sum().clamp(min=1.0)
    return t["ctc_weight"] * lc + t["att_weight"] * la, lc, la


def learning_rate(count: int, t: dict) -> float:
    peak, warm = t["learning_rate"], t["warmup_steps"]
    if count < warm:
        return peak * count / warm
    decay = max(t["total_steps"], warm + 1) - warm
    c = min(count - warm, decay)
    return peak * (0.95 * 0.5 * (1 + math.cos(math.pi * c / decay)) + 0.05)


class AdamW:
    def __init__(self, P: dict, t: dict):
        self.t, self.count = t, 0
        self.m = {k: torch.zeros_like(p) for k, p in P.items()}
        self.v = {k: torch.zeros_like(p) for k, p in P.items()}

    @torch.no_grad()
    def step(self, P: dict, grads: dict) -> dict:
        """Update ``P`` in place; returns the clipped gradients."""
        t = self.t
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values()))
        scale = 1.0 if norm < t["grad_clip"] else t["grad_clip"] / norm
        lr = learning_rate(self.count, t)
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        clipped = {}
        for k, p in P.items():
            g = grads[k] * scale
            clipped[k] = g
            self.m[k].mul_(B1).add_(g, alpha=1 - B1)
            self.v[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            u = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + EPS)
            p.sub_(lr * (u + t["weight_decay"] * p))
        return clipped


def run_steps(P0: dict, cfg: dict, batches: list, prec, rows=None):
    """The first len(batches) steps (0, 1, ...) from the parameters ``P0``
    (not changed), with each step's draws -> (per-step (ctc loss,
    attention loss), the first step's clipped gradients, the parameters'
    change)."""
    P = {k: v.clone().requires_grad_(True) for k, v in P0.items()}
    opt = AdamW(P, cfg["train"])
    out, g1 = [], None
    with prec.flags():
        for step, b in enumerate(batches):
            draws = StepDraws(cfg, step, b["rois"].shape[0],
                              b["rois"].device, rows)
            loss, lc, la = losses(P, cfg, b, prec, rows, draws)
            grads = torch.autograd.grad(loss, list(P.values()),
                                        allow_unused=True)
            grads = {k: (g if g is not None else torch.zeros_like(P[k]))
                     for k, g in zip(P, grads)}
            clipped = opt.step(P, grads)
            if g1 is None:
                g1 = clipped
            out.append((float(lc.detach()), float(la.detach())))
    return out, g1, {k: (P[k].detach() - P0[k]) for k in P}
