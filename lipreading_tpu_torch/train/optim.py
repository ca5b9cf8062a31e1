"""The training optimizer with optax's semantics (counterpart of
``make_optimizer`` in ``lipreading_tpu/train/loop.py``):

    optax.chain(optax.clip_by_global_norm(grad_clip),
                optax.adamw(warmup_cosine_decay_schedule(...),
                            weight_decay=weight_decay))

written out by hand, since the GPU machine has no optax. Where it differs
from ``torch.optim.AdamW`` and ``clip_grad_norm_``, optax is followed:

* the schedule is read at the count *before* the update, so the first
  update has learning rate ``warmup_cosine_lr(0) == 0``;
* clipping is ``g if norm < max else g / norm * max`` (no 1e-6 in the
  denominator);
* Adam's bias correction uses count + 1, ``eps`` is added outside the square
  root (``eps_root`` 0), then ``weight_decay * p`` is added to the update of
  every parameter (no mask: norms, biases and ``pos`` decay too), and the
  sum is scaled by ``-lr``.

The state is the optax state: one count and the two moment trees; it
converts to and from the tree ``flax.serialization.to_state_dict`` gives
for that chain (``state_tree`` / ``load_state_tree``).

Under tensor parallelism (``tp``, a ``parallel.mesh.TensorParallel``) a
rank holds its part of the sharded parameters and of their moments. The
clipping norm is optax's over the whole tree: the squares of the sharded
parts summed over the model axis, the replicated parameters counted once,
so every rank reads the same norm. The state tree holds the whole moments.

``Adam`` is the plain ``optax.adam(learning_rate)`` of the preprocessor
trainers: the same Adam update without the clip and the weight decay, over
a flat dict of tensors, at a constant learning rate or on
``warmup_cosine_lr``'s schedule.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lipreading_tpu_torch import profiling
from lipreading_tpu_torch.config import TrainConfig

B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


def warmup_cosine_lr(count: int, t: TrainConfig) -> float:
    """optax.warmup_cosine_decay_schedule(0 -> learning_rate over
    warmup_steps, cosine to 0.05 * learning_rate at
    max(total_steps, warmup_steps + 1)) at ``count``, in float32 in optax's
    order of operations."""
    f32 = np.float32
    peak, warm = t.learning_rate, t.warmup_steps
    decay = max(t.total_steps, warm + 1) - warm
    if count < warm:                     # linear_schedule(0, peak, warm)
        frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
        return float(f32(0.0 - peak) * frac + f32(peak))
    alpha = 0.0 if peak == 0.0 else (peak * 0.05) / peak
    c = f32(min(count - warm, decay))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
    return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))


def _bias_corrections(inc: int) -> tuple[float, float]:
    """Adam's bias corrections at count ``inc``, rounded in float32 as optax
    rounds them."""
    f32 = np.float32
    return (float(f32(1) - np.power(f32(B1), f32(inc), dtype=f32)),
            float(f32(1) - np.power(f32(B2), f32(inc), dtype=f32)))


def _adam_direction(g, m, v, bc1: float, bc2: float) -> torch.Tensor:
    """Update the moments ``m`` and ``v`` in place with the gradient ``g``
    -> Adam's direction m_hat / (sqrt(v_hat + eps_root) + eps)."""
    m.mul_(B1).add_(g, alpha=1 - B1)
    v.mul_(B2).addcmul_(g, g, value=1 - B2)
    return (m / bc1) / (torch.sqrt(v / bc2 + EPS_ROOT) + EPS)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element of every tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


class AdamW:
    """Clip-by-global-norm + AdamW over the named parameters of a module
    (``tp``: its tensor-parallel layout, the module doc)."""

    def __init__(self, module: torch.nn.Module, t: TrainConfig, tp=None):
        self.t = t
        self.tp = tp
        self.params = dict(module.named_parameters())
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad`` (None counts as
        zero); returns the global norm of the unclipped gradients."""
        names = list(self.params)
        grads = [self.params[k].grad if self.params[k].grad is not None
                 else torch.zeros_like(self.params[k]) for k in names]
        if self.tp is None:
            norm = global_norm(grads)
        else:
            norm = self._tp_norm(names, grads)
        with profiling.span("wait.h2d"):   # a copy from host memory
            clip = torch.as_tensor(self.t.grad_clip, dtype=norm.dtype,
                                   device=norm.device)
        trigger = norm < clip
        # optax: select(norm < max, g, (g / norm) * max)
        div = torch.where(trigger, torch.ones_like(norm), norm)
        mul = torch.where(trigger, torch.ones_like(norm), clip)
        lr = warmup_cosine_lr(self.count, self.t)
        inc = self.count + 1
        bc1, bc2 = _bias_corrections(inc)
        wd = self.t.weight_decay
        for k, g in zip(names, grads):
            p = self.params[k]
            u = _adam_direction(g / div * mul, self.mu[k], self.nu[k], bc1, bc2)
            u = u + wd * p
            p.add_(u, alpha=-lr)
        self.count = inc
        return norm

    def _tp_norm(self, names, grads) -> torch.Tensor:
        """The whole tree's norm: the sharded parts' squares summed over the
        model axis, the replicated ones counted once."""
        from lipreading_tpu_torch.parallel.comm import all_reduce_

        zero = grads[0].new_zeros((), dtype=torch.float32)
        sq = {True: zero, False: zero}
        for k, g in zip(names, grads):
            part = k in self.tp.plan
            sq[part] = sq[part] + torch.sum(torch.square(g.float()))
        shard = all_reduce_(sq[True].reshape(1).clone(), self.tp.axis)[0]
        return torch.sqrt(shard + sq[False])

    # --- the optax state as flax stores it --------------------------------

    def state_tree(self) -> dict:
        """``to_state_dict(tx.init(params))`` layout of the chain: clip's
        empty state, then adamw's (scale_by_adam, add_decayed_weights,
        scale_by_schedule)."""
        from lipreading_tpu_torch.io import to_jax_params

        count = np.asarray(self.count, np.int32)
        mu, nu = self.mu, self.nu
        if self.tp is not None:
            mu, nu = self.tp.full_state(mu), self.tp.full_state(nu)
        return {"0": {}, "1": {
            "0": {"count": count, "mu": to_jax_params(mu),
                  "nu": to_jax_params(nu)},
            "1": {},
            "2": {"count": count.copy()},
        }}

    @torch.no_grad()
    def load_state_tree(self, tree: dict) -> None:
        """Inverse of ``state_tree`` (from a port or a JAX checkpoint)."""
        adam = tree["1"]["0"]
        counts = {int(np.asarray(adam["count"])),
                  int(np.asarray(tree["1"]["2"]["count"]))}
        if len(counts) != 1:
            raise ValueError(f"optimizer state: Adam and schedule counts "
                             f"differ: {sorted(counts)}")
        for name, moments in (("mu", self.mu), ("nu", self.nu)):
            for k, t in moments.items():
                node = adam[name]
                for part in k.split("."):
                    node = node[part]
                src = torch.from_numpy(np.array(node, np.float32))
                if self.tp is not None:
                    src = self.tp.local(k, src)
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"optimizer state {name}/{k}: shape "
                                     f"{tuple(src.shape)}, want "
                                     f"{tuple(t.shape)}")
                t.copy_(src)
        self.count = counts.pop()


class Adam:
    """``optax.adam(learning_rate)`` over a flat dict of leaf tensors (the
    preprocessor trainers' weights): no clip, no weight decay. ``lr`` is a
    constant, or a ``TrainConfig`` whose ``warmup_cosine_lr`` schedule is
    read at the count before each update (as optax reads it)."""

    def __init__(self, params: dict[str, torch.Tensor],
                 lr: float | TrainConfig):
        self.params = params
        self.lr = lr
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self) -> None:
        """Apply one update from the parameters' ``.grad`` (None counts as
        zero), then clear the gradients."""
        lr = (warmup_cosine_lr(self.count, self.lr)
              if isinstance(self.lr, TrainConfig) else self.lr)
        self.count += 1
        bc1, bc2 = _bias_corrections(self.count)
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.add_(_adam_direction(g, self.mu[k], self.nu[k], bc1, bc2),
                   alpha=-lr)
            p.grad = None
