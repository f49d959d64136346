"""AdamW with global-norm clipping (port of ``repro/train/optimizer.py``).

The reference's arithmetic, leaf by leaf: gradients scaled by
``min(1, clip_norm / max(gnorm, 1e-9))``, bias corrections from a float32
step, weight decay on leaves of two or more dimensions only (a stacked
norm of shape (reps, D) counts, as in the reference), ``m``, ``v`` and the
update in float32, the parameter cast back to its type. The state is the
reference's tree (``m``, ``v`` float32 like the parameters, ``step`` a 0-d
int32 tensor), so ``train/checkpoint.py`` writes it in the JAX format.

``adamw_update`` works in place: it overwrites the parameters, ``m`` and
``v`` it is given and returns them, as ``jax.jit(..., donate_argnums=(0,
1))`` lets XLA reuse their buffers. Each leaf is updated in slices of at
most ``SLICE`` elements, so the update's float32 temporaries stay a few
slices in size (the largest leaf of a 4-layer qwen2-moe-a2.7b, ``we_g``, is
2.95 GB). Every scalar (the norm, the scale, the learning rate, the bias
corrections) stays a tensor on the parameters' device: nothing is read back
to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..dist.compression import _flatten as tree_leaves
from ..dist.compression import _unflatten as tree_unflatten

SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def init_opt_state(params) -> dict:
    """``m`` and ``v`` zeros in float32 shaped like the parameters, ``step``
    a 0-d int32 zero, on the parameters' device."""
    leaves = tree_leaves(params)
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    dev = leaves[0].device if leaves else None
    return dict(m=tree_unflatten(params, zeros),
                v=tree_unflatten(params, [torch.zeros_like(z)
                                          for z in zeros]),
                step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``; ``step`` an
    integer or an integer tensor. A float32 tensor on ``step``'s device."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * \
        0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm of every leaf together (each leaf's sum of
    squares in float32, without a squared copy of the leaf)."""
    return torch.sqrt(sum(
        torch.linalg.vector_norm(x, dtype=torch.float32).square()
        for x in tree_leaves(tree)))


def _update_slice(p, g, m, v, scale, lr, b1c, b2c, cfg, decay: bool):
    g = g.float() * scale
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
    delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
    if decay:
        delta = delta + cfg.weight_decay * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))
    m.copy_(m2)
    v.copy_(v2)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """Returns (params, state, metrics), the first two updated in place;
    metrics holds ``grad_norm`` and ``lr`` (0-d float32 tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        flat = [t.view(-1) for t in (p, m, v)] + [g.reshape(-1)]
        for i in range(0, p.numel(), SLICE):
            ps, ms, vs, gs = (t[i:i + SLICE] for t in flat)
            _update_slice(ps, gs, ms, vs, scale, lr, b1c, b2c, cfg,
                          p.dim() >= 2)
    state["step"] = step
    return params, state, dict(grad_norm=gnorm, lr=lr)
