"""Train-step factory: loss -> gradients (microbatched) -> AdamW (port of
``repro/train/train_step.py``).

The gradients come from ``torch.autograd.grad`` of ``Model.loss`` with
respect to detached copies of the parameter leaves (views of the same
storage), so the caller's tree never carries ``requires_grad``. On the card
the model's forward runs the kernels, and their autograd Functions run the
backward kernels (``flash_attention``, ``bsr_spmm``, ``ssd_chunk``); a
kernel that has no backward refuses a call that needs one. A leaf the loss
never reads (an encoder's ``embed``) gets zeros, as ``jax.grad`` gives, so
AdamW still decays it.

``accum > 1`` splits axis 0 of every batch leaf into that many microbatches
and sums their gradients in float32, as the reference's scan does; the
loss is the microbatches' mean and each metric the mean of theirs.
``compressor`` (``dist.compression.int8_quantize``) maps the gradient tree
before the update, where the reference compresses before the cross-pod
reduction. The step reads nothing back to the host: ``metrics`` holds 0-d
tensors (``loss``, ``nll``, ``aux``, ``ntok``, ``grad_norm``, ``lr``).
"""
from __future__ import annotations

import torch

from .optimizer import AdamWConfig, adamw_update, tree_leaves, tree_unflatten


def value_and_grad(model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: ``grads`` in
    the parameters' tree, zeros for a leaf the loss never reads; the loss
    and metrics detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_unflatten(params, grads)


def make_train_step(model, opt_cfg: AdamWConfig, *, accum: int = 1,
                    compressor=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); the parameters and the state are updated in place."""

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = value_and_grad(model, params, batch)
        else:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in tree_leaves(params)]
            lsum, ms = 0.0, []
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss_i, m, g = value_and_grad(model, params, mb)
                for s, gi in zip(gsum, tree_leaves(g)):
                    s.add_(gi)
                lsum = lsum + loss_i
                ms.append(m)
                del g
            grads = tree_unflatten(params, [s.div_(accum) for s in gsum])
            loss = lsum / accum
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        if compressor is not None:
            grads = compressor(grads)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
        return params, opt_state, dict(loss=loss, **metrics, **opt_metrics)

    return train_step
