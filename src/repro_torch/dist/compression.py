"""Wire compression: gradient reduction AND sparse exchange payloads.

Dense side (bandwidth-bound data parallelism, DESIGN.md §5) — two standard
schemes over a tensor, or a list, tuple or dict of tensors (the JAX
package's pytrees):

- ``int8_quantize``: per-tensor symmetric int8 quantize-dequantize. The
  returned tensors are float again (ready for the optimizer); the int8
  payload is what would cross the wire, so round-trip error ≤ max|g|/254.
- ``make_topk_error_feedback``: magnitude top-k sparsification with error
  feedback [Stich et al.]: the residual (what was NOT sent) is carried in
  state and added back next step, so mass is preserved exactly:
  ``kept + residual == grad + old_residual``.

Sparse side (distributed SpGEMM value payloads, DESIGN.md §4.8):

- ``quantize_payload``/``dequantize_payload``: per-tile symmetric int8 for
  COO value buffers with nnz-aware scale (padding slots never inflate the
  scale and quantize to exact 0) plus the same error-feedback contract as
  the dense path: ``dequantize(q8, scale) + new_resid == val + resid``
  exactly, and ``|new_resid| ≤ scale/2`` per live entry (one rounding
  step). The int8 buffer is the wire payload; the scale travels with it.

``torch.round`` rounds half to even, as ``jnp.round`` does, so q8, the
scale and the residual are the JAX package's bit for bit.
"""
from __future__ import annotations

import torch


def quantize_payload(val: torch.Tensor, nnz: torch.Tensor | None = None,
                     resid: torch.Tensor | None = None):
    """Per-tile symmetric int8 quantization of a COO value buffer.

    ``val`` is (..., cap) with live entries in the first ``nnz[...]`` slots
    of the last axis (all slots live when nnz is None). ``resid`` is a
    prior error-feedback residual shaped like ``val`` (added before
    quantizing). Returns ``(q8, scale, new_resid)`` where q8 is int8
    shaped like val (0 on padding), scale is val.dtype shaped val.shape
    [:-1] (the per-tile dequantization factor, max live |e|/127), and
    new_resid = (val + resid) − q8·scale, zeroed on padding.
    """
    e = val if resid is None else val + resid
    zero = torch.zeros((), dtype=val.dtype, device=val.device)
    if nnz is not None:
        live = torch.arange(val.shape[-1], dtype=torch.int32,
                            device=val.device) < nnz[..., None]
        mag = torch.where(live, e, zero).abs().amax(dim=-1)
    else:
        live = None
        mag = e.abs().amax(dim=-1)
    # the scale keeps the ORIGINAL value dtype — downstream dequantization
    # restores it even though the wire carries int8
    scale = torch.clamp(mag / 127.0, min=1e-30).to(val.dtype)
    q8 = torch.clamp(torch.round(e / scale[..., None]), -127, 127) \
        .to(torch.int8)
    if live is not None:
        q8 = torch.where(live, q8, torch.zeros((), dtype=torch.int8,
                                               device=val.device))
    new_resid = (e - q8.to(val.dtype) * scale[..., None]).to(val.dtype)
    if live is not None:
        new_resid = torch.where(live, new_resid, zero)
    return q8, scale, new_resid


def dequantize_payload(q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_payload` (scale broadcast over cap)."""
    return q8.to(scale.dtype) * scale[..., None]


def _flatten(tree) -> list:
    """The tensors of ``tree`` (nested lists, tuples and dicts of tensors,
    the JAX package's pytrees) in ``jax.tree`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with its tensors replaced by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def _tree_map(fn, tree):
    return _unflatten(tree, [fn(x) for x in _flatten(tree)])


def _int8_round_trip(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return (q.to(x.dtype) * scale).to(x.dtype)


def int8_quantize(tree):
    """Symmetric per-tensor int8 round trip: dequantized float tensors, in
    the structure of ``tree``."""
    return _tree_map(_int8_round_trip, tree)


def make_topk_error_feedback(frac: float = 0.01):
    """Returns (init, compress) for top-``frac`` sparsification w/ feedback.

    init(grads)            -> zero residual state (same structure)
    compress(grads, state) -> (kept, new_state); kept has ~frac·size
                              nonzeros per tensor, kept + new_state ==
                              grads + state exactly.
    """

    def init(tree):
        return _tree_map(torch.zeros_like, tree)

    def one(x, r):
        e = x + r
        k = max(1, int(round(frac * e.numel())))
        mag = e.abs().reshape(-1)
        # threshold = k-th largest magnitude; ties beyond k are kept
        # (slightly more sent, never silently dropped)
        thresh = torch.topk(mag, k).values[-1]
        keep = e.abs() >= thresh
        kept = torch.where(keep, e, torch.zeros((), dtype=e.dtype,
                                                device=e.device))
        return kept, e - kept

    def compress(tree, state):
        kept, res = [], []
        for x, r in zip(_flatten(tree), _flatten(state)):
            k, e = one(x, r)
            kept.append(k)
            res.append(e)
        return _unflatten(tree, kept), _unflatten(tree, res)

    return init, compress
