"""Serving: prefill and single-token decode with KV and SSM-state caches
(port of ``repro/serve/decode.py``).

No ``jit``: the loop is eager, and the caches are updated in place. The
same loop serves every ported family: attention layers keep k/v caches,
mamba layers their conv history and state (``Model.init_cache``).
"""
from __future__ import annotations

import torch

from ..core.coo import resolve_device
from ..dist.shardings import gather


def _last(logits):
    """The last position's logits, whole: under a ``ShardingPlan`` the
    forward returns a DTensor (rows over the data axes, the vocabulary over
    the model axis), gathered here on every rank."""
    return gather(logits[:, -1, :])


def make_serve_step(model):
    """serve_step(params, caches, tokens (B, 1), offset (B,)) ->
    (next_logits (B, vocab_padded), caches)"""

    def serve_step(params, caches, tokens, offset):
        batch = dict(tokens=tokens, offset=offset)
        logits, _, new_caches = model(params, batch, caches=caches)
        return _last(logits), new_caches

    return serve_step


def make_prefill(model):
    """prefill(params, caches, tokens (B, S)) -> (last_logits, caches)."""

    def prefill(params, caches, tokens):
        offset = torch.zeros(tokens.shape[0], dtype=torch.int32,
                             device=tokens.device)
        batch = dict(tokens=tokens, offset=offset)
        logits, _, new_caches = model(params, batch, caches=caches)
        return _last(logits), new_caches

    return prefill


def greedy_generate(model, params, prompt, max_len: int, gen_tokens: int, *,
                    device=None, on_logits=None):
    """Prefill ``prompt`` (B, S) and greedily decode ``gen_tokens`` tokens.

    ``device`` None means the GPU (raising when there is none); ``params``
    must lie on the same device. ``on_logits(logits)``, when given, is
    called with the (B, vocab_padded) logits of every forward (the prefill,
    then each decode step) before their argmax. Returns (B, gen_tokens)
    int32 tokens.
    """
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    B, S = prompt.shape
    prefill = make_prefill(model)
    step = make_serve_step(model)
    with torch.inference_mode():
        caches = model.init_cache(B, max_len, device=dev)
        logits, caches = prefill(params, caches, prompt)
        if on_logits is not None:
            on_logits(logits)
        out = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        for t in range(gen_tokens - 1):
            offset = torch.full((B,), S + t, dtype=torch.int32, device=dev)
            logits, caches = step(params, caches, out[-1], offset)
            if on_logits is not None:
                on_logits(logits)
            out.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    return torch.cat(out, dim=1)
