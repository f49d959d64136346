"""Synthetic batches (port of ``repro/train/data.py::synthetic_batch``).

The draws are the reference's: ``numpy.random.default_rng(seed)`` gives the
same numbers in both packages, and the float64 draws are rounded to
bfloat16 by torch's cast, which rounds as ``jnp.asarray(x, bfloat16)`` does.
``SyntheticLM``, ``Prefetcher`` and ``make_batch_specs`` wait for the
training slice (ROADMAP §1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.coo import resolve_device


def synthetic_batch(cfg, shape: dict, seed: int = 0, device=None) -> dict:
    """A random batch of ``shape`` (``batch``, ``seq``) for ``cfg``, on
    ``device`` (None: the GPU). An encoder's is ``features`` (B, S, D)
    bfloat16, ``mask`` (B, S) bool and ``targets`` (B, S) int32; a
    decoder's is ``tokens`` and ``labels`` (B, S) int32, and with the vision
    frontend also ``vision_embeds`` (B, T, D) bfloat16 with T = max(S // 4,
    1), ``vision_mask`` (B, S) bool, True at the first T positions, and
    ``pos3`` (3, B, S) int32, each axis 0 .. S - 1."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B, S = shape["batch"], shape["seq"]
    D = cfg.d_model

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    if cfg.kind == "encoder":
        return dict(
            features=t(rng.standard_normal((B, S, D)), torch.bfloat16),
            mask=t(rng.random((B, S)) < cfg.mask_prob, torch.bool),
            targets=t(rng.integers(0, cfg.vocab, (B, S)), torch.int32))
    batch = dict(
        tokens=t(rng.integers(0, cfg.vocab, (B, S)), torch.int32),
        labels=t(rng.integers(0, cfg.vocab, (B, S)), torch.int32))
    if cfg.frontend == "vision_patches":
        T = max(S // 4, 1)
        vmask = np.zeros((B, S), bool)
        vmask[:, :T] = True
        batch["vision_embeds"] = t(rng.standard_normal((B, T, D)),
                                   torch.bfloat16)
        batch["vision_mask"] = t(vmask, torch.bool)
        batch["pos3"] = t(np.broadcast_to(np.arange(S), (3, B, S)),
                          torch.int32)
    return batch
