"""Distributed matrix helper operations used by the graph apps.

Tile-local operations on a ``DistSpMat``: elementwise tile ops need no
communication — the payoff of CombBLAS's superimposed distributions.
"""
from __future__ import annotations

import torch

from .coo import COO, SENTINEL, _vmask, sentinel_like
from .dist import DistSpMat, Grid


def mat_apply_local(a: DistSpMat, fn, *, mesh: Grid) -> DistSpMat:
    """Apply ``fn: COO -> COO`` (same capacity) tile-wise; the result
    carries the order tag ``fn`` reports."""
    del mesh                          # the 1x1 grid's one tile is local
    return DistSpMat.from_tile(fn(a.tile()), a.shape, a.grid)


def mat_select_lower(a: DistSpMat, *, mesh: Grid, strict=True) -> DistSpMat:
    """Keep entries with global row > col (strict lower triangle)."""
    del mesh
    t = a.tile()
    # tile (0, 0): tile-local indices are the global ones
    grow, gcol = t.row.long(), t.col.long()
    keep = (grow > gcol) if strict else (grow >= gcol)
    return DistSpMat.from_tile(_prune_mask(t, keep), a.shape, a.grid)


def _prune_mask(t: COO, keep: torch.Tensor) -> COO:
    keep = keep & t.mask()
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    k = keep[order]
    s = sentinel_like(t.row)
    val = torch.where(_vmask(k, t.vdims), t.val[order],
                      torch.zeros((), dtype=t.dtype, device=t.device))
    # stable compaction: surviving entries keep their relative order
    return COO(torch.where(k, t.row[order], s), torch.where(k, t.col[order], s),
               val, keep.sum(dtype=torch.int32), t.shape, t.order)


def mat_sum(a: DistSpMat) -> torch.Tensor:
    """Σ stored values (arithmetic)."""
    return torch.where(a.row != SENTINEL, a.val, 0).sum()


def mat_nnz(a: DistSpMat) -> torch.Tensor:
    return a.nnz.sum()
