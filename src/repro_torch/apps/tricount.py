"""Triangle counting via masked SpGEMM: tri = Σ (L·L)⟨L⟩.

L is the strict lower triangle; (L·L)[i,j] counts k with j<k<i adjacent to
both, and the structural mask L keeps (i,j) edges — each triangle counted
exactly once. L is passed as the output mask of the SpGEMM itself, so
non-edge products are discarded before any merge stage and the planner
sizes out/stage capacities from nnz(L) instead of nnz(L·L).
"""
from __future__ import annotations

import torch

from ..core.dist import DistSpMat, Grid
from ..core.mask import structural
from ..core.matops import mat_apply_local, mat_select_lower, mat_sum
from ..core.plan import spgemm as spgemm_planned
from ..core.semiring import ARITHMETIC
from ..obs import recorder as _obs


def triangle_count(a: DistSpMat, *, mesh: Grid, prod_cap: int | None = None,
                   out_cap: int | None = None) -> int:
    """Count triangles of the symmetric graph ``a`` (values ignored)."""
    with _obs.span("tricount"):
        ones = lambda t: t.apply(torch.ones_like)
        l = mat_select_lower(mat_apply_local(a, ones, mesh=mesh), mesh=mesh)
        b, _plan = spgemm_planned(l, l, ARITHMETIC, mesh=mesh,
                                  mask=structural(l),
                                  prod_cap=prod_cap, out_cap=out_cap)
        return int(mat_sum(b))
