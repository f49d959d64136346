"""Maximal cardinality matching on bipartite graphs (paper §3.3, [22]).

Simplified Azad-Buluç iteration over CombBLAS primitives, as in
``repro.apps.matching``:
  repeat until no augmenting edges:
    1. every unmatched row proposes to one adjacent unmatched column
       (SpMV with (max, select-col-id): h[c] = max row id proposing to c)
    2. each column accepts one proposer; accepted pairs update mateRow/
       mateCol (piece-aligned vector updates + one distributed assign)

Each iteration reads one grid-wide count back to the host (the accepted
proposals, the loop test), besides the router's grid-wide overflow flags.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.assign import assign, extract
from ..core.coo import SENTINEL
from ..core.dist import DistSpMat, DistVec, Grid, grid_all, grid_sum
from ..core.matops import mat_transpose
from ..core.plan import spmv_variant
from ..core.semiring import MAX_INT, Semiring
from ..core.spmv import spmv_iter

_NONE = -1
MAXSEL = Semiring(MAX_INT, lambda a, b: b, "max_select2nd_i32")


def maximal_matching(a: DistSpMat, *, mesh: Grid, max_iters: int = 64):
    """Greedy maximal matching. a: (nr × nc) bipartite adjacency.

    Returns (mate_row[nr], mate_col[nc]) int64 with -1 = unmatched. The
    matching is maximal on the support of a (no edge joins two unmatched
    vertices) once the loop stops before ``max_iters``.
    """
    nr, nc = a.shape
    grid = a.grid
    pr, pc = grid
    npad_r = a.mb * pr
    npad_c = a.nb * pc

    def vec(x):
        return DistVec.from_global(x, grid, layout="col", mesh=mesh)

    mate_row = vec(np.full(npad_r, _NONE, np.int32))
    mate_col = vec(np.full(npad_c, _NONE, np.int32))
    # global row id of each vector slot (for proposals)
    ids_r = vec(np.arange(npad_r, dtype=np.int32))
    rcap = max(npad_r, npad_c, 64)
    at = mat_transpose(a, mesh=mesh)
    variant = spmv_variant(at)   # planner: match the transposed tile order
    ids_c = vec(np.arange(npad_c, dtype=np.int32))
    none = torch.tensor(_NONE, dtype=torch.int32, device=ids_c.device)
    for _ in range(max_iters):
        # 1. unmatched rows broadcast their id; matched rows send -1
        prop = DistVec(torch.where(mate_row.data == _NONE, ids_r.data, none),
                       nr, grid, "col")
        # h[c] = max proposing row over N(c):  y = A^T prop via (max, 2nd)
        h = spmv_iter(at, prop, MAXSEL, mesh=mesh,       # layout 'col', len nc
                      variant=variant)
        # 2. columns accept: unmatched columns with a valid proposer
        accept = (mate_col.data == _NONE) & (h.data > _NONE) & \
            (h.data < 2**31 - 1)
        if int(grid_sum(accept.to(torch.int32), grid)) == 0:
            break
        # 3. accepted rows pick ONE column (max col id wins the assign merge)
        upd_idx = torch.where(accept, h.data,
                              torch.full_like(h.data, SENTINEL))
        upd_val = torch.where(accept, ids_c.data, none)
        mate_row, ok = assign(mate_row, upd_idx, upd_val, mesh=mesh,
                              add=MAX_INT, route_cap=rcap)
        # 4. verification: column c keeps row r only if mate_row[r] == c
        #    (two columns may have accepted the same proposer)
        got, ok2 = extract(mate_row, upd_idx, mesh=mesh, route_cap=rcap)
        if not grid_all(ok & ok2, grid):
            raise RuntimeError(f"maximal_matching: the router overflowed "
                               f"(route_cap {rcap})")
        confirmed = accept & (got == ids_c.data)
        mate_col = DistVec(torch.where(confirmed, h.data, mate_col.data),
                           nc, grid, "col")
    return (mate_row.to_global()[:nr].astype(np.int64),
            mate_col.to_global()[:nc].astype(np.int64))
