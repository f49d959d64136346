"""Breadth-first search via masked SpMSpV (the original CombBLAS demo app).

Level-synchronous BFS: the frontier is a DistSpVec, each step one SpMSpV
over the boolean semiring with the visited (levels) vector pushed in as a
COMPLEMENT mask (§4.7): already-visited vertices are discarded inside the
local expansion, before the variant merges, instead of being generated and
filtered afterwards. The planner also caps the output at the unvisited
count, so sort/merge volumes shrink as the search saturates.

Capacities come from the planner (core/plan.py) from the *current* frontier
size each level: the local SpMSpV data structure follows the Fig-3 density
rule, and an overflowing level retries with grown caps. Each level reads
three scalars back to the host: the frontier's size (the loop test), and
the planner's frontier size and admissible-row count.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dist import DistSpMat, DistSpVec, DistVec, Grid
from ..core.mask import vector_mask
from ..core.matops import spvec_nnz, vec_scatter_spvec
from ..core.plan import plan_spmspv, spmspv as spmspv_planned
from ..core.semiring import BOOLEAN
from ..core.spmv import transpose_spvec_layout
from ..obs import recorder as _obs


def bfs_levels(a: DistSpMat, source: int, *, mesh: Grid,
               prod_cap: int | None = None, out_cap: int | None = None,
               max_iters: int | None = None) -> np.ndarray:
    """Per-vertex BFS levels (-1 = unreachable) from ``source``.

    ``a`` is directed adjacency with edges u→v for entry (v, u): y = A x
    puts the frontier x's neighbours in y (CombBLAS convention: use A^T for
    the usual orientation).
    """
    n = a.shape[0]
    grid = a.grid
    levels = DistVec.from_global(np.full(n, -1, np.int32), grid,
                                 layout="row", mesh=mesh)
    # frontier capacity: the planner's output cap for a worst-case frontier
    # (so pieces never truncate); an explicit out_cap wins
    fcap = out_cap or plan_spmspv(a, n, out_cap=out_cap).out_cap
    frontier = DistSpVec.from_global(np.array([source], np.int64),
                                     np.ones(1, np.bool_), n, grid,
                                     cap=fcap, layout="row", mesh=mesh)
    levels = vec_scatter_spvec(levels, frontier,
                               lambda cur, xv: torch.zeros_like(cur))
    level = 0
    max_iters = max_iters or n
    while level < max_iters:
        nf = int(spvec_nnz(frontier))
        if nf == 0:
            break
        level += 1
        with _obs.span("bfs.level", level=level, frontier_nnz=nf):
            fcol = transpose_spvec_layout(frontier, mesh=mesh)
            # visited vertices (level >= 0) as a complement mask: the
            # expansion emits only unvisited neighbours
            visited = vector_mask(levels, pred=lambda lv: lv >= 0,
                                  complement=True)
            nxt, _plan = spmspv_planned(a, fcol, BOOLEAN, mesh=mesh,
                                        mask=visited, prod_cap=prod_cap,
                                        out_cap=out_cap)
            levels = vec_scatter_spvec(
                levels, nxt, lambda cur, xv: torch.full_like(cur, level))
            frontier = nxt
    return levels.to_global().astype(np.int32)
