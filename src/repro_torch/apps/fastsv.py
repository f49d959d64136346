"""FastSV connected components (paper §7.4, Fig 8; Zhang-Azad-Hu [37]).

The Shiloach-Vishkin family expressed in CombBLAS primitives — per
iteration, with parent vector f (int32 global vertex ids):

  gf = f[f]                                  (vector extract — assign.py)
  h[u] = min_{v ∈ N(u)} gf[v]                (SpMV, (min, select2nd))
  stochastic hooking:  f[f_old[u]] ⊕min= h[u]   (vector assign, accumulate)
  aggressive hooking:  f[u] ⊕min= h[u]          (piece-aligned ewise)
  shortcutting:        f[u] ⊕min= gf[u]
  converge when f stops changing; then pointer jumping to the roots.

As in the JAX package, the loop state is the GLOBAL parent vector on the
host (numpy), the same on every rank: each iteration places it on the
device and reads the new one back, which is what made the JAX loop
checkpointable on any grid. The loop's tests read grid-wide values, so
every rank takes the same branch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.assign import assign, extract
from ..core.dist import DistSpMat, DistVec, Grid, grid_all
from ..core.plan import spmv_variant
from ..core.semiring import MIN_INT, Semiring
from ..core.spmv import spmv_iter
from ..robust.recover import CheckpointedLoop

MIN_SELECT2ND_I32 = Semiring(MIN_INT, lambda a, b: b, "min_select2nd_i32")


def fastsv(a: DistSpMat, *, mesh: Grid, max_iters: int = 64,
           skew_aware: bool = False,
           checkpoint_dir: str | None = None,
           checkpoint_every: int = 1,
           elastic: bool = False, watchdog=None) -> np.ndarray:
    """Connected-component labels (int64) of the *symmetric* graph ``a``.

    ``checkpoint_dir`` checkpoints the parent vector every
    ``checkpoint_every`` hooking iterations (robust/recover.CheckpointedLoop)
    — a crashed run resumed with the same directory finishes
    bitwise-identically. The checkpointed state is the GLOBAL (n,) parent
    vector, the JAX app's state. The final pointer-jumping sweep is not
    checkpointed. ``watchdog`` flags straggling iterations.
    ``elastic=True`` (regridding in-process after a TopologyError) is not
    ported yet and raises.
    """
    if elastic:
        raise NotImplementedError(
            "fastsv(elastic=True): in-process regrid is not ported yet "
            "(ROADMAP.md queue 1, 'checkpoints and elastic state'); resume "
            "from checkpoint_dir in a new world instead")
    loop = CheckpointedLoop(checkpoint_dir, every=checkpoint_every,
                            watchdog=watchdog, name="fastsv")
    n = a.shape[0]
    grid = a.grid
    pr, pc = grid
    vb = -(-n // (pr * pc))
    # padding tail holds self ids >= n: never wins a min, never hooks a
    # real vertex
    npad = vb * pr * pc
    # worst-case hooking traffic concentrates on root pieces: size the
    # router for it
    rcap = max(npad, 64)
    variant = spmv_variant(a)         # planner: match the tile sort order

    def distribute(f_g: np.ndarray) -> DistVec:
        """Global (n,) parents -> padded DistVec on the grid."""
        tail = np.arange(n, npad, dtype=np.int32)
        return DistVec.from_global(
            np.concatenate([np.asarray(f_g, np.int32), tail]), grid,
            layout="col", mesh=mesh)

    def check(ok, what):
        if not grid_all(ok, grid):
            raise RuntimeError(f"fastsv: {what} overflowed its router "
                               f"(route_cap {rcap})")

    def body(it, state):
        f_old = distribute(state["f"])
        fi = f_old.data.to(torch.int32)
        # gf = f[f]  (grandparents)
        gf_vals, ok = extract(f_old, fi, mesh=mesh, route_cap=rcap)
        check(ok, "extract")
        gf = DistVec(gf_vals, n, grid, "col")
        # h[u] = min over neighbors of gf — (min, select2nd) SpMV
        h = spmv_iter(a, gf, MIN_SELECT2ND_I32, mesh=mesh,   # 'col'
                      variant=variant)
        # stochastic hooking: f[f_old[u]] = min(·, h[u]) — distributed assign
        f2, ok = assign(f_old, fi, h.data, mesh=mesh, add=MIN_INT,
                        accumulate=True, skew_aware=skew_aware,
                        route_cap=rcap)
        check(ok, "assign")
        # aggressive hooking + shortcutting (piece-aligned, no comm)
        fd = torch.minimum(torch.minimum(f2.data, h.data), gf.data)
        f_g = DistVec(fd, npad, grid, "col").to_global()[:n].astype(np.int32)
        # padding entries are fixed points (own id vs INT_MAX h), so
        # convergence on the real prefix IS convergence
        return {"f": f_g}, bool(np.array_equal(f_g, state["f"]))

    state = loop.run({"f": np.arange(n, dtype=np.int32)}, body, max_iters)
    # final pointer jumping to full convergence
    f = distribute(state["f"])
    for _ in range(max_iters):
        gf_vals, _ = extract(f, f.data.to(torch.int32), mesh=mesh,
                             route_cap=rcap)
        gf = DistVec(gf_vals, npad, grid, "col")
        if grid_all(gf.data == f.data, grid):
            break
        f = gf
    return f.to_global()[:n].astype(np.int64)
