"""PageRank via distributed SpMV (paper §7.5, Fig 10).

r ← α · A_colnorm r + (1-α)/n · 1  (+ dangling mass redistribution),
one spmv_iter per step (SpMV + layout transpose), vectors fully distributed.

As in the JAX package, the loop state is the GLOBAL rank vector on the host
(numpy): each iteration places it on the device, multiplies, and reads the
new vector and the dangling mass back. That round trip is what made the
JAX loop checkpointable on any grid; it is kept.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dist import DistSpMat, DistVec, Grid
from ..core.matops import mat_reduce, mat_scale_cols, vec_apply, vec_sum
from ..core.plan import spmv_variant
from ..core.semiring import ARITHMETIC
from ..core.spmv import spmv_iter
from ..robust.recover import CheckpointedLoop


def pagerank(a: DistSpMat, *, mesh: Grid, alpha: float = 0.85,
             tol: float = 1e-8, max_iters: int = 100,
             checkpoint_dir: str | None = None,
             checkpoint_every: int = 1,
             elastic: bool = False, watchdog=None) -> np.ndarray:
    """PageRank of the directed graph with edge u→v ⇔ entry (v, u) ≠ 0.

    (Build A from an edge list as A[dst, src] = 1, or pass mat_transpose of
    the usual adjacency.)

    ``checkpoint_dir`` enables per-iteration checkpoint/resume
    (robust/recover.CheckpointedLoop, every ``checkpoint_every``
    iterations): re-running after a crash with the same directory resumes
    from the last saved iteration and converges to the bitwise-identical
    result of an uninterrupted run. The checkpointed state is the *global*
    rank vector, the JAX app's state, so a run can resume on another grid
    in a new world. ``watchdog`` (a ``launch.elastic.StepWatchdog``) flags
    straggling iterations. ``elastic=True`` (regridding in-process after a
    TopologyError) is not ported yet and raises.
    """
    if elastic:
        raise NotImplementedError(
            "pagerank(elastic=True): in-process regrid is not ported yet "
            "(ROADMAP.md queue 1, 'checkpoints and elastic state'); resume "
            "from checkpoint_dir in a new world instead")
    loop = CheckpointedLoop(checkpoint_dir, every=checkpoint_every,
                            watchdog=watchdog, name="pagerank")
    n = a.shape[0]
    grid = a.grid
    teleport = (1.0 - alpha) / n

    # out-degree of source vertices = column sums of A(dst, src)
    deg = mat_reduce(a, axis=0, add=ARITHMETIC.add, mesh=mesh)  # layout col
    inv = vec_apply(deg, lambda d: torch.where(
        d > 0, 1.0 / torch.clamp(d, min=1e-30), 0.0))
    an = mat_scale_cols(a, inv, mesh=mesh)        # column-stochastic
    # dangling indicator on the REAL vertices only (padding tail excluded)
    dangling_vec = DistVec.from_global(
        (deg.to_global()[:n] == 0).astype(np.float32), grid, layout="col",
        mesh=mesh)
    # planner rule: the local SpMV flavor whose sort the tiles already have
    variant = spmv_variant(an)

    def body(it, state):
        r_g = np.asarray(state["r"], np.float32)
        r = DistVec.from_global(r_g, grid, layout="col", mesh=mesh)
        dangling = float(vec_sum(
            DistVec(r.data * dangling_vec.data, n, grid, "col")))
        r_new = spmv_iter(an, r, ARITHMETIC, mesh=mesh,   # to 'col'
                          variant=variant)
        add_const = teleport + alpha * dangling / n
        r_new = vec_apply(r_new, lambda x: alpha * x + add_const)
        r_new_g = r_new.to_global()[:n]           # drops the padding tail
        delta = float(np.abs(r_new_g - r_g).sum())
        return {"r": r_new_g}, delta < tol

    state = loop.run({"r": np.full(n, 1.0 / n, np.float32)}, body, max_iters)
    out = np.asarray(state["r"], np.float32)
    return out / out.sum()
