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

from ..core.dist import DistSpMat, DistVec, Grid, make_grid
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
    straggling iterations.

    ``elastic=True`` additionally survives an in-process TopologyError
    (injected device loss, exhausted exchange deadlines): the loop
    checkpoints, regrids the normalized matrix onto the next smaller square
    grid of the same world (q → max(q // 2, 1), world ranks 0 .. q²-1),
    and re-runs the interrupted iteration there. The ranks the smaller
    grid leaves out retire; every rank of ``a``'s grid returns the same
    vector (``CheckpointedLoop.finish``).
    """
    n = a.shape[0]
    teleport = (1.0 - alpha) / n

    # grid-dependent operands live in a rebuildable context so the elastic
    # path can swap in a smaller grid mid-run
    ctx: dict = {}

    def setup(an: DistSpMat, dangling_g: np.ndarray, mesh2: Grid):
        grid2 = an.grid
        ctx.update(
            mesh=mesh2, grid=grid2, an=an,
            dangling=DistVec.from_global(dangling_g, grid2, layout="col",
                                         mesh=mesh2),
            # planner rule: the local SpMV flavor whose sort the tiles
            # already have is free
            variant=spmv_variant(an))

    # out-degree of source vertices = column sums of A(dst, src)
    deg = mat_reduce(a, axis=0, add=ARITHMETIC.add, mesh=mesh)  # layout col
    inv = vec_apply(deg, lambda d: torch.where(
        d > 0, 1.0 / torch.clamp(d, min=1e-30), 0.0))
    an0 = mat_scale_cols(a, inv, mesh=mesh)       # column-stochastic
    # dangling indicator on the REAL vertices only (padding tail excluded)
    dangling_g0 = (deg.to_global()[:n] == 0).astype(np.float32)
    setup(an0, dangling_g0, mesh)
    del deg, inv, an0

    def body(it, state):
        r_g = np.asarray(state["r"], np.float32)
        grid2, mesh2 = ctx["grid"], ctx["mesh"]
        r = DistVec.from_global(r_g, grid2, layout="col", mesh=mesh2)
        dangling = float(vec_sum(
            DistVec(r.data * ctx["dangling"].data, n, grid2, "col")))
        r_new = spmv_iter(ctx["an"], r, ARITHMETIC, mesh=mesh2,  # to 'col'
                          variant=ctx["variant"])
        add_const = teleport + alpha * dangling / n
        r_new = vec_apply(r_new, lambda x: alpha * x + add_const)
        r_new_g = r_new.to_global()[:n]           # drops the padding tail
        delta = float(np.abs(r_new_g - r_g).sum())
        return {"r": r_new_g}, delta < tol

    on_topology = None
    if elastic:
        def on_topology(state, err):
            q = max(ctx["grid"][0] // 2, 1)
            new_mesh = make_grid(q, q, device=mesh.device)
            # regrid the already-normalized matrix: entry values move
            # bit-identically, no re-normalization drift
            an2 = ctx["an"].regrid((q, q), mesh=new_mesh)
            dangling_g = ctx["dangling"].to_global()[:n]
            ctx.clear()
            ctx["grid"] = (q, q)
            if an2 is not None:                  # None: this rank retires
                setup(an2, dangling_g, new_mesh)
            return state

    loop = CheckpointedLoop(checkpoint_dir, every=checkpoint_every,
                            watchdog=watchdog, on_topology=on_topology,
                            grid=lambda: ctx["grid"], name="pagerank")
    state = loop.run({"r": np.full(n, 1.0 / n, np.float32)}, body, max_iters)
    if state is None:                            # retired by a shrink
        return loop.finish(None)
    out = np.asarray(state["r"], np.float32)
    return loop.finish(out / out.sum())
