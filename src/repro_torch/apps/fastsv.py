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
from ..core.dist import DistSpMat, DistVec, Grid, grid_all, make_grid
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

    ``elastic=True`` survives an in-process TopologyError: ``a`` is
    regridded onto the next smaller square grid of the same world (q →
    max(q // 2, 1)) and the interrupted iteration re-runs there; the ranks
    the smaller grid leaves out retire, and every rank of ``a``'s grid
    returns the same labels (``CheckpointedLoop.finish``).
    """
    n = a.shape[0]
    # grid-dependent context, rebuildable so the elastic path can shrink it
    ctx: dict = {}

    def setup(a2: DistSpMat, mesh2: Grid):
        pr, pc = a2.grid
        vb = -(-n // (pr * pc))
        ctx.update(
            mesh=mesh2, grid=a2.grid, a=a2,
            # padding tail holds self ids >= n: never wins a min, never
            # hooks a real vertex
            npad=vb * pr * pc,
            # worst-case hooking traffic concentrates on root pieces: size
            # the router for it
            rcap=max(vb * pr * pc, 64),
            variant=spmv_variant(a2))   # planner: match the tile sort order

    setup(a, mesh)

    def distribute(f_g: np.ndarray) -> DistVec:
        """Global (n,) parents -> padded DistVec on the current grid."""
        tail = np.arange(n, ctx["npad"], dtype=np.int32)
        return DistVec.from_global(
            np.concatenate([np.asarray(f_g, np.int32), tail]), ctx["grid"],
            layout="col", mesh=ctx["mesh"])

    def check(ok, what):
        if not grid_all(ok, ctx["grid"]):
            raise RuntimeError(f"fastsv: {what} overflowed its router "
                               f"(route_cap {ctx['rcap']})")

    def body(it, state):
        mesh2, grid2 = ctx["mesh"], ctx["grid"]
        rcap = ctx["rcap"]
        f_old = distribute(state["f"])
        fi = f_old.data.to(torch.int32)
        # gf = f[f]  (grandparents)
        gf_vals, ok = extract(f_old, fi, mesh=mesh2, route_cap=rcap)
        check(ok, "extract")
        gf = DistVec(gf_vals, n, grid2, "col")
        # h[u] = min over neighbors of gf — (min, select2nd) SpMV
        h = spmv_iter(ctx["a"], gf, MIN_SELECT2ND_I32, mesh=mesh2,  # 'col'
                      variant=ctx["variant"])
        # stochastic hooking: f[f_old[u]] = min(·, h[u]) — distributed assign
        f2, ok = assign(f_old, fi, h.data, mesh=mesh2, add=MIN_INT,
                        accumulate=True, skew_aware=skew_aware,
                        route_cap=rcap)
        check(ok, "assign")
        # aggressive hooking + shortcutting (piece-aligned, no comm)
        fd = torch.minimum(torch.minimum(f2.data, h.data), gf.data)
        f_g = DistVec(fd, ctx["npad"], grid2, "col").to_global()[:n] \
            .astype(np.int32)
        # padding entries are fixed points (own id vs INT_MAX h), so
        # convergence on the real prefix IS convergence
        return {"f": f_g}, bool(np.array_equal(f_g, state["f"]))

    on_topology = None
    if elastic:
        def on_topology(state, err):
            q = max(ctx["grid"][0] // 2, 1)
            new_mesh = make_grid(q, q, device=mesh.device)
            a2 = ctx["a"].regrid((q, q), mesh=new_mesh)
            ctx.clear()
            ctx["grid"] = (q, q)
            if a2 is not None:                   # None: this rank retires
                setup(a2, new_mesh)
            return state

    loop = CheckpointedLoop(checkpoint_dir, every=checkpoint_every,
                            watchdog=watchdog, on_topology=on_topology,
                            grid=lambda: ctx["grid"], name="fastsv")
    state = loop.run({"f": np.arange(n, dtype=np.int32)}, body, max_iters)
    if state is None:                            # retired by a shrink
        return loop.finish(None)
    # final pointer jumping to full convergence
    f = distribute(state["f"])
    for _ in range(max_iters):
        gf_vals, _ = extract(f, f.data.to(torch.int32), mesh=ctx["mesh"],
                             route_cap=ctx["rcap"])
        gf = DistVec(gf_vals, ctx["npad"], ctx["grid"], "col")
        if grid_all(gf.data == f.data, ctx["grid"]):
            break
        f = gf
    return loop.finish(f.to_global()[:n].astype(np.int64))
