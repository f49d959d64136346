"""HipMCL — Markov clustering at scale (paper §7.5, Fig 9; Azad et al [38]).

MCL iterates on a column-stochastic matrix:
  expansion:  C ← C·C            (planned SpGEMM — the dominant cost)
  inflation:  C ← C.^r, column-renormalized
  pruning:    drop entries below threshold (keeps the iterate sparse)
until the iterate is (near-)idempotent; clusters are the weakly-connected
components of the converged attractor pattern (extracted with FastSV).

As in the JAX package, the loop state is the GLOBAL COO of the iterate on
the host: each iteration assembles it on the device (``from_global_coo``)
and reads it back (``to_global_coo``), which is what made the JAX loop
checkpointable on any grid.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.coo import ewise_union
from ..core.dist import DistSpMat, Grid, make_grid
from ..core.mask import value_mask
from ..core.matops import (mat_apply_local, mat_ewise_local, mat_reduce,
                           mat_scale_cols, mat_sum, mat_transpose, vec_apply)
from ..core.plan import spgemm as spgemm_planned
from ..core.semiring import ARITHMETIC
from ..robust.recover import CheckpointedLoop
from .fastsv import fastsv


def _normalize_cols(a: DistSpMat, *, mesh: Grid) -> DistSpMat:
    s = mat_reduce(a, axis=0, add=ARITHMETIC.add, mesh=mesh)
    inv = vec_apply(s, lambda d: torch.where(
        d > 0, 1.0 / torch.clamp(d, min=1e-30), 0.0))
    return mat_scale_cols(a, inv, mesh=mesh)


def hipmcl(a: DistSpMat, *, mesh: Grid, inflation: float = 2.0,
           prune_threshold: float = 1e-4, max_iters: int = 20,
           prod_cap: int | None = None, out_cap: int | None = None,
           tol: float = 1e-5,
           checkpoint_dir: str | None = None,
           checkpoint_every: int = 1,
           elastic: bool = False, watchdog=None) -> np.ndarray:
    """Cluster the graph; returns per-vertex cluster labels (int64).

    Expansion capacities are re-planned each iteration from the current
    iterate's tile nnz and grown on overflow; the caps in the signature
    are optional overrides only. Callers should include self-loops in
    ``a`` (MCL standard practice).

    ``checkpoint_dir`` checkpoints the iterate every ``checkpoint_every``
    MCL iterations (robust/recover.CheckpointedLoop): the state is the
    JAX app's — the GLOBAL int64 COO of the iterate, its ``order`` tag and
    ``prev_sum`` — whose shapes change between iterations, so resume reads
    it through ``restore_flat``; a crashed run resumed with the same
    directory clusters bitwise-identically. ``watchdog`` flags straggling
    iterations.

    ``elastic=True`` survives an in-process TopologyError by moving the
    loop onto the next smaller square grid of the same world (q →
    max(q // 2, 1)): the state is global COO, so only the mesh moves and
    the interrupted iteration re-assembles its iterate there. The ranks
    the smaller grid leaves out retire; every rank of ``a``'s grid returns
    the same labels (``CheckpointedLoop.finish``).
    """
    n = a.shape[0]
    # grid-dependent context, rebuildable so the elastic path can shrink it
    ctx = {"mesh": mesh, "grid": a.grid}
    c = _normalize_cols(a, mesh=mesh)
    # value-predicate mask (§4.7): entries of the expansion C·C already
    # below the prune threshold are dropped inside the multiply's final
    # merge compaction; the explicit prune below still runs post-inflation
    expansion_mask = value_mask(lambda v: v > prune_threshold)

    def pack_state(c: DistSpMat, prev_sum: float) -> dict:
        # GLOBAL COO: nnz changes between iterations (pruning); the order
        # tag rides along as bytes
        rows, cols, vals = c.to_global_coo()
        return {"rows": rows, "cols": cols, "vals": vals,
                "order": np.frombuffer(c.order.encode(), dtype=np.uint8),
                "prev_sum": np.float64(prev_sum)}

    def unpack_state(state: dict):
        tag = bytes(np.asarray(state["order"])).decode()
        c = DistSpMat.from_global_coo(
            (n, n), state["rows"], state["cols"], state["vals"],
            ctx["grid"], mesh=ctx["mesh"],
            order=tag if tag in ("row", "col") else "row")
        return c, float(state["prev_sum"])

    def body(it, state):
        mesh2 = ctx["mesh"]
        c, prev_sum = unpack_state(state)
        c2, _plan = spgemm_planned(c, c, ARITHMETIC, mesh=mesh2,
                                   mask=expansion_mask,
                                   prod_cap=prod_cap, out_cap=out_cap)
        # inflation
        c2 = mat_apply_local(c2, lambda t: t.apply(lambda v: v ** inflation),
                             mesh=mesh2)
        c2 = _normalize_cols(c2, mesh=mesh2)
        # pruning
        c2 = mat_apply_local(
            c2, lambda t: t.prune(lambda v: v > prune_threshold), mesh=mesh2)
        c2 = _normalize_cols(c2, mesh=mesh2)
        chaos = float(mat_sum(mat_ewise_local(
            c2, c2, lambda t1, t2: t1.apply(lambda v: v * v), mesh=mesh2)))
        done = (not np.isnan(prev_sum)) and abs(chaos - prev_sum) < tol
        return pack_state(c2, chaos), done

    on_topology = None
    if elastic:
        def on_topology(state, err):
            q = max(ctx["grid"][0] // 2, 1)
            # global COO: unpack lands it on the new grid
            ctx.update(mesh=make_grid(q, q, device=mesh.device),
                       grid=(q, q))
            return state

    loop = CheckpointedLoop(checkpoint_dir, every=checkpoint_every,
                            watchdog=watchdog, on_topology=on_topology,
                            grid=lambda: ctx["grid"], name="hipmcl")
    state = loop.run(pack_state(c, np.nan), body, max_iters)
    del c
    if state is None:                            # retired by a shrink
        return loop.finish(None)
    mesh = ctx["mesh"]
    c, _ = unpack_state(state)
    # clusters = connected components of the attractor pattern (symmetrized).
    # The union holds up to nnz(C) + nnz(C^T) entries: its capacity is the
    # sum of both (ewise_union's default). The JAX package passes
    # cap=t1.cap, which drops the row-major tail of the union whenever the
    # attractor pattern is not symmetric, splitting clusters (ROADMAP.md
    # §3, reference defect 5).
    ct = mat_transpose(c, mesh=mesh)
    sym = mat_ewise_local(
        c, ct, lambda t1, t2: ewise_union(t1, t2, ARITHMETIC.add),
        mesh=mesh)
    return loop.finish(fastsv(sym, mesh=mesh))
