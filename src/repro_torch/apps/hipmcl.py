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
from ..core.dist import DistSpMat, Grid
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
    iterations. ``elastic=True`` (regridding in-process after a
    TopologyError) is not ported yet and raises.
    """
    if elastic:
        raise NotImplementedError(
            "hipmcl(elastic=True): in-process regrid is not ported yet "
            "(ROADMAP.md queue 1, 'checkpoints and elastic state'); resume "
            "from checkpoint_dir in a new world instead")
    loop = CheckpointedLoop(checkpoint_dir, every=checkpoint_every,
                            watchdog=watchdog, name="hipmcl")
    n = a.shape[0]
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
            (n, n), state["rows"], state["cols"], state["vals"], a.grid,
            mesh=mesh, order=tag if tag in ("row", "col") else "row")
        return c, float(state["prev_sum"])

    def body(it, state):
        c, prev_sum = unpack_state(state)
        c2, _plan = spgemm_planned(c, c, ARITHMETIC, mesh=mesh,
                                   mask=expansion_mask,
                                   prod_cap=prod_cap, out_cap=out_cap)
        # inflation
        c2 = mat_apply_local(c2, lambda t: t.apply(lambda v: v ** inflation),
                             mesh=mesh)
        c2 = _normalize_cols(c2, mesh=mesh)
        # pruning
        c2 = mat_apply_local(
            c2, lambda t: t.prune(lambda v: v > prune_threshold), mesh=mesh)
        c2 = _normalize_cols(c2, mesh=mesh)
        chaos = float(mat_sum(mat_ewise_local(
            c2, c2, lambda t1, t2: t1.apply(lambda v: v * v), mesh=mesh)))
        done = (not np.isnan(prev_sum)) and abs(chaos - prev_sum) < tol
        return pack_state(c2, chaos), done

    state = loop.run(pack_state(c, np.nan), body, max_iters)
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
    return fastsv(sym, mesh=mesh)
