"""Capacity planner — the paper's "rules of thumb", made executable.

CombBLAS 2.0 sizes SpGEMM outputs with a symbolic phase before the numeric
phase (§4.1) and gives scenario rules for picking data structures and
algorithm variants (§5, §7). Every buffer of the port is a capacity, as in
the JAX package, so a wrong guess either overflows (too small) or wastes
memory (too large). This module centralizes the guessing:

  1. **Estimate** flops and nnz(C) from tile nnz statistics — a cheap
     symbolic pass over the host copy of ``DistSpMat.nnz``.
  2. **Derive** ``prod_cap`` / ``out_cap`` with a safety factor, quantized
     to powers of two.
  3. **Bound** every cap by a true worst case (products can never exceed
     nnz(A-tile)·nnz(B-tile) per stage; outputs never exceed the dense
     tile), so overflow-retry terminates.
  4. **Retry on overflow**: the kernels' ``ok`` flags are checked on the
     host; a failed attempt re-runs with grown caps instead of returning
     truncated results.
  5. **Pick variants** by the paper's rules of thumb (DESIGN.md §4.6).

Apps call ``spgemm`` / ``spmspv`` below with NO capacity arguments; explicit
caps remain available as overrides. The retry loops are the JAX package's:
a failed audit (``robust/audit.py``) or a tripped exchange deadline
(``robust/deadline.py``) re-runs from the pristine inputs, and when plain
retries keep failing the degradation ladder (``robust/recover.py``) swaps
in more conservative pipeline pieces.

On a grid of several ranks every host read that steers the planner or its
retry loop is a collective value (the gathered tile nnz, the grid-wide
``ok`` flags, the grid-wide frontier size), and every audit, deadline and
ok-flag fault is decided collectively, so every rank takes the same
branch.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np

from ..obs import recorder as _obs
from ..robust import (audit as _audit, deadline as _deadline,
                      faults as _faults, recover as _recover)
from .coo import COO
from .dist import DistSpMat, DistSpVec, Grid, grid_all, grid_sum
from .local_spgemm import compression_ratio, local_algo, spgemm_flops
from .semiring import ARITHMETIC, Semiring
from .spgemm import spgemm_2d as _spgemm_2d
from .spmv import spmspv as _spmspv_2d

# Per-device scratch budget for planner decisions, in *entries* (a COO entry
# is ~16 bytes with indices): ~64 MB. Crossing it flips the memory-saving
# variant choices; it never bounds correctness (caps still grow on retry).
MEM_BUDGET_ENTRIES = 1 << 22

# Below this many total product slots (q·prod_cap) the legacy single
# concat-and-sort merge beats the merge tree (DESIGN.md §4.4/§4.6).
SORT_MERGE_ENTRIES = 1 << 13

# Hybrid-schedule rule of thumb (DESIGN.md §4.6/§4.8, after McFarland et
# al. arXiv 2504.06408): when the per-stage wire volumes are skewed
# (coefficient of variation of the stage operand sizes above this), batch
# the sparsest stages into one exchange (the all-to-all leg) and stream the
# dense stages as per-stage broadcasts; uniform stages keep the rotation.
HYBRID_STAGE_SKEW = 0.5


def _pow2(x: float, lo: int = 64) -> int:
    """Round up to a power of two (cap quantization)."""
    return max(lo, 1 << math.ceil(math.log2(max(float(x), 1.0))))


def _host_nnz(a: DistSpMat) -> np.ndarray:
    """Every tile's nnz, gathered: the same (pr, pc) array on every rank."""
    return a.host_nnz().astype(np.float64)


@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    prod_cap: int          # per-stage expansion slots per device
    out_cap: int           # merged output entries per device
    variant: str           # 'rotation' | 'allgather'
    merge: str             # 'sort' | 'deferred' | 'incremental' (§4.4)
    prod_ceiling: int      # worst-case bound — retry growth stops here
    out_ceiling: int
    est_flops: float       # estimated peak per-device per-stage products
    est_out: float         # estimated peak per-device nnz(C)
    attempts: int = 1      # how many numeric attempts the retry loop used
    degraded: tuple = ()   # ladder rungs taken (robust/recover.py), in order
    # exchange schedule (§4.8): None derives from the variant
    schedule: object = None
    overlap: bool = True   # double-buffered stage loops (False = bulk-sync)
    compress: Optional[str] = None   # 'int8' wire compression of values

    def at_ceiling(self) -> bool:
        return (self.prod_cap >= self.prod_ceiling
                and self.out_cap >= self.out_ceiling)

    def grown(self, factor: int = 4) -> "SpGEMMPlan":
        if self.at_ceiling():
            raise RuntimeError(
                "SpGEMM overflow at worst-case capacities "
                f"(prod_cap={self.prod_cap}, out_cap={self.out_cap}) — "
                "the ok flags disagree with the symbolic bound")
        return dataclasses.replace(
            self,
            prod_cap=min(self.prod_cap * factor, self.prod_ceiling),
            out_cap=min(self.out_cap * factor, self.out_ceiling),
            attempts=self.attempts + 1)


def plan_spgemm(a: DistSpMat, b: DistSpMat | None = None, *,
                safety: float = 4.0,
                prod_cap: int | None = None, out_cap: int | None = None,
                variant: str | None = None, merge: str | None = None,
                mask=None, schedule=None, overlap: bool = True,
                compress: str | None = None,
                mem_budget: int = MEM_BUDGET_ENTRIES) -> SpGEMMPlan:
    """Size and configure a 2D SpGEMM from tile nnz statistics.

    The estimate assumes entries spread uniformly over tile columns (the
    random-permutation load-balance story of §2.3); skewed inputs are caught
    by the overflow flags and absorbed by the safety factor + retry growth.

    ``mask`` (a ``mask.MaskSpec``): a pattern mask bounds the per-tile
    output EXACTLY — a structural mask's C tile holds at most its mask
    tile's nnz, a complement mask's at most dense-tile − nnz — so both the
    out estimate and the retry ceiling intersect with the mask stats (§4.7).
    """
    b = a if b is None else b
    q = a.pr
    na = _host_nnz(a).reshape(q, q)
    nb_ = _host_nnz(b).reshape(q, q)
    inner = float(max(a.nb, 1))            # contraction dim of one tile pair

    # stage (i, j, k) multiplies A(i,k) · B(k,j): expected products under
    # uniform column occupancy, exact upper bound nnz_a * nnz_b
    pair = na[:, :, None] * nb_[None, :, :]
    stage_est = float(pair.max()) / inner
    stage_bound = float(pair.max())
    # per-device output: flops estimate summed over stages, capped by the
    # dense C tile (distinct (row, col) pairs cannot exceed it)
    flops_dev = np.einsum("ik,kj->ij", na, nb_) / inner
    dense_tile = float(a.mb) * float(b.nb)
    out_bound = min(stage_bound * q, dense_tile)
    if mask is not None and mask.mat is not None:
        mn = _host_nnz(mask.mat).reshape(q, q)
        if not mask.complement:
            mask_bound = float(mn.max())
        elif mask.pred is None:
            mask_bound = float(dense_tile - mn.min())
        else:
            mask_bound = dense_tile
        out_bound = min(out_bound, max(mask_bound, 1.0))
    out_est = float(min(flops_dev.max(), out_bound))

    p_ceil = _pow2(stage_bound)
    o_ceil = _pow2(out_bound)
    p_cap = min(_pow2(prod_cap or safety * stage_est), p_ceil)
    o_cap = min(_pow2(out_cap or safety * out_est), o_ceil)
    if prod_cap:
        p_cap = max(p_cap, _pow2(prod_cap))   # explicit override wins
        p_ceil = max(p_ceil, p_cap)
    if out_cap:
        o_cap = max(o_cap, _pow2(out_cap))
        o_ceil = max(o_ceil, o_cap)

    # rules of thumb (DESIGN.md §4.6): allgather materializes q stage
    # operands at once — fine on small grids, memory-hostile at scale.
    # Merge strategy (§4.4): tiny product volume -> 'sort'; q·prod_cap
    # beyond the scratch budget -> 'incremental'; 'deferred' where the
    # engine's cap slack and tree work pay off; else 'sort'.
    if variant is None and schedule is not None:
        variant = ("rotation" if schedule == "rotate" else
                   "allgather" if schedule == "alltoall" else "hybrid")
    auto_sched = variant is None and schedule is None
    if variant is None:
        variant = "allgather" if q * (a.cap + b.cap) <= mem_budget \
            else "rotation"
    if merge is None:
        tree_slots = o_cap * max(math.log2(max(q, 2)), 1.0)
        if q * p_cap <= SORT_MERGE_ENTRIES:
            merge = "sort"
        elif q * p_cap > mem_budget:
            merge = "incremental"
        elif p_cap >= 4 * stage_est and tree_slots <= q * p_cap / 4:
            merge = "deferred"
        else:
            merge = "sort"
    if schedule is None and auto_sched and variant == "rotation" and q >= 2:
        # per-stage schedule pick (§4.8): stage k moves A(·,k)/B(k,·); when
        # the stage volumes are skewed, batch the sparsest stages (one
        # exchange) and broadcast the rest per stage. The gather count is
        # memory-bounded: each batched stage keeps one more operand pair.
        sk = na.max(axis=0) + nb_.max(axis=1)
        cv = float(sk.std() / max(sk.mean(), 1.0))
        g = int(min(q - 1, mem_budget // max(a.cap + b.cap, 1)))
        if cv > HYBRID_STAGE_SKEW and g >= 1:
            sparsest = set(int(k) for k in np.argsort(sk)[:g])
            schedule = tuple("gather" if k in sparsest else "bcast"
                             for k in range(q))
            variant = "hybrid"
    return SpGEMMPlan(p_cap, o_cap, variant, merge, p_ceil, o_ceil,
                      stage_est, out_est, schedule=schedule, overlap=overlap,
                      compress=compress)


def spgemm(a: DistSpMat, b: DistSpMat | None = None,
           sr: Semiring = ARITHMETIC, *, mesh: Grid,
           plan: SpGEMMPlan | None = None,
           prod_cap: int | None = None, out_cap: int | None = None,
           variant: str | None = None, merge: str | None = None,
           mask=None, schedule=None, overlap: bool = True,
           compress: str | None = None,
           safety: float = 4.0, max_attempts: int = 6, growth: int = 4):
    """Planned C = A ⊕.⊗ B (optionally C⟨M⟩ via ``mask``). Returns
    (C, plan-with-attempt-count).

    An overflowing attempt (any device's ``ok`` flag false) is retried with
    caps grown ×``growth`` toward the worst-case ceiling — never a silently
    truncated result. Pattern masks shrink the planned out/stage capacities
    to the mask-intersected estimate (§4.7), with the same retry loop as
    the safety net.

    Robustness (robust/): a failed audit (checksum mismatch across a comm
    boundary, invariant violation) counts as a failed attempt and re-runs
    from the pristine inputs; when plain retries keep failing — caps at
    the worst-case ceiling with ok still false, attempts exhausted, or
    persistent audit failures — the degradation ladder
    (``recover.next_rung``) swaps in progressively more conservative
    pipeline pieces, one loud warning each, recorded in ``plan.degraded``.
    Only when the ladder is exhausted does this raise.
    """
    b = a if b is None else b
    p = plan if plan is not None else plan_spgemm(
        a, b, safety=safety, prod_cap=prod_cap, out_cap=out_cap,
        variant=variant, merge=merge, mask=mask, schedule=schedule,
        overlap=overlap, compress=compress)
    _plan_event("plan.spgemm", p)
    cur_mask = mask
    post_mask = None       # set when the 'postfilter' rung strips the mask
    audit_fails = 0
    while True:
        try:
            c, ok = _spgemm_2d(a, b, sr, mesh=mesh, prod_cap=p.prod_cap,
                               out_cap=p.out_cap, variant=p.variant,
                               merge=p.merge, mask=cur_mask,
                               schedule=p.schedule, overlap=p.overlap,
                               compress=p.compress)
        except _audit.AuditError as err:
            audit_fails += 1
            p, cur_mask, post_mask = _after_audit_error(
                "spgemm", err, audit_fails, p, cur_mask, post_mask,
                lambda rung, p, m, pm: _spgemm_take_rung(
                    rung, p, a, b, safety, m, pm))
            continue
        ok = _faults.flip_ok("plan.spgemm.ok", ok)
        if grid_all(ok, c.grid):
            if post_mask is not None:
                c = _recover.postfilter_2d(c, post_mask, sr, mesh=mesh)
            if p.attempts > 1 or p.degraded:
                _plan_event("plan.spgemm.done", p)
            return c, p
        if p.attempts < max_attempts and not p.at_ceiling():
            _obs.event("plan.overflow_retry", op="spgemm",
                       attempt=p.attempts, prod_cap=p.prod_cap,
                       out_cap=p.out_cap)
            _obs.counter_add("plan.overflow_retries")
            p = p.grown(growth)
            continue
        rung = _recover.next_rung(p, cur_mask, kind="spgemm")
        if rung is None:
            raise RuntimeError(
                f"SpGEMM still overflowing after {p.attempts} attempts "
                f"(prod_cap={p.prod_cap}, out_cap={p.out_cap}) — "
                f"degradation ladder exhausted (degraded={p.degraded})")
        p = _recover.apply_rung(rung, p)
        p, cur_mask, post_mask = _spgemm_take_rung(
            rung, p, a, b, safety, cur_mask, post_mask)


# Audit failures are retried from pristine inputs this many times before
# the retry loop escalates to the degradation ladder (transient wire faults
# vs. a persistently-implicated pipeline stage).
MAX_AUDIT_RETRIES = 3

_OP_NAME = {"spgemm": "SpGEMM", "spmspv": "SpMSpV"}


def _after_audit_error(op, err, audit_fails, p, cur_mask, post_mask,
                       take_rung):
    """The retry loops' answer to a failed attempt's AuditError (every rank
    raised it together): retry from the pristine inputs, after a seeded
    backoff when a deadline tripped; past ``MAX_AUDIT_RETRIES``, the next
    ladder rung; with the ladder exhausted, re-raise — a timeout as
    :class:`~repro_torch.robust.deadline.TopologyError`. Returns the next
    attempt's ``(plan, mask, post_mask)``."""
    timeout = isinstance(err, _deadline.ExchangeTimeout)
    _obs.event("plan.audit_retry", op=op, site=err.site,
               attempt=p.attempts, fails=audit_fails, timeout=timeout)
    _obs.counter_add("plan.audit_retries")
    name = _OP_NAME[op]
    if audit_fails <= MAX_AUDIT_RETRIES:
        warnings.warn(
            f"{name} attempt {p.attempts} failed audit at {err.site}: "
            f"{err} — retrying from pristine inputs "
            f"({audit_fails}/{MAX_AUDIT_RETRIES})",
            RuntimeWarning, stacklevel=3)
        if timeout:
            # a deadline trip means a straggling peer, not a flipped bit —
            # give the topology time to heal before hammering the same
            # exchange (deterministic seeded backoff, the same on every
            # rank)
            _deadline.backoff_sleep(err.site, audit_fails)
        return (dataclasses.replace(p, attempts=p.attempts + 1), cur_mask,
                post_mask)
    rung = _recover.next_rung(p, cur_mask, kind=op)
    if rung is None:
        if timeout:
            raise _deadline.TopologyError(
                f"{name} exchange at {err.site} still over deadline after "
                f"{p.attempts} attempts with the degradation ladder "
                f"exhausted (degraded={p.degraded}) — the topology, not the "
                "data, is at fault", err.site) from err
        raise err
    p = _recover.apply_rung(rung, p)
    if timeout:
        # the shed schedule's exchanges have different timing: the old
        # trailing-median budget would trip spuriously
        _deadline.reset(err.site)
    return take_rung(rung, p, cur_mask, post_mask)


def _spgemm_take_rung(rung, p, a, b, safety, cur_mask, post_mask):
    """Post-``apply_rung`` bookkeeping the planner owns: the 'postfilter'
    rung strips the mask from the multiply (applied post-hoc on success),
    which invalidates the mask-shrunk capacities — re-plan for the unmasked
    output, keeping the grown caps as floors."""
    p = dataclasses.replace(p, attempts=p.attempts + 1)
    if rung != "postfilter":
        return p, cur_mask, post_mask
    fresh = plan_spgemm(a, b, safety=safety, variant=p.variant, merge=p.merge)
    p = dataclasses.replace(
        p,
        prod_cap=max(p.prod_cap, fresh.prod_cap),
        out_cap=max(p.out_cap, fresh.out_cap),
        prod_ceiling=max(p.prod_ceiling, fresh.prod_ceiling),
        out_ceiling=max(p.out_ceiling, fresh.out_ceiling))
    return p, None, cur_mask


def demote_stage(plan: SpGEMMPlan, stage: int, q: int) -> SpGEMMPlan:
    """Re-plan the hybrid schedule away from a persistently slow stage:
    the stage moves from the per-stage broadcast to the batched 'gather'
    leg (§4.8). Whole-sweep schedules first expand to ``('bcast',) * q``;
    the result is a length-``q`` tuple with ``variant='hybrid'``, recorded
    in ``plan.degraded`` as ``demote-stage:<k>``."""
    if not 0 <= stage < q:
        raise ValueError(f"stage {stage} outside [0, q={q})")
    s = plan.schedule
    base = tuple(s) if isinstance(s, (tuple, list)) else ("bcast",) * q
    if len(base) != q:
        raise ValueError(
            f"plan schedule has {len(base)} stages, expected q={q}")
    if base[stage] == "gather":
        return plan                       # already off the broadcast path
    warnings.warn(
        f"robust: demoting exchange stage {stage} to the batched 'gather' "
        f"leg (persistent straggler; schedule was {s!r})",
        RuntimeWarning, stacklevel=2)
    _obs.event("ladder.demote_stage", stage=stage,
               schedule=s if (s is None or isinstance(s, str)) else "hybrid")
    _obs.counter_add("ladder.demotions")
    sched = base[:stage] + ("gather",) + base[stage + 1:]
    return dataclasses.replace(
        plan, schedule=sched, variant="hybrid",
        degraded=tuple(plan.degraded) + (f"demote-stage:{stage}",))


def _plan_event(kind: str, p):
    """One structured obs event carrying a plan's full decision record
    (an SpMSpV plan has no schedule, overlap or compression: None)."""
    if not _obs.enabled():
        return
    s = getattr(p, "schedule", None)
    _obs.event(kind, variant=p.variant, merge=p.merge,
               schedule=s if (s is None or isinstance(s, str)) else "hybrid",
               overlap=getattr(p, "overlap", None),
               compress=getattr(p, "compress", None),
               prod_cap=p.prod_cap, out_cap=p.out_cap,
               attempts=p.attempts, degraded=",".join(p.degraded))


# --------------------------------------------------------------------------
# SpMSpV planning
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpMSpVPlan:
    prod_cap: int
    out_cap: int
    variant: str           # local kernel: 'sort' | 'bucket' | 'spa'
    merge: str             # 'sparse' | 'dense'
    use_spmv: bool         # rule of thumb: dense SpMV beats SpMSpV here
    prod_ceiling: int
    out_ceiling: int
    density: float
    attempts: int = 1
    degraded: tuple = ()   # ladder rungs taken (robust/recover.py), in order

    def at_ceiling(self) -> bool:
        return (self.prod_cap >= self.prod_ceiling
                and self.out_cap >= self.out_ceiling)

    def grown(self, factor: int = 4) -> "SpMSpVPlan":
        if self.at_ceiling():
            raise RuntimeError(
                "SpMSpV overflow at worst-case capacities "
                f"(prod_cap={self.prod_cap}, out_cap={self.out_cap})")
        return dataclasses.replace(
            self,
            prod_cap=min(self.prod_cap * factor, self.prod_ceiling),
            out_cap=min(self.out_cap * factor, self.out_ceiling),
            attempts=self.attempts + 1)


def spmspv_variant_for_density(density: float) -> str:
    """Fig-3 rule of thumb (§4.5): sort ≲0.5%, bucket ≲10%, SPA above."""
    if density < 0.005:
        return "sort"
    if density < 0.10:
        return "bucket"
    return "spa"


def plan_spmspv(a: DistSpMat, frontier_nnz: int, *, safety: float = 4.0,
                prod_cap: int | None = None, out_cap: int | None = None,
                variant: str | None = None, merge: str | None = None,
                add_tag: str | None = None,
                mask_allowed: int | None = None) -> SpMSpVPlan:
    """Size y = A·x for a sparse x with ``frontier_nnz`` stored entries.

    Expected per-device products = nnz(A_tile) · frontier density; the
    exact worst case is the full tile, which bounds retry growth.
    ``add_tag`` (the semiring's add-monoid tag) lets the dense-merge rule
    apply (it needs a 'sum' monoid). ``mask_allowed`` (mask-admissible
    output rows, ``mask_allowed_count``) bounds y's stored entries exactly,
    so out caps (not prod caps: the expansion still enumerates every flop)
    intersect with it; BFS's complement mask shrinks them as the search
    saturates.
    """
    nt = _host_nnz(a)
    max_tile = float(nt.max()) if nt.size else 1.0
    pc = a.grid[1]
    n = max(a.shape[1], 1)
    f = max(int(frontier_nnz), 1)
    density = f / n
    est = max(max_tile * density, 1.0)
    p_ceil = _pow2(max_tile)
    # the sparse merge buckets entries by destination piece with
    # out_cap // pc slots each, and all of a partial's entries may target
    # one piece: the out ceiling carries a ×pc factor
    out_bound = min(max_tile, float(a.mb))
    out_est = est
    if mask_allowed is not None:
        allowed = float(max(int(mask_allowed), 1))
        out_bound = min(out_bound, allowed)
        out_est = min(out_est, allowed)
    o_ceil = _pow2(out_bound * pc)
    p_cap = min(_pow2(prod_cap or safety * est), p_ceil)
    o_cap = min(_pow2(out_cap or safety * out_est * pc), o_ceil)
    if prod_cap:
        p_cap = max(p_cap, _pow2(prod_cap))
        p_ceil = max(p_ceil, p_cap)
    if out_cap:
        o_cap = max(o_cap, _pow2(out_cap))
        o_ceil = max(o_ceil, o_cap)
    use_spmv = density > 0.30    # §4.5: SpMSpV stays competitive far past
    #                              where intuition says to switch
    if merge is None:
        # for dense-ish frontiers the dense accumulator + psum_scatter merge
        # is the classic SpMV pipeline (needs a natively reducible monoid)
        merge = "dense" if use_spmv and add_tag == "sum" else "sparse"
    return SpMSpVPlan(
        prod_cap=p_cap, out_cap=o_cap,
        variant=variant or spmspv_variant_for_density(density),
        merge=merge, use_spmv=use_spmv, prod_ceiling=p_ceil,
        out_ceiling=o_ceil, density=density)


def spmspv(a: DistSpMat, x: DistSpVec, sr: Semiring, *, mesh: Grid,
           plan: SpMSpVPlan | None = None,
           prod_cap: int | None = None, out_cap: int | None = None,
           variant: str | None = None, merge: str | None = None,
           mask=None, safety: float = 4.0, max_attempts: int = 6,
           growth: int = 4):
    """Planned y = A·x (sparse x, optionally masked). Returns (DistSpVec,
    plan).

    Plans from the *current* frontier size (one host scalar), so iterative
    callers (BFS) get caps that track the frontier; a vector mask also caps
    the output at the admissible-row count (a second host scalar). An
    overflowing attempt retries with caps grown ×``growth`` toward the
    ceiling; failed audits and deadline trips retry from the pristine
    frontier and then walk the ladder, as in :func:`spgemm`.
    """
    if plan is None:
        allowed = None
        if mask is not None:
            from .mask import mask_allowed_count
            allowed = mask_allowed_count(mask)
        plan = plan_spmspv(
            a, int(grid_sum(x.nnz, x.grid)), safety=safety,
            prod_cap=prod_cap,
            out_cap=out_cap, variant=variant, merge=merge,
            add_tag=sr.add.tag, mask_allowed=allowed)
    p = plan
    _plan_event("plan.spmspv", p)
    cur_mask = mask
    post_mask = None
    audit_fails = 0
    while True:
        try:
            y, ok = _spmspv_2d(a, x, sr, mesh=mesh, variant=p.variant,
                               merge=p.merge, prod_cap=p.prod_cap,
                               out_cap=p.out_cap, mask=cur_mask)
        except _audit.AuditError as err:
            audit_fails += 1
            p, cur_mask, post_mask = _after_audit_error(
                "spmspv", err, audit_fails, p, cur_mask, post_mask,
                lambda rung, p, m, pm: _spmspv_take_rung(
                    rung, p, a, x, safety, sr, m, pm))
            continue
        ok = _faults.flip_ok("plan.spmspv.ok", ok)
        if grid_all(ok, y.grid):
            if post_mask is not None:
                y = _recover.postfilter_spvec(y, post_mask)
            if p.attempts > 1 or p.degraded:
                _plan_event("plan.spmspv.done", p)
            return y, p
        if p.attempts < max_attempts and not p.at_ceiling():
            _obs.event("plan.overflow_retry", op="spmspv",
                       attempt=p.attempts, prod_cap=p.prod_cap,
                       out_cap=p.out_cap)
            _obs.counter_add("plan.overflow_retries")
            p = p.grown(growth)
            continue
        rung = _recover.next_rung(p, cur_mask, kind="spmspv")
        if rung is None:
            raise RuntimeError(
                f"SpMSpV still overflowing after {p.attempts} attempts "
                f"(prod_cap={p.prod_cap}, out_cap={p.out_cap}) — "
                f"degradation ladder exhausted (degraded={p.degraded})")
        p = _recover.apply_rung(rung, p)
        p, cur_mask, post_mask = _spmspv_take_rung(
            rung, p, a, x, safety, sr, cur_mask, post_mask)


def _spmspv_take_rung(rung, p, a, x, safety, sr, cur_mask, post_mask):
    """SpMSpV counterpart of ``_spgemm_take_rung``: dropping the mask
    invalidates the mask-capped output sizing — re-plan unmasked."""
    p = dataclasses.replace(p, attempts=p.attempts + 1)
    if rung != "postfilter":
        return p, cur_mask, post_mask
    fresh = plan_spmspv(a, int(grid_sum(x.nnz, x.grid)), safety=safety,
                        variant=p.variant, merge=p.merge, add_tag=sr.add.tag)
    p = dataclasses.replace(
        p,
        prod_cap=max(p.prod_cap, fresh.prod_cap),
        out_cap=max(p.out_cap, fresh.out_cap),
        prod_ceiling=max(p.prod_ceiling, fresh.prod_ceiling),
        out_ceiling=max(p.out_ceiling, fresh.out_ceiling))
    return p, None, cur_mask


def spmv_variant(a: DistSpMat) -> str:
    """Local SpMV flavor whose required sort order the tile already has
    (§4.2): row-partitioned wants row-major tiles, col-partitioned
    col-major, so matching the order tag makes the kernel's sort a no-op."""
    return "col" if a.order == "col" else "row"


# --------------------------------------------------------------------------
# local (single-tile) planning — benchmarks and non-distributed callers
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalSpGEMMPlan:
    prod_cap: int
    out_cap: int
    algo: str              # 'esc' | 'dense'
    flops: int             # exact symbolic count
    ratio: float           # estimated compression ratio


def plan_local_spgemm(a: COO, b: COO, *, safety: float = 1.25,
                      dense_threshold: float = 4.0,
                      dense_tile_limit: int = 1 << 22,
                      mask_nnz: int | None = None) -> LocalSpGEMMPlan:
    """Exact symbolic phase for one tile pair (paper §4.1 phase 1).

    ``spgemm_flops`` is exact, so ``prod_cap`` cannot overflow; ``out_cap``
    is bounded by min(flops, dense tile) — and by ``mask_nnz`` when the
    caller multiplies under a structural mask (the masked output pattern is
    a subset of the mask, §4.7). The algo pick mirrors ``spgemm_auto``'s
    compression-ratio hybrid (one policy, ``local_algo``).
    """
    m, n = a.shape[0], b.shape[1]
    fl = int(spgemm_flops(a, b))
    ratio = float(compression_ratio(a, b))
    prod_cap = _pow2(max(fl, 1) * safety)
    out_bound = min(max(fl, 1), m * n)
    if mask_nnz is not None:
        out_bound = min(out_bound, max(int(mask_nnz), 1))
    out_cap = min(_pow2(out_bound * safety), _pow2(m * n))
    algo = local_algo(a, b, dense_threshold=dense_threshold,
                      dense_tile_limit=dense_tile_limit, ratio=ratio)
    return LocalSpGEMMPlan(prod_cap, out_cap, algo, fl, ratio)


@dataclasses.dataclass(frozen=True)
class LocalSpMSpVPlan:
    prod_cap: int
    out_cap: int
    variant: str
    use_spmv: bool
    density: float


def plan_local_spmspv(a: COO, frontier_nnz: int, *,
                      safety: float = 4.0) -> LocalSpMSpVPlan:
    """Size a local y = A·x for a sparse x with ``frontier_nnz`` entries and
    pick its variant by density (``spmspv_variant_for_density``)."""
    n = max(a.shape[1], 1)
    density = max(int(frontier_nnz), 1) / n
    nnz = int(a.nnz)
    est = max(nnz * density, 1.0)
    prod_cap = min(_pow2(safety * est), _pow2(max(nnz, 1)))
    out_cap = min(_pow2(safety * est), _pow2(a.shape[0]))
    return LocalSpMSpVPlan(prod_cap, out_cap,
                           spmspv_variant_for_density(density),
                           density > 0.30, density)
