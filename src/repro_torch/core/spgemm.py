"""Distributed SpGEMM: 2D SUMMA (paper §3.2).

On a q×q grid the 2D algorithm runs q stages, each a local O(flops)
expansion of one A tile and one B tile, and merges the q stage buffers. The
exchange schedule decides how a stage's tiles reach a rank
(``core/comm.py``, one process a grid position):

  - schedule='rotate'   (variant='rotation'): Cannon's systolic schedule.
                        One grid-wide permute skews A and B, then q stages
                        of neighbour rotation (A left along 'col', B up
                        along 'row'), each followed by a local expansion.
  - schedule='alltoall' (variant='allgather'): every rank all-gathers its
                        process row of A and process column of B in one
                        shot, then runs the q local multiplies.
  - schedule='bcast' or a per-stage tuple (variant='hybrid'): SUMMA stage
                        order k = s with a broadcast per stage from the
                        stage's owner; a tuple schedule's 'gather' stages
                        are batched into one exchange up front.

Overlap (§4.8): with overlap=True every stage loop is double buffered —
stage s+1's exchange is issued (``async_op``) before stage s's local
expand, mask filter and merge, and the dead final rotation is dropped.
overlap=False is bulk-synchronous: each exchange starts after the
previous stage's work. Both run identical per-stage math, so their results
are bitwise equal.

The merge, whose mode the planner picks:

  merge='deferred'    compact each stage (kv_from_products) and fold the
                      compacted streams pairwise (kv_tree);
  merge='incremental' compact each stage and rank-merge it into a sorted
                      kv accumulator (kv_merge2);
  merge='sort'        the seed behavior — concatenate the padded stage
                      buffers and dedup once.

Under the rotate schedule the three modes run distinct code; under the
others 'deferred' and 'incremental' share the stage-merge tree
(``_staged_tail``), as in the JAX package. Wire compression
(``compress=``), the batched and the 3D SpGEMM wait for a later slice.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..obs import recorder as _obs
from . import comm
from .coo import COO
from .dist import DistSpMat, Grid
from .local_spgemm import _expand
from .mask import LocalMask, MaskSpec, apply_val_pred, filter_products
from .merge import (key_dtype, kv_empty, kv_from_products, kv_merge2,
                    kv_to_coo, kv_tree, merge_stage_products)
from .semiring import ARITHMETIC, Semiring

# variant (planner-facing algorithm family) -> whole-sweep schedule
_VARIANT_SCHEDULE = {"rotation": "rotate", "allgather": "alltoall",
                     "hybrid": "bcast"}
MERGES = ("sort", "deferred", "incremental")


def _schedule_from(variant, schedule, q):
    """Resolve the (variant, schedule) pair to an executable schedule: one of
    'rotate', 'alltoall', 'bcast', or a length-q tuple of 'bcast'|'gather'
    (the per-stage hybrid schedule)."""
    if schedule is None:
        try:
            return _VARIANT_SCHEDULE[variant]
        except KeyError:
            raise ValueError(f"unknown SpGEMM variant {variant!r}") from None
    if isinstance(schedule, (tuple, list)):
        sched = tuple(schedule)
        if len(sched) != q:
            raise ValueError(
                f"per-stage schedule has {len(sched)} entries for q={q}")
        bad = [s for s in sched if s not in ("bcast", "gather")]
        if bad:
            raise ValueError(f"per-stage schedule entries must be "
                             f"'bcast'|'gather', got {bad!r}")
        return sched
    if schedule not in ("rotate", "alltoall", "bcast"):
        raise ValueError(f"unknown schedule {schedule!r}")
    return schedule


@lru_cache(maxsize=None)
def _cannon_perms(q, skew_a=True):
    """(src, dst) pairs on a row-major q×q grid for the initial skew."""
    if skew_a:  # A(i, j) -> A(i, (j - i) mod q)
        return tuple((r * q + c, r * q + (c - r) % q)
                     for r in range(q) for c in range(q))
    # B(i, j) -> B((i - j) mod q, j)
    return tuple((r * q + c, ((r - c) % q) * q + c)
                 for r in range(q) for c in range(q))


@lru_cache(maxsize=None)
def _shift_perm(axis_len):
    """One step to the left along an axis: member s sends to s - 1."""
    return tuple((s, (s - 1) % axis_len) for s in range(axis_len))


def _merge_products(rows, cols, vals, nvalid, shape, sr, out_cap,
                    order="row", val_pred=None):
    prods = COO(rows, cols, vals,
                torch.clamp(torch.as_tensor(nvalid, device=rows.device),
                            max=rows.shape[0]).to(torch.int32),
                shape, "none")
    d = prods.dedup(sr.add, order=order)
    d = apply_val_pred(d, val_pred, sr.add.identity)
    # overflow must be read from the PRE-clamp nnz: with_cap() truncates
    # nnz to out_cap, which would make this check vacuously true
    ok = d.nnz <= out_cap
    return d.with_cap(out_cap, sr.add.identity), ok


def _staged_tail(outs, shape, sr, merge, prod_cap, stage_cap, out_cap,
                 mask, val_pred):
    """Merge the per-stage _expand outputs (the alltoall/bcast schedules)."""
    ident = sr.add.identity
    ok = torch.stack([o[4] for o in outs]).all()
    if merge == "sort":
        # seed path: concatenate the padded stage buffers, sort once —
        # masked products are dropped per stage, before the concat
        if mask is not None:
            outs = [(*filter_products(r, c_, v, shape, mask, ident), n, o)
                    for (r, c_, v, n, o) in outs]
        rows = torch.cat([o[0] for o in outs])
        cols = torch.cat([o[1] for o in outs])
        vals = torch.cat([o[2] for o in outs])
        total = sum(o[3] for o in outs)
        c, ok2 = _merge_products(rows, cols, vals, total, shape, sr,
                                 out_cap, val_pred=val_pred)
        return c, ok & ok2
    # merge engine: mask-filter + compact each stage, then fold the sorted
    # streams
    c, okm = merge_stage_products(
        [(r, c_, v, torch.clamp(n, max=prod_cap)) for (r, c_, v, n, _) in outs],
        shape, sr.add, stage_cap, out_cap, mask=mask)
    return apply_val_pred(c, val_pred, ident), ok & okm


def _rotate_sweep(q, overlap, rotate, step, state, at, bt):
    """Run the q Cannon stages, double-buffered or bulk-synchronous.

    overlap=True issues the next rotation before the current stage's
    expand and merge, so the exchange runs under the compute; the last
    stage multiplies its operands without rotating them (the dead final
    rotation is dropped). overlap=False rotates after each stage's work.
    Stage order and per-stage math are the same either way, so the results
    are bitwise equal. ``step(state, at, bt) -> (state, y)``; returns the
    final state and the list of the stages' ``y``.
    """
    ys = []
    for s in range(q):
        last = s == q - 1
        nxt = rotate(at, bt) if overlap and not last else None
        state, y = step(state, at, bt)
        ys.append(y)
        if not last:
            if nxt is None:
                nxt = rotate(at, bt)
            at, bt = nxt[0].wait(), nxt[1].wait()
    return state, ys


def _local_spgemm_2d(a_tile: COO, b_tile: COO, sr, q, prod_cap, out_cap,
                     schedule, merge, g, overlap=True,
                     mask: LocalMask | None = None, val_pred=None):
    """The per-rank body of the 2D algorithm (the JAX package's
    ``shard_map`` body), ``g`` this rank's ``comm.GridComm``.

    The engine paths ('deferred'/'incremental') compact each stage to
    stage_cap = min(prod_cap, out_cap) — sound because a stage's distinct
    count is bounded by the final nnz(C), and checked pre-clamp by the ok
    flags — then rank-merge the compacted streams, decoding rows/cols once.
    ``mask`` prunes every stage's expanded products against the local mask
    tile BEFORE any merge stage (§4.7); ``val_pred`` drops merged entries by
    output value in the final compaction.
    """
    if merge not in MERGES:
        raise ValueError(f"unknown merge {merge!r}")
    shape = (a_tile.shape[0], b_tile.shape[1])
    stage_cap = min(prod_cap, out_cap)
    ident = sr.add.identity
    if key_dtype(shape) is None:
        merge = "sort"        # unpackable tile: the engine needs packed keys

    if schedule == "alltoall":
        # gather my process row of A and process column of B (the broadcast
        # formulation; all stages' operands live at once, so every stage
        # waits for the one exchange and ``overlap`` has nothing to hide)
        ar = comm.tile_all_gather(a_tile, g, "col")
        bc = comm.tile_all_gather(b_tile, g, "row")
        outs = [_expand(ar[s], bc[s], sr, prod_cap) for s in range(q)]
        return _staged_tail(outs, shape, sr, merge, prod_cap, stage_cap,
                            out_cap, mask, val_pred)

    if schedule != "rotate":
        # hybrid SUMMA stage order k = s: a broadcast per stage from its
        # owner ('bcast'), the tuple schedule's 'gather' stages batched into
        # one exchange up front
        sched = schedule if isinstance(schedule, tuple) else ("bcast",) * q
        gs = [s for s in range(q) if sched[s] == "gather"]
        eag_a = eag_b = None
        if gs:
            eag_a = [comm.as_psum(t, g, "col")
                     for t in comm.tile_all_gather(a_tile, g, "col")]
            eag_b = [comm.as_psum(t, g, "row")
                     for t in comm.tile_all_gather(b_tile, g, "row")]

        def fetch(s):
            if s in gs:
                return (comm.Pending(None, lambda: eag_a[s]),
                        comm.Pending(None, lambda: eag_b[s]))
            return (comm.tile_broadcast(a_tile, g, "col", s, async_op=True),
                    comm.tile_broadcast(b_tile, g, "row", s, async_op=True))

        outs = []
        cur = fetch(0)
        for s in range(q):
            ap, bp = cur[0].wait(), cur[1].wait()
            if overlap and s + 1 < q:
                cur = fetch(s + 1)      # issued before this stage's expand
            outs.append(_expand(ap, bp, sr, prod_cap))
            if not overlap and s + 1 < q:
                cur = fetch(s + 1)      # after this stage's expansion
        return _staged_tail(outs, shape, sr, merge, prod_cap, stage_cap,
                            out_cap, mask, val_pred)

    # rotation (Cannon): skew, then q stages of neighbour rotation
    a_rot = comm.tile_permute(a_tile, g, comm.WORLD, _cannon_perms(q, True))
    b_rot = comm.tile_permute(b_tile, g, comm.WORLD, _cannon_perms(q, False))
    ok0 = torch.ones((), dtype=torch.bool, device=a_tile.device)
    left = _shift_perm(q)

    def rotate(at, bt):
        return (comm.tile_permute(at, g, "col", left, async_op=True),
                comm.tile_permute(bt, g, "row", left, async_op=True))

    if merge == "incremental":
        def step(state, at, bt):
            kacc, vacc, nacc, ok = state
            r, c, v, n, okx = _expand(at, bt, sr, prod_cap)
            if kacc is None:
                kacc, vacc, nacc = kv_empty(shape, out_cap, v.dtype, sr.add,
                                            device=v.device)
            # mask-filter + compact the stage, then O(n) rank-placement
            # merge into the sorted kv accumulator — never re-sorted
            ks, vs, ns, okc = kv_from_products(
                r, c, v, torch.clamp(n, max=prod_cap), shape, sr.add,
                stage_cap, mask=mask)
            kacc, vacc, nacc, okm = kv_merge2(kacc, vacc, nacc, ks, vs, ns,
                                              sr.add, out_cap)
            return (kacc, vacc, nacc, ok & okx & okc & okm), None

        state, _ = _rotate_sweep(q, overlap, rotate, step,
                                 (None, None, None, ok0), a_rot, b_rot)
        kacc, vacc, nacc, ok = state
        c = kv_to_coo(kacc, vacc, nacc, shape, sr.add, out_cap)
        return apply_val_pred(c, val_pred, ident), ok

    if merge == "sort":
        # seed path: collect q padded product buffers, concat, sort once
        def step(ok, at, bt):
            r, c, v, n, okx = _expand(at, bt, sr, prod_cap)
            if mask is not None:
                r, c, v = filter_products(r, c, v, shape, mask, ident)
            return ok & okx, (r, c, v)

        ok, ys = _rotate_sweep(q, overlap, rotate, step, ok0, a_rot, b_rot)
        rows = torch.cat([y[0] for y in ys])
        cols = torch.cat([y[1] for y in ys])
        vals = torch.cat([y[2] for y in ys])
        cm, ok2 = _merge_products(rows, cols, vals, rows.shape[0], shape, sr,
                                  out_cap, val_pred=val_pred)
        return cm, ok & ok2

    # deferred (merge tree): mask-filter + compact each stage, then fold the
    # q sorted kv streams pairwise — no concat-and-sort
    def step(ok, at, bt):
        r, c, v, n, okx = _expand(at, bt, sr, prod_cap)
        ks, vs, ns, okc = kv_from_products(
            r, c, v, torch.clamp(n, max=prod_cap), shape, sr.add, stage_cap,
            mask=mask)
        return ok & okx & okc, (ks, vs, ns)

    ok, items = _rotate_sweep(q, overlap, rotate, step, ok0, a_rot, b_rot)
    k, vv, nn, okm = kv_tree(items, sr.add, out_cap)
    cm = kv_to_coo(k, vv, nn, shape, sr.add, out_cap)
    return apply_val_pred(cm, val_pred, ident), ok & okm


@_obs.timed("spgemm2d")
def spgemm_2d(a: DistSpMat, b: DistSpMat, sr: Semiring = ARITHMETIC, *,
              mesh: Grid, prod_cap: int, out_cap: int,
              variant: str = "rotation", merge: str = "deferred",
              mask: MaskSpec | None = None, schedule=None,
              overlap: bool = True, compress: str | None = None):
    """C = A ⊕.⊗ B (optionally C⟨M⟩). Returns (DistSpMat, ok[pr,pc]).

    ``schedule`` overrides the variant-derived exchange schedule: 'rotate',
    'alltoall', 'bcast', or a length-q tuple of 'bcast'|'gather' (§4.8).
    ``overlap`` toggles double-buffered (default) vs bulk-synchronous stage
    loops; results are bitwise equal either way. ``compress='int8'`` (wire
    compression) waits for a later slice and raises. ``ok`` is this rank's
    flag, shaped (1, 1).

    ``mask.mat`` must be tile-aligned with C (same grid, C's shape): the
    mask never communicates, and each rank prunes its expanded products
    against its own mask tile before any merge stage (§4.7).
    """
    if a.grid != b.grid or a.pr != a.pc:
        raise ValueError("2D SpGEMM needs a square grid shared by A and B")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    if compress is not None:
        raise NotImplementedError(
            "compressed exchange (dist/compression.py) is not ported yet")
    q = a.pr
    sched = _schedule_from(variant, schedule, q)
    mm = mask.mat if mask is not None else None
    val_pred = mask.val_pred if mask is not None else None
    if mm is not None and (mm.grid != a.grid
                           or mm.shape != (a.shape[0], b.shape[1])):
        raise ValueError("mask must be tile-aligned with C")
    lm = mask.local(mm.tile()) if mm is not None else None
    with _obs.span("spgemm2d.execute", q=q, variant=variant, merge=merge,
                   schedule=sched if isinstance(sched, str) else "hybrid",
                   overlap=overlap):
        c, ok = _local_spgemm_2d(a.tile(), b.tile(), sr, q, prod_cap,
                                 out_cap, sched, merge, comm.of(a.grid),
                                 overlap=overlap, mask=lm,
                                 val_pred=val_pred)
        _obs.sync(c.row.device)
    # every merge path ends in dedup(order='row'), so C keeps the invariant
    cmat = DistSpMat.from_tile(c, (a.shape[0], b.shape[1]), a.grid)
    return cmat, ok.reshape(1, 1)
