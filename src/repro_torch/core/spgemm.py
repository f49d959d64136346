"""Distributed SpGEMM: 2D SUMMA (paper §3.2), on the 1x1 grid.

On a q×q grid the 2D algorithm runs q stages, each a local O(flops)
expansion of one A tile and one B tile, and merges the q stage buffers. The
exchange schedule only decides how a stage's tiles reach a device:

  - schedule='rotate'   (variant='rotation'): Cannon's systolic rotation;
  - schedule='alltoall' (variant='allgather'): every stage's operands
                        gathered in one shot;
  - schedule='bcast' or a per-stage tuple (variant='hybrid').

This slice runs q = 1: one stage, whose operands are the local tiles, and
no exchange at all; the collectives come with the ``torch.distributed``
slice. What q = 1 keeps is the merge, whose mode the planner picks:

  merge='deferred'    compact each stage (kv_from_products) and fold the
                      compacted streams pairwise (kv_tree);
  merge='incremental' compact each stage and rank-merge it into a sorted
                      kv accumulator (kv_merge2);
  merge='sort'        the seed behavior — concatenate the padded stage
                      buffers and dedup once.

Under the rotate schedule the three modes run distinct code; under the
others 'deferred' and 'incremental' share the stage-merge tree
(``_staged_tail``), as in the JAX package.
"""
from __future__ import annotations

import torch

from ..obs import recorder as _obs
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


def _local_spgemm_2d(a_tile: COO, b_tile: COO, sr, q, prod_cap, out_cap,
                     schedule, merge, mask: LocalMask | None = None,
                     val_pred=None):
    """The per-device body of the 2D algorithm, for q = 1.

    The engine paths ('deferred'/'incremental') compact each stage to
    stage_cap = min(prod_cap, out_cap) — sound because a stage's distinct
    count is bounded by the final nnz(C), and checked pre-clamp by the ok
    flags — then rank-merge the compacted streams, decoding rows/cols once.
    ``mask`` prunes the stage's expanded products against the local mask
    tile BEFORE any merge stage (§4.7); ``val_pred`` drops merged entries by
    output value in the final compaction.
    """
    if q != 1:
        raise NotImplementedError(
            "q > 1 needs the torch.distributed slice of the port (ROADMAP.md)")
    if merge not in MERGES:
        raise ValueError(f"unknown merge {merge!r}")
    shape = (a_tile.shape[0], b_tile.shape[1])
    stage_cap = min(prod_cap, out_cap)
    ident = sr.add.identity
    if key_dtype(shape) is None:
        merge = "sort"        # unpackable tile: the engine needs packed keys

    # the one stage multiplies the local tiles: no exchange at q = 1
    if schedule != "rotate":
        outs = [_expand(a_tile, b_tile, sr, prod_cap)]
        return _staged_tail(outs, shape, sr, merge, prod_cap, stage_cap,
                            out_cap, mask, val_pred)

    r, c, v, n, ok = _expand(a_tile, b_tile, sr, prod_cap)
    if merge == "incremental":
        kacc, vacc, nacc = kv_empty(shape, out_cap, v.dtype, sr.add,
                                    device=v.device)
        # mask-filter + compact the stage, then O(n) rank-placement merge
        # into the sorted kv accumulator — never re-sorted
        ks, vs, ns, okc = kv_from_products(
            r, c, v, torch.clamp(n, max=prod_cap), shape, sr.add, stage_cap,
            mask=mask)
        kacc, vacc, nacc, okm = kv_merge2(kacc, vacc, nacc, ks, vs, ns,
                                          sr.add, out_cap)
        c = kv_to_coo(kacc, vacc, nacc, shape, sr.add, out_cap)
        return apply_val_pred(c, val_pred, ident), ok & okc & okm

    if merge == "sort":
        # seed path: the padded product buffer, sorted once
        if mask is not None:
            r, c, v = filter_products(r, c, v, shape, mask, ident)
        cm, ok2 = _merge_products(r, c, v, r.shape[0], shape, sr, out_cap,
                                  val_pred=val_pred)
        return cm, ok & ok2

    # deferred (merge tree): mask-filter + compact the stage, then fold the
    # sorted kv streams pairwise — no concat-and-sort
    ks, vs, ns, okc = kv_from_products(
        r, c, v, torch.clamp(n, max=prod_cap), shape, sr.add, stage_cap,
        mask=mask)
    k, vv, nn, okm = kv_tree([(ks, vs, ns)], sr.add, out_cap)
    cm = kv_to_coo(k, vv, nn, shape, sr.add, out_cap)
    return apply_val_pred(cm, val_pred, ident), ok & okc & okm


@_obs.timed("spgemm2d")
def spgemm_2d(a: DistSpMat, b: DistSpMat, sr: Semiring = ARITHMETIC, *,
              mesh: Grid, prod_cap: int, out_cap: int,
              variant: str = "rotation", merge: str = "deferred",
              mask: MaskSpec | None = None, schedule=None,
              overlap: bool = True, compress: str | None = None):
    """C = A ⊕.⊗ B (optionally C⟨M⟩). Returns (DistSpMat, ok[pr,pc]).

    ``schedule`` overrides the variant-derived exchange schedule. With one
    stage there is nothing to overlap, so ``overlap`` changes nothing here.
    ``compress='int8'`` (wire compression) waits for the distributed slice.

    ``mask.mat`` must be tile-aligned with C (same grid, C's shape): the
    mask never communicates, and each device prunes its expanded products
    against its own mask tile before any merge stage (§4.7).
    """
    del overlap
    if a.grid != b.grid or a.pr != a.pc:
        raise ValueError("2D SpGEMM needs a square grid shared by A and B")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    if compress is not None:
        raise NotImplementedError(
            "compressed exchange waits for the torch.distributed slice")
    q = a.pr
    sched = _schedule_from(variant, schedule, q)
    mm = mask.mat if mask is not None else None
    val_pred = mask.val_pred if mask is not None else None
    if mm is not None and (mm.grid != a.grid
                           or mm.shape != (a.shape[0], b.shape[1])):
        raise ValueError("mask must be tile-aligned with C")
    lm = mask.local(mm.tile()) if mm is not None else None
    with _obs.span("spgemm2d.execute", q=q, variant=variant, merge=merge,
                   schedule=sched if isinstance(sched, str) else "hybrid"):
        c, ok = _local_spgemm_2d(a.tile(), b.tile(), sr, q, prod_cap,
                                 out_cap, sched, merge, mask=lm,
                                 val_pred=val_pred)
        _obs.sync(c.row.device)
    # every merge path ends in dedup(order='row'), so C keeps the invariant
    cmat = DistSpMat.from_tile(c, (a.shape[0], b.shape[1]), a.grid)
    return cmat, ok.reshape(1, 1)
