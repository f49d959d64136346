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
(``_staged_tail``), as in the JAX package.

Compressed exchanges (compress='int8'): value payloads are quantized to
per-tile symmetric int8 once, at the wire boundary
(``dist/compression.py``), and travel the wire compressed; the tile's
scale rides in the same packed exchange as its fields, under every
schedule. Each stage dequantizes after the exchange, just before
expansion. Error feedback across ``spgemm_2d_batched`` batches re-injects
the quantization residual of A (re-sent every batch) so the error does not
accumulate. Requires floating values and an additive identity of 0
(padding must survive the round trip).

3D CA (paper Fig 2): inputs on an (L, q, q) grid, A column-sliced and B
row-sliced across layers. Each layer runs an independent 2D multiply over a
contraction dim shrunk by L on its own 'row'/'col' groups, then one
inter-layer all-to-all scatters partial C column sub-blocks and a local
semiring merge forms C distributed like A's rows and C's column
sub-blocks ('csub'). With overlap=True the three field exchanges are
fused into one all-to-all; overlap=False exchanges per field after the
placement completes.

Batched SpGEMM (paper §7.2): ``spgemm_2d_batched`` forms C in column
batches of B, HipMCL-style, so the full C never needs to exist at once.
"""
from __future__ import annotations

from functools import lru_cache

import torch

import dataclasses

from ..dist.compression import dequantize_payload, quantize_payload
from ..obs import recorder as _obs
from ..robust import audit as _audit
from . import comm
from .coo import COO, SENTINEL
from .dist import DistSpMat, DistSpMat3D, Grid
from .local_spgemm import _expand
from .mask import LocalMask, MaskSpec, apply_val_pred, filter_products
from .merge import (key_dtype, kv_empty, kv_from_products, kv_merge2,
                    kv_to_coo, kv_tree, merge_stage_products, pack_keys)
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


def _deq(tile: COO, scale) -> COO:
    """Dequantize an int8-compressed tile (identity when scale is None)."""
    if scale is None:
        return tile
    return COO(tile.row, tile.col, dequantize_payload(tile.val, scale),
               tile.nnz, tile.shape, tile.order)


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
    are bitwise equal. ``at``/``bt`` are wire payloads (``rotate`` moves
    them compressed); ``step(state, at, bt) -> (state, y)`` consumes the
    dequantized tiles. Returns the final state and the stages' ``y``.
    """
    ys = []
    for s in range(q):
        last = s == q - 1
        nxt = rotate(at, bt) if overlap and not last else None
        state, y = step(state, _deq(*at), _deq(*bt))
        ys.append(y)
        if not last:
            if nxt is None:
                nxt = rotate(at, bt)
            at, bt = nxt[0].wait(), nxt[1].wait()
    return state, ys


def _local_spgemm_2d(a_tile: COO, b_tile: COO, sr, q, prod_cap, out_cap,
                     schedule, merge, g, overlap=True,
                     mask: LocalMask | None = None, val_pred=None,
                     a_scale=None, b_scale=None):
    """The per-rank body of the 2D algorithm (the JAX package's
    ``shard_map`` body), ``g`` this rank's ``comm.GridComm``: its 'row' and
    'col' groups and its plane lie within this rank's layer.

    The engine paths ('deferred'/'incremental') compact each stage to
    stage_cap = min(prod_cap, out_cap) — sound because a stage's distinct
    count is bounded by the final nnz(C), and checked pre-clamp by the ok
    flags — then rank-merge the compacted streams, decoding rows/cols once.
    ``mask`` prunes every stage's expanded products against the local mask
    tile BEFORE any merge stage (§4.7); ``val_pred`` drops merged entries by
    output value in the final compaction.

    ``a_scale``/``b_scale`` are the per-tile int8 dequantization scales
    (0-d tensors) when the value payloads are compressed; tiles dequantize
    just before expansion, AFTER every exchange, so the wire stays int8.
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
        ar = comm.tile_all_gather(a_tile, g, "col", scale=a_scale)
        bc = comm.tile_all_gather(b_tile, g, "row", scale=b_scale)
        outs = [_expand(_deq(*ar[s]), _deq(*bc[s]), sr, prod_cap)
                for s in range(q)]
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
            eag_a = [(comm.as_psum(t, g, "col"), sc) for t, sc in
                     comm.tile_all_gather(a_tile, g, "col", scale=a_scale)]
            eag_b = [(comm.as_psum(t, g, "row"), sc) for t, sc in
                     comm.tile_all_gather(b_tile, g, "row", scale=b_scale)]

        def fetch(s):
            if s in gs:
                return (comm.Pending(None, lambda: eag_a[s]),
                        comm.Pending(None, lambda: eag_b[s]))
            return (comm.tile_broadcast(a_tile, g, "col", s, scale=a_scale,
                                        async_op=True),
                    comm.tile_broadcast(b_tile, g, "row", s, scale=b_scale,
                                        async_op=True))

        outs = []
        cur = fetch(0)
        for s in range(q):
            ap, bp = cur[0].wait(), cur[1].wait()
            if overlap and s + 1 < q:
                cur = fetch(s + 1)      # issued before this stage's expand
            outs.append(_expand(_deq(*ap), _deq(*bp), sr, prod_cap))
            if not overlap and s + 1 < q:
                cur = fetch(s + 1)      # after this stage's expansion
        return _staged_tail(outs, shape, sr, merge, prod_cap, stage_cap,
                            out_cap, mask, val_pred)

    # rotation (Cannon): skew within the layer's plane, then q stages of
    # neighbour rotation
    a_rot = comm.tile_permute(a_tile, g, comm.PLANE, _cannon_perms(q, True),
                              scale=a_scale)
    b_rot = comm.tile_permute(b_tile, g, comm.PLANE, _cannon_perms(q, False),
                              scale=b_scale)
    ok0 = torch.ones((), dtype=torch.bool, device=a_tile.device)
    left = _shift_perm(q)

    def rotate(at, bt):
        return (comm.tile_permute(at[0], g, "col", left, scale=at[1],
                                  async_op=True),
                comm.tile_permute(bt[0], g, "row", left, scale=bt[1],
                                  async_op=True))

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


def _compress_operand(mat: DistSpMat, resid=None):
    """Quantize a DistSpMat's value payload to int8 at the wire boundary.

    Returns the matrix with int8 values (the wire payload, guarded by the
    ``dist.compressed_exchange`` audit/fault site), this rank's per-tile
    scale (shape (1, 1), the value dtype) and ``new_resid``, the
    quantization error for error feedback (exactly val+resid −
    dequantized). While recording, counters ``dist.compress.bytes_in`` and
    ``dist.compress.bytes_out`` add this rank's value-payload bytes before
    and after quantization (the int8 wire adds one scale a tile).
    """
    q8, scale, new_resid = quantize_payload(mat.val, mat.nnz, resid)
    if _obs.enabled():
        live = int(mat.nnz.sum())
        _obs.counter_add("dist.compress.bytes_in",
                         live * mat.val.element_size())
        _obs.counter_add("dist.compress.bytes_out",
                         live * q8.element_size()
                         + scale.numel() * scale.element_size())
    mat = dataclasses.replace(mat, val=q8)
    mat = _audit.guard_exchange("dist.compressed_exchange", mat)
    return mat, scale, new_resid


@_obs.timed("spgemm2d")
def spgemm_2d(a: DistSpMat, b: DistSpMat, sr: Semiring = ARITHMETIC, *,
              mesh: Grid, prod_cap: int, out_cap: int,
              variant: str = "rotation", merge: str = "deferred",
              mask: MaskSpec | None = None, schedule=None,
              overlap: bool = True, compress: str | None = None,
              ef_resid=None):
    """C = A ⊕.⊗ B (optionally C⟨M⟩). Returns (DistSpMat, ok[pr,pc]).

    ``schedule`` overrides the variant-derived exchange schedule: 'rotate',
    'alltoall', 'bcast', or a length-q tuple of 'bcast'|'gather' (§4.8).
    ``overlap`` toggles double-buffered (default) vs bulk-synchronous stage
    loops; results are bitwise equal either way. ``compress='int8'``
    quantizes the value payloads for the wire (floating values with an
    additive identity of 0 only); passing ``ef_resid`` (a residual shaped
    like ``a.val``, start with zeros) enables error feedback for A and
    makes the return a 3-tuple (C, ok, new_resid). ``ok`` is this rank's
    flag, shaped (1, 1).

    ``mask.mat`` must be tile-aligned with C (same grid, C's shape): the
    mask never communicates, and each rank prunes its expanded products
    against its own mask tile before any merge stage (§4.7).
    """
    if a.grid != b.grid or a.pr != a.pc:
        raise ValueError("2D SpGEMM needs a square grid shared by A and B")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    q = a.pr
    sched = _schedule_from(variant, schedule, q)
    # operands are about to enter the exchange collectives: this is the
    # wire boundary the audit checksums bracket (and the fault sites
    # corrupt) — see robust/audit.guard_exchange
    a = _audit.guard_exchange("spgemm2d.comm_a", a)
    b = _audit.guard_exchange("spgemm2d.comm_b", b)
    a_scale = b_scale = new_resid = None
    if ef_resid is not None and compress is None:
        raise ValueError("ef_resid is only meaningful with compress='int8'")
    if compress is not None:
        if compress != "int8":
            raise ValueError(f"unknown compress mode {compress!r}")
        if not (a.val.dtype.is_floating_point
                and b.val.dtype.is_floating_point):
            raise ValueError("compressed exchange needs floating values")
        if sr.add.identity != 0.0:
            raise ValueError(
                "compressed exchange needs an additive identity of 0 "
                "(padding must survive the int8 round trip)")
        with _obs.span("spgemm2d.compress"):
            a, a_scale, new_resid = _compress_operand(a, ef_resid)
            b, b_scale, _ = _compress_operand(b)
    mm = mask.mat if mask is not None else None
    val_pred = mask.val_pred if mask is not None else None
    if mask is not None and (mask.mat3 is not None or mask.vec is not None):
        raise ValueError("spgemm_2d takes a 2D mask operand (MaskSpec.mat)")
    if mm is not None and (mm.grid != a.grid
                           or mm.shape != (a.shape[0], b.shape[1])):
        raise ValueError("mask must be tile-aligned with C")
    lm = mask.local(mm.tile()) if mm is not None else None
    with _obs.span("spgemm2d.execute", q=q, variant=variant, merge=merge,
                   schedule=sched if isinstance(sched, str) else "hybrid",
                   overlap=overlap, compress=compress or "none"):
        c, ok = _local_spgemm_2d(
            a.tile(), b.tile(), sr, q, prod_cap, out_cap, sched, merge,
            comm.of(a.grid), overlap=overlap, mask=lm, val_pred=val_pred,
            a_scale=None if a_scale is None else a_scale.reshape(()),
            b_scale=None if b_scale is None else b_scale.reshape(()))
        _obs.sync(c.row.device)
    # every merge path ends in dedup(order='row'), so C keeps the invariant
    cmat = DistSpMat.from_tile(c, (a.shape[0], b.shape[1]), a.grid)
    _audit.audit_obj(cmat, "spgemm2d.out", min_level=_audit.FULL)
    if ef_resid is not None:
        return cmat, ok.reshape(1, 1), new_resid
    return cmat, ok.reshape(1, 1)


def _layer_mask(m3: DistSpMat3D, mask: MaskSpec, g, L, kbl, shape):
    """The full C-tile LocalMask of this rank's (i, j) from the L 'csub'
    sub-pieces of the layer axis: sub-piece l covers tile columns
    [l·kbl, (l+1)·kbl). Gathered along 'layer' (nnz(M)-sized), packed and
    sorted, so each layer prunes its products before they travel."""
    mt = m3.tile()
    parts = comm.all_gather_fields((mt.row, mt.col, mt.val), g, "layer")
    mrow = torch.stack([p[0] for p in parts])
    mcol = torch.stack([p[1] for p in parts])
    mval = torch.stack([p[2] for p in parts]).reshape(-1)
    off = torch.arange(L, dtype=torch.int32, device=mcol.device)[:, None]
    fcol = torch.where(mcol != SENTINEL, mcol + off * kbl, SENTINEL)
    keys = pack_keys(mrow.reshape(-1), fcol.reshape(-1), shape, "row")
    allow = None
    if mask.pred is not None:
        allow = torch.as_tensor(mask.pred(mval)).reshape(-1) \
            & (mrow.reshape(-1) != SENTINEL)
        keys, perm = torch.sort(keys, stable=True)
        allow = allow[perm]
    else:
        keys = torch.sort(keys).values
    return LocalMask(keys, allow, mask.complement, "row")


def _layer_exchange(c_part: COO, L, kbl, g, overlap, identity):
    """The inter-layer all-to-all (Fig 2, right): radix-place each entry of
    this layer's partial C at ``dest·cap_l + rank_within_dest``, ``dest``
    its column sub-block, and send piece t to layer t. Returns the
    received (row, col, val) buffers (L pieces of cap_l, piece s from
    layer s) and whether every piece fit its cap_l slots (read from the
    counts before the clamp)."""
    cap = c_part.cap
    cap_l = cap // L
    dev = c_part.row.device
    dest = torch.where(c_part.mask(), torch.div(c_part.col, kbl,
                                                rounding_mode="floor"),
                       torch.tensor(L, dtype=c_part.col.dtype, device=dev))
    order = torch.argsort(dest, stable=True)
    d_sorted = dest[order]
    seg_start = torch.searchsorted(
        d_sorted, torch.arange(L + 1, dtype=d_sorted.dtype, device=dev),
        side="left").to(torch.int32)
    counts = seg_start[1:] - seg_start[:-1]
    fits = (counts <= cap_l).all()
    within = torch.arange(cap, dtype=torch.int32, device=dev) \
        - seg_start[d_sorted.clamp(0, L - 1).long()]
    keep = (d_sorted < L) & (within < cap_l)
    # dropped entries land in a spare slot past the end, never a live one
    slot = torch.where(keep, d_sorted * cap_l + within, L * cap_l).long()
    bufs = []
    for x, fill in ((c_part.row, SENTINEL), (c_part.col, SENTINEL),
                    (c_part.val, identity)):
        buf = torch.full((L * cap_l + 1,), fill, dtype=x.dtype, device=dev)
        buf[slot] = x[order]
        bufs.append(buf[:L * cap_l].reshape(L, cap_l))
    if overlap:
        # one exchange of the three fields, issued as soon as the placement
        # finishes
        bufs = comm.all_to_all_fields(bufs, g, "layer")
    else:
        # bulk-synchronous reference: three per-field exchanges after the
        # placement completes; the same bytes, the same result
        bufs = [comm.all_to_all(x, g, "layer") for x in bufs]
    return [x.reshape(L * cap_l) for x in bufs], fits


@_obs.timed("spgemm3d")
def spgemm_3d(a3: DistSpMat3D, b3: DistSpMat3D, sr: Semiring = ARITHMETIC, *,
              mesh: Grid, prod_cap: int, out_cap: int,
              merge: str = "deferred", variant: str = "rotation",
              mask: MaskSpec | None = None, schedule=None,
              overlap: bool = True):
    """Communication-avoiding SpGEMM on an (L, q, q) grid (paper Fig 2).

    Returns (C3 [dist='csub'], ok) with ``ok`` this rank's flag, shaped
    (1, 1, 1). ``schedule``/``overlap`` select the per-layer 2D exchange
    schedule and double-buffering exactly as in :func:`spgemm_2d`;
    ``overlap`` also fuses the inter-layer all-to-all into one exchange
    (overlap=False exchanges the three fields separately after the radix
    placement — the bulk-synchronous reference; both move identical bytes,
    results are bitwise equal).

    ``mask.mat3`` must be C-distributed ('csub', same grid). Each layer
    all-gathers the mask's L column sub-pieces of its C tile along the
    (cheap, nnz(M)-sized) 'layer' axis, so the per-layer 2D multiply prunes
    expanded products before any merge stage AND before the inter-layer
    all-to-all — masked entries never travel. ``mask.val_pred`` applies
    only after the inter-layer merge (layer partials are incomplete sums).
    """
    if a3.dist != "acol" or b3.dist != "brow":
        raise ValueError("spgemm_3d takes A as dist='acol' and B as "
                         f"dist='brow', got {a3.dist!r} and {b3.dist!r}")
    if a3.grid != b3.grid:
        raise ValueError(f"A and B lie on different grids: {a3.grid} and "
                         f"{b3.grid}")
    # no planner retry wraps this multiply: a fault caught here raises
    a3 = _audit.guard_exchange("spgemm3d.comm_a", a3)
    b3 = _audit.guard_exchange("spgemm3d.comm_b", b3)
    L, q = a3.L, a3.q
    sched = _schedule_from(variant, schedule, q)
    tr_a, tc_a = a3.block_sizes()
    tr_b, tc_b = b3.block_sizes()
    if tc_a != tr_b:
        raise ValueError(f"inner dimensions differ: {a3.shape} @ {b3.shape}")
    kbl = tc_b // L          # C column sub-block width after layer split
    c_shape = (a3.shape[0], b3.shape[1])
    m3 = mask.mat3 if mask is not None else None
    val_pred = mask.val_pred if mask is not None else None
    ident = sr.add.identity
    if mask is not None and (mask.mat is not None or mask.vec is not None):
        raise ValueError("spgemm_3d takes a 3D mask operand (MaskSpec.mat3)")
    if m3 is not None:
        if not (m3.dist == "csub" and m3.grid == a3.grid
                and m3.shape == c_shape):
            raise ValueError("mask must be C-distributed (csub)")
        if key_dtype((tr_a, tc_b)) is None:
            raise ValueError("masked 3D SpGEMM needs a packable C tile")
    g = comm.of(a3.grid)
    with _obs.span("spgemm3d.execute", L=L, q=q, variant=variant,
                   merge=merge, overlap=overlap):
        lm = None if m3 is None else _layer_mask(m3, mask, g, L, kbl,
                                                 (tr_a, tc_b))
        # per-layer 2D multiply ('row'/'col' exchanges are layer-local)
        c_part, ok = _local_spgemm_2d(a3.tile(), b3.tile(), sr, q, prod_cap,
                                      prod_cap, sched, merge, g,
                                      overlap=overlap, mask=lm)
        (buf_r, buf_c, buf_v), fits = _layer_exchange(c_part, L, kbl, g,
                                                      overlap, ident)
        ok = ok & fits
        # localize columns to my sub-block and merge
        valid = buf_r != SENTINEL
        lc = torch.where(valid, buf_c - g.l * kbl, SENTINEL)
        lr = torch.where(valid, buf_r, SENTINEL)
        shape = (tr_a, kbl)
        if merge == "sort" or key_dtype(shape) is None:
            # seed path: one dedup over the whole exchanged buffer
            d = COO(lr, lc, buf_v, valid.sum().to(torch.int32), shape,
                    "none").dedup(sr.add)
            d = apply_val_pred(d, val_pred, ident)
            ok = ok & (d.nnz <= out_cap)         # pre-clamp nnz
            merged = d.with_cap(out_cap, ident)
        else:
            # merge engine (§4.4): each received piece is a stable-compacted
            # slice of a row-sorted dedup output, so the L pieces are sorted
            # unique-key streams — fold them pairwise, never re-sort
            cap_l = buf_r.shape[0] // L
            items = []
            for t in range(L):
                sl = slice(t * cap_l, (t + 1) * cap_l)
                items.append((pack_keys(lr[sl], lc[sl], shape, "row"),
                              buf_v[sl], valid[sl].sum().to(torch.int32)))
            k, v, nn, okm = kv_tree(items, sr.add, out_cap)
            merged = kv_to_coo(k, v, nn, shape, sr.add, out_cap)
            merged = apply_val_pred(merged, val_pred, ident)
            ok = ok & okm
        _obs.sync(merged.row.device)
    # the final inter-layer merge is a row dedup
    c3 = DistSpMat3D.from_tile(merged, c_shape, a3.grid, "csub")
    _audit.audit_obj(c3, "spgemm3d.out", min_level=_audit.FULL)
    return c3, ok.reshape(1, 1, 1)


def spgemm_2d_batched(a: DistSpMat, b: DistSpMat, sr: Semiring = ARITHMETIC,
                      *, mesh: Grid, prod_cap: int, out_cap: int,
                      nbatch: int, variant: str = "rotation",
                      mask: MaskSpec | None = None, schedule=None,
                      overlap: bool = True, compress: str | None = None):
    """Batched SpGEMM (paper §7.2): form C in ``nbatch`` column batches.

    Each batch multiplies A by the column-slab restriction of B's tiles
    (``slab = ceil(nb / nbatch)`` tile columns), yielding a DistSpMat for
    that slab; the caller consumes batches one at a time (HipMCL-style) so
    the full C never needs to exist in memory. Returns a list of
    (C_batch, ok) with C_batch's shape = full C shape (entries only in the
    slab).

    With ``compress='int8'`` the quantization residual of A (re-sent every
    batch) is carried across batches as error feedback, so A's wire error
    does not accumulate over the batch loop.
    """
    slab = -(-b.nb // nbatch)
    resid = torch.zeros_like(a.val) if compress is not None else None
    outs = []
    for t in range(nbatch):
        with _obs.span("spgemm2d.batch", batch=t, nbatch=nbatch):
            bt = _restrict_cols(b, t * slab, slab)
            kw = dict(mesh=mesh, prod_cap=prod_cap, out_cap=out_cap,
                      variant=variant, mask=mask, schedule=schedule,
                      overlap=overlap)
            if compress is not None:
                c, ok, resid = spgemm_2d(a, bt, sr, compress=compress,
                                         ef_resid=resid, **kw)
            else:
                c, ok = spgemm_2d(a, bt, sr, **kw)
            outs.append((c, ok))
    return outs


def _restrict_cols(b: DistSpMat, lo: int, width: int) -> DistSpMat:
    """Keep only the entries in tile-local columns [lo, lo+width): a stable
    kept-first compaction of each tile, so its entry order and the order
    tag survive."""
    keep = (b.col >= lo) & (b.col < lo + width) & (b.col != SENTINEL)
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    sent = torch.tensor(SENTINEL, dtype=b.row.dtype, device=b.row.device)
    row = torch.take_along_dim(torch.where(keep, b.row, sent), order, -1)
    col = torch.take_along_dim(torch.where(keep, b.col, sent), order, -1)
    val = torch.take_along_dim(
        torch.where(keep, b.val, torch.zeros((), dtype=b.val.dtype,
                                             device=b.val.device)), order, -1)
    nnz = keep.sum(-1).to(torch.int32)
    return DistSpMat(row, col, val, nnz, b.shape, b.grid, order=b.order)
