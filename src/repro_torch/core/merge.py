"""Sort-free merge engine (CombBLAS 2.0 §5 multiway merge, DESIGN.md §4.4).

Every SpGEMM path ends in a merge of (row, col, val) streams. Four graded
primitives, as in ``repro.core.merge``:

  1. **Packed-key dedup** (``dedup``): encode (row, col) into ONE integer
     key — int32 when the tile fits the 32-bit key space, int64 above it —
     then a single key sort + one gather of the values; the unique
     (row, col) pairs decode straight from the merged keys.
  2. **Sorted fast path** (``dedup_sorted``): inputs carrying an order tag
     skip the sort — run-boundary detection + segmented reduction only.
  3. **Merge path** (``merge_sorted`` / ``merge_tree``): two sorted tiles
     interleave in O(n) by rank placement (two binary searches and two
     scatters, never a sort); ``merge_tree`` folds stage buffers pairwise.
  4. **kv stage pipeline** (``kv_from_products`` / ``kv_merge2`` /
     ``kv_tree``): SpGEMM stage buffers travel as (packed keys, values,
     count) and merge by the same rank placement; rows/cols decode once at
     the end.

The seed two-key implementation survives as ``sort_two_key`` /
``dedup_legacy``: the path for tiles whose keys cannot pack.
"""
from __future__ import annotations

import torch

from ..obs import recorder as _obs
from ..robust import faults as _faults
from .coo import COO, SENTINEL, _vmask, resolve_device, sentinel_like
from .semiring import Monoid, segment_reduce

# Degradation switch (robust/recover.py 'legacy-dedup' rung): when set, the
# packed-key engine's entry points route to the seed two-key implementations.
_FORCE_LEGACY = False


def force_legacy_dedup(on: bool):
    """Route ``dedup``/``sort_packed`` to the seed two-key paths."""
    global _FORCE_LEGACY
    _FORCE_LEGACY = bool(on)


def legacy_dedup_forced() -> bool:
    return _FORCE_LEGACY


# Cap on the per-stage compaction windows kv_from_products splits a product
# buffer into (the JAX package bounds its program size with it; here it
# fixes the same window sizes, so both packages reduce the same windows).
MAX_WINDOWS = 8


def _kmax(dtype) -> int:
    return torch.iinfo(dtype).max


# --------------------------------------------------------------------------
# key packing
# --------------------------------------------------------------------------

def key_dtype(shape) -> torch.dtype | None:
    """Narrowest integer dtype that can pack (row, col) for ``shape``.

    int32 while (m+1)·(n+1) fits 31 bits (so the max live key stays below
    the all-ones padding key), int64 while it fits 63; None beyond that
    (callers fall back to the two-key sort).
    """
    m, n = shape
    if (m + 1) * (n + 1) < 2**31:
        return torch.int32
    if (m + 1) * (n + 1) < 2**63:
        return torch.int64
    return None


def pack_keys(row: torch.Tensor, col: torch.Tensor, shape,
              order: str = "row"):
    """(row, col) -> single sortable key; SENTINEL coords -> dtype max.

    'row' keys sort row-major, 'col' keys col-major. Returns None when the
    tile exceeds the packable key space.
    """
    kd = key_dtype(shape)
    if kd is None:
        return None
    m, n = shape
    live = (row != SENTINEL) & (col != SENTINEL)
    if order == "row":
        k = row.to(kd) * (n + 1) + col.to(kd)
    else:
        k = col.to(kd) * (m + 1) + row.to(kd)
    return torch.where(live, k, torch.tensor(_kmax(kd), dtype=kd,
                                             device=row.device))


def _unpack(keys: torch.Tensor, shape, order: str):
    """Inverse of pack_keys for live keys (padding handled by callers)."""
    m, n = shape
    base = (n + 1) if order == "row" else (m + 1)
    hi = torch.div(keys, base, rounding_mode="floor").to(torch.int32)
    lo = torch.remainder(keys, base).to(torch.int32)
    return (hi, lo) if order == "row" else (lo, hi)


# --------------------------------------------------------------------------
# legacy two-key sort/dedup (seed implementation: fallback)
# --------------------------------------------------------------------------

def sort_two_key(c: COO, order: str = "row") -> COO:
    """Seed COO.sort: stable two-key sort carrying every value column."""
    if c.order == order:
        return c
    k1, k2 = (c.row, c.col) if order == "row" else (c.col, c.row)
    perm = torch.argsort(k2, stable=True)
    perm = perm[torch.argsort(k1[perm], stable=True)]
    return COO(c.row[perm], c.col[perm], c.val[perm], c.nnz, c.shape, order)


def dedup_legacy(c: COO, add: Monoid, order: str = "row") -> COO:
    """Seed COO.dedup: two-key sort + two segment reductions."""
    from .semiring import MIN_INT
    s = sort_two_key(c, order)
    k1, k2 = (s.row, s.col) if order == "row" else (s.col, s.row)
    prev1 = torch.cat([k1.new_full((1,), -1), k1[:-1]])
    prev2 = torch.cat([k2.new_full((1,), -1), k2[:-1]])
    live = s.mask() & (s.row != SENTINEL) & (s.col != SENTINEL)
    newgrp = ((k1 != prev1) | (k2 != prev2)) & live
    gid = torch.cumsum(newgrp, 0, dtype=torch.int32) - 1
    ngrp = torch.clamp(torch.where(live, gid, -1).max() + 1, min=0) \
        if c.cap else torch.zeros((), dtype=torch.int32, device=c.device)
    gid = torch.where(live, gid, c.cap)
    vals = segment_reduce(s.val, gid, c.cap, add, sorted_ids=True)
    first_of_grp = segment_reduce(
        torch.arange(c.cap, dtype=torch.int32, device=c.device), gid, c.cap,
        MIN_INT, sorted_ids=True)
    idx = first_of_grp.clamp(0, max(c.cap - 1, 0)).long()
    valid = torch.arange(c.cap, dtype=torch.int32, device=c.device) < ngrp
    sent = sentinel_like(s.row)
    row = torch.where(valid, s.row[idx], sent)
    col = torch.where(valid, s.col[idx], sent)
    val = torch.where(_vmask(valid, c.vdims), vals,
                      torch.tensor(add.identity, dtype=vals.dtype,
                                   device=c.device))
    return COO(row, col, val, ngrp.to(torch.int32), c.shape, order)


# --------------------------------------------------------------------------
# packed-key engine
# --------------------------------------------------------------------------

def _sort_kv(keys: torch.Tensor, vals: torch.Tensor):
    """Sort (key, val) by key: one key sort + one value gather. Unstable is
    sound: dedup consumers combine equal-key runs with a commutative monoid,
    so run-internal order is unobservable."""
    ks, perm = torch.sort(keys)
    return ks, vals[perm]


def _run_bounds(keys: torch.Tensor, nnz):
    """(gid, run-start flags, ngrp) for an ascending key stream with
    dtype-max padding."""
    cap = keys.shape[0]
    live = (torch.arange(cap, dtype=torch.int32, device=keys.device) < nnz) \
        & (keys != _kmax(keys.dtype))
    prev = torch.cat([keys.new_full((1,), -1), keys[:-1]])
    newgrp = (keys != prev) & live
    cs = torch.cumsum(newgrp, 0, dtype=torch.int32)
    gid = torch.where(live, cs - 1, cap)                    # pad -> drop
    return gid, newgrp, cs[-1]                              # ngrp = total runs


def _group_keys(keys: torch.Tensor, gid: torch.Tensor,
                newgrp: torch.Tensor) -> torch.Tensor:
    """Key of group g at slot g, dtype max past the last group: all keys of a
    run are equal, so the run's first slot names it."""
    cap = keys.shape[0]
    out = keys.new_full((cap + 1,), _kmax(keys.dtype))
    out.scatter_(0, torch.where(newgrp, gid, cap).long(), keys)
    return out[:cap]


def _reduce_runs(keys: torch.Tensor, vals: torch.Tensor, nnz, shape,
                 add: Monoid, order: str) -> COO:
    """Fuse equal-key runs of an ascending (key, val) stream into a COO.

    ``keys`` must be sorted with padding (dtype max) at the end; the first
    ``nnz`` slots are the live entries. One boundary scan + one segmented
    reduction; unique (row, col) decode straight from the keys.
    """
    cap = keys.shape[0]
    gid, newgrp, ngrp = _run_bounds(keys, nnz)
    out_vals = segment_reduce(vals, gid, cap, add, sorted_ids=True)
    ukey = _group_keys(keys, gid, newgrp)
    valid = torch.arange(cap, dtype=torch.int32, device=keys.device) < ngrp
    row, col = _unpack(torch.where(valid, ukey, 0), shape, order)
    sent = sentinel_like(row)
    val = torch.where(_vmask(valid, vals.shape[1:]), out_vals,
                      torch.tensor(add.identity, dtype=out_vals.dtype,
                                   device=keys.device))
    return COO(torch.where(valid, row, sent), torch.where(valid, col, sent),
               val, ngrp.to(torch.int32), shape, order)


@_obs.timed("merge.sort")
def sort_packed(c: COO, order: str = "row") -> COO:
    """Packed-key argsort + one gather (COO.sort's engine implementation)."""
    if c.order == order:
        return c
    keys = None if _FORCE_LEGACY else pack_keys(c.row, c.col, c.shape, order)
    if keys is None:
        return sort_two_key(c, order)
    perm = torch.argsort(keys, stable=True)
    return COO(c.row[perm], c.col[perm], c.val[perm], c.nnz, c.shape, order)


@_obs.timed("merge.dedup")
def dedup(c: COO, add: Monoid, order: str = "row") -> COO:
    """Merge duplicate (row, col) entries (COO.dedup's engine implementation).

    Tagged inputs skip the sort (``dedup_sorted``); untagged inputs pay one
    packed-key sort + one value gather.
    """
    keys = None if _FORCE_LEGACY else pack_keys(c.row, c.col, c.shape, order)
    if keys is None:
        return dedup_legacy(c, add, order)
    if c.order == order:
        vals = c.val
    else:
        keys, vals = _sort_kv(keys, c.val)
    return _reduce_runs(keys, vals, c.nnz, c.shape, add, order)


def dedup_sorted(c: COO, add: Monoid) -> COO:
    """Sort-free dedup for tiles carrying an order tag (§4.3 invariant)."""
    if c.order not in ("row", "col"):
        raise ValueError("dedup_sorted needs an order tag; use dedup() for "
                         "untagged tiles")
    return dedup(c, add, c.order)


# --------------------------------------------------------------------------
# merge path (binary merge scheme, paper §5)
# --------------------------------------------------------------------------

def merge_sorted(a: COO, b: COO, add: Monoid, order: str = "row") -> COO:
    """C = A ⊕ B for two tiles of the same shape: O(n), sort-free.

    Rank placement: A[i] lands at ``i + |{kb < ka[i]}|`` and B[j] at
    ``j + |{ka <= kb[j]}|`` (two searchsorteds), a bijection onto
    [0, capA+capB) with A's duplicates before B's, so two scatters build the
    merged sorted stream; equal keys then fuse in the run reduction of
    ``dedup_sorted``. Inputs not carrying the order tag are packed-sorted
    first. Returns an exact-capacity (capA+capB) COO; callers clamp with
    ``with_cap`` after checking ``nnz`` against their budget.
    """
    assert a.shape == b.shape, (a.shape, b.shape)
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if key_dtype(a.shape) is None:        # unpackable tile: legacy concat
        both = COO(torch.cat([a.row, b.row]), torch.cat([a.col, b.col]),
                   torch.cat([a.val.to(out_dtype), b.val.to(out_dtype)]),
                   a.nnz + b.nnz, a.shape, "none")
        return dedup_legacy(both, add, order)
    a = sort_packed(a, order)
    b = sort_packed(b, order)
    ka = pack_keys(a.row, a.col, a.shape, order)
    kb = pack_keys(b.row, b.col, b.shape, order)
    dev = ka.device
    pos_a = torch.arange(a.cap, device=dev) + torch.searchsorted(kb, ka)
    pos_b = torch.arange(b.cap, device=dev) + torch.searchsorted(ka, kb,
                                                                 right=True)
    total = a.cap + b.cap
    keys = ka.new_empty(total)
    keys[pos_a] = ka
    keys[pos_b] = kb
    vals = torch.empty((total,) + a.vdims, dtype=out_dtype, device=dev)
    vals[pos_a] = a.val.to(out_dtype)
    vals[pos_b] = b.val.to(out_dtype)
    return _reduce_runs(keys, vals, a.nnz + b.nnz, a.shape, add, order)


def merge_capped(a: COO, b: COO, add: Monoid, cap: int,
                 order: str = "row"):
    """merge_sorted clamped to ``cap``; ok is the PRE-clamp overflow check."""
    m = merge_sorted(a, b, add, order)
    ok = m.nnz <= cap
    return m.with_cap(cap, add.identity), ok


@_obs.timed("merge.tree")
def merge_tree(tiles, add: Monoid, out_cap: int, order: str = "row"):
    """Pairwise merge of q sorted stage buffers (the SUMMA multiway merge).

    Intermediate capacities grow as min(capL+capR, out_cap): a partial
    merge's distinct count is bounded by the final nnz(C), so clamping
    intermediates to ``out_cap`` is lossless whenever the final result
    fits, and the pre-clamp ``ok`` checks catch the case it doesn't.
    Returns (COO, ok).
    """
    assert len(tiles) >= 1
    tiles = list(tiles)
    ok = torch.ones((), dtype=torch.bool, device=tiles[0].device)
    while len(tiles) > 1:
        nxt = []
        for i in range(0, len(tiles) - 1, 2):
            m = merge_sorted(tiles[i], tiles[i + 1], add, order)
            tgt = min(m.cap, out_cap)
            ok = ok & (m.nnz <= tgt)
            nxt.append(m.with_cap(tgt, add.identity))
        if len(tiles) % 2:
            nxt.append(tiles[-1])
        tiles = nxt
    final = tiles[0]
    ok = ok & (final.nnz <= out_cap)
    return final.with_cap(out_cap, add.identity), ok


# --------------------------------------------------------------------------
# kv-level stage combining (the SpGEMM hot path)
# --------------------------------------------------------------------------

def _kv_dedup_window(keys, vals, nlive, add: Monoid, cap: int):
    """Sort + run-fuse one key/value window; slice to ``cap`` slots.

    The values reduce onto ``min(cap, full_cap)`` segments: groups past
    ``cap`` would be sliced away, so their ids are dropped instead (``ok``
    still reports them)."""
    full_cap = keys.shape[0]
    ks, vs = _sort_kv(keys, vals)
    gid, newgrp, ngrp = _run_bounds(ks, nlive)
    out_v = segment_reduce(vs, gid, min(cap, full_cap), add, sorted_ids=True)
    out_k = _group_keys(ks, gid, newgrp)
    ok = ngrp <= cap
    if cap < full_cap:
        out_k = out_k[:cap]
    return out_k, out_v, torch.clamp(ngrp, max=cap).to(torch.int32), ok


def kv_from_products(rows, cols, vals, nprod, shape, add: Monoid,
                     cap: int, order: str = "row", mask=None):
    """One padded expansion buffer -> compacted sorted unique kv stream.

    The buffer is processed in windows of max(cap, full_cap/MAX_WINDOWS)
    slots. Expansion places live products CONTIGUOUSLY at the front, so
    windows past the live prefix are pure cap slack and are skipped. Window
    distinct counts are bounded by the stage distinct count, so slicing
    every window stream to ``cap`` is lossless whenever the stage fits —
    the pre-slice ok checks catch when it doesn't. Returns
    (keys[cap], vals[cap], n, ok).

    ``mask`` (a ``mask.LocalMask``) is the mask-filter stage (§4.7): keys
    failing the sorted-membership probe become padding BEFORE any window
    sort. ``nprod`` stays the pre-mask count: it only gates which windows
    can be skipped, and the live prefix is unchanged by masking.
    """
    full_cap = rows.shape[0]
    keys = pack_keys(rows, cols, shape, order)
    if keys is None:
        raise ValueError("the kv path requires a packable tile")
    if mask is not None:
        from .mask import mask_member            # lazy: mask.py imports us
        # probe with keys packed in the MASK's order (may differ from the
        # pipeline's); the pipeline keys are only rewritten to padding
        probe = keys if mask.order == order \
            else pack_keys(rows, cols, shape, mask.order)
        keys = torch.where(mask_member(probe, mask), keys,
                           torch.tensor(_kmax(keys.dtype), dtype=keys.dtype,
                                        device=keys.device))
    win = max(cap, full_cap // MAX_WINDOWS)
    if full_cap <= win or full_cap % win != 0:
        return _kv_dedup_window(keys, vals, nprod, add, cap)
    nlive = int(nprod)
    items = []
    ok = torch.ones((), dtype=torch.bool, device=keys.device)
    for t in range(full_cap // win):
        kw, vw = keys[t * win:(t + 1) * win], vals[t * win:(t + 1) * win]
        nw = min(max(nlive - t * win, 0), win)
        if nw > 0:
            kt, vt, nt, okt = _kv_dedup_window(kw, vw, nw, add, cap)
            ok = ok & okt
        else:
            # windows past the live prefix are all padding, already sorted
            kt, vt = kw[:cap], vw[:cap]
            nt = torch.zeros((), dtype=torch.int32, device=keys.device)
        items.append((kt, vt, nt))
    # fold the window streams pairwise; merges whose right side is empty
    # pass the left side through untouched (the slack never merges either)
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            ka, va, na = items[i]
            kb, vb, nb = items[i + 1]
            if int(nb) > 0:
                ka, va, na, okm = kv_merge2(ka, va, na, kb, vb, nb, add, cap)
                ok = ok & okm
            nxt.append((ka, va, na))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    k, v, n = items[0]
    return k, v, n, ok


def kv_merge2(ka, va, na, kb, vb, nb, add: Monoid, cap: int):
    """Rank-placement merge of two UNIQUE-key sorted kv streams.

    Because each input is already deduplicated, a duplicate run in the
    interleaved stream has length exactly 2 (one entry from each side, A's
    placed first) — so duplicate fusion is one shifted compare + combine,
    no segmented reduction. Liveness is defined by the keys alone
    (dtype-max = padding); ``na``/``nb`` do not gate the merge.
    """
    del na, nb
    ca, cb = ka.shape[0], kb.shape[0]
    dev = ka.device
    kmax = _kmax(ka.dtype)
    kb = kb.to(ka.dtype)
    pos_a = torch.arange(ca, device=dev) + torch.searchsorted(kb, ka)
    pos_b = torch.arange(cb, device=dev) + torch.searchsorted(ka, kb,
                                                              right=True)
    tot = ca + cb
    out_dtype = torch.promote_types(va.dtype, vb.dtype)
    vdims = tuple(va.shape[1:])
    keys = ka.new_full((tot,), kmax)
    keys[pos_a] = ka
    keys[pos_b] = kb
    vals = torch.full((tot,) + vdims, add.identity, dtype=out_dtype,
                      device=dev)
    vals[pos_a] = va.to(out_dtype)
    vals[pos_b] = vb.to(out_dtype)
    live = keys != kmax
    nxt_k = torch.cat([keys[1:], keys.new_full((1,), kmax)])
    nxt_v = torch.cat([vals[1:], vals.new_full((1,) + vdims, add.identity)])
    dup_next = (nxt_k == keys) & live
    fused = torch.where(_vmask(dup_next, vdims), add.op(vals, nxt_v).to(
        out_dtype), vals)
    prev_k = torch.cat([keys.new_full((1,), -1), keys[:-1]])
    dead = (keys == prev_k) & live          # the B copy of a fused pair
    alive = live & ~dead
    pos = torch.cumsum(alive, 0, dtype=torch.int32) - 1
    n_out = alive.sum(dtype=torch.int32)
    tgt = torch.where(alive, pos, tot).long()
    out_k = keys.new_full((tot + 1,), kmax)
    out_k[tgt] = keys
    out_v = torch.full((tot + 1,) + vdims, add.identity, dtype=out_dtype,
                       device=dev)
    out_v[tgt] = fused
    out_k, out_v = out_k[:tot], out_v[:tot]
    cap = min(tot, cap)
    ok = n_out <= cap
    if cap < tot:
        out_k, out_v = out_k[:cap], out_v[:cap]
    return out_k, out_v, torch.clamp(n_out, max=cap), ok


def kv_empty(shape, cap: int, val_dtype, add: Monoid, order: str = "row",
             device=None):
    """Identity kv stream (the incremental-merge accumulator seed)."""
    device = resolve_device(device)
    kd = key_dtype(shape)
    if kd is None:
        raise ValueError("the kv path requires a packable tile")
    return (torch.full((cap,), _kmax(kd), dtype=kd, device=device),
            torch.full((cap,), add.identity, dtype=val_dtype, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def kv_to_coo(keys, vals, n, shape, add: Monoid, out_cap: int,
              order: str = "row") -> COO:
    """Decode a kv stream back to a canonical COO (the single decode)."""
    cap = keys.shape[0]
    vdims = tuple(vals.shape[1:])
    if cap < out_cap:
        keys = torch.cat([keys, keys.new_full((out_cap - cap,),
                                              _kmax(keys.dtype))])
        vals = torch.cat([vals, vals.new_full((out_cap - cap,) + vdims,
                                              add.identity)])
    elif cap > out_cap:
        keys, vals = keys[:out_cap], vals[:out_cap]
    valid = torch.arange(out_cap, dtype=torch.int32, device=keys.device) < n
    row, col = _unpack(torch.where(valid, keys, 0), shape, order)
    sent = sentinel_like(row)
    val = torch.where(_vmask(valid, vdims), vals,
                      torch.tensor(add.identity, dtype=vals.dtype,
                                   device=keys.device))
    return COO(torch.where(valid, row, sent), torch.where(valid, col, sent),
               val, torch.clamp(n, max=out_cap).to(torch.int32), shape, order)


def kv_tree(items, add: Monoid, out_cap: int):
    """Pairwise fold of unique-key kv streams. Returns (k, v, n, ok)."""
    items = list(items)
    if not items:
        raise ValueError("kv_tree needs at least one stream")
    ok = torch.ones((), dtype=torch.bool, device=items[0][0].device)
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            ka, va, na = items[i]
            kb, vb, nb = items[i + 1]
            k, v, n, o = kv_merge2(ka, va, na, kb, vb, nb, add, out_cap)
            ok = ok & o
            nxt.append((k, v, n))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    k, v, n = items[0]
    ok = ok & (n <= out_cap)
    if _faults.trace_fault("merge.kv_ok") is not None:
        # the kv engine's overflow flag lies (reads as failed) on every
        # call while armed — drives the planner into the degradation
        # ladder (the 'sort' merge path never enters kv_tree)
        ok = torch.zeros_like(ok)
    return k, v, n, ok


def merge_stage_products(stages, shape, add: Monoid, stage_cap: int,
                         out_cap: int, order: str = "row", mask=None):
    """Deferred merge tree over raw expansion buffers (DESIGN.md §4.4).

    ``stages``: list of (rows, cols, vals, nprod) padded product buffers.
    Each stage is compacted (kv_from_products) to ``stage_cap`` slots, the
    compacted streams fold pairwise, and rows/cols decode once at the end.
    ``mask`` filters every stage's products before its compaction.
    Returns (COO, ok).
    """
    items = []
    ok = None
    for (r, c, v, n) in stages:
        k, vv, ng, o = kv_from_products(r, c, v, n, shape, add, stage_cap,
                                        order, mask=mask)
        ok = o if ok is None else ok & o
        items.append((k, vv, ng))
    k, v, n, o = kv_tree(items, add, out_cap)
    return kv_to_coo(k, v, n, shape, add, out_cap, order), ok & o
