"""Local (single-tile) SpGEMM under arbitrary semirings (paper §4.1).

The paper's structure — an O(flops) expansion followed by a merge whose
data structure is chosen by compression ratio:

 - ``spgemm_esc``   expand → packed-key sort → segmented reduce (the heap's
                    role: wins at LOW compression ratio; the segmented-reduce
                    kernel on the GPU).
 - ``spgemm_dense`` accumulate into a dense output tile (the hash table's
                    role: O(1) accumulation, wins at HIGH compression ratio;
                    the ``semiring_matmul`` kernel on the GPU).
 - ``spgemm_auto``  the paper's hybrid: picks by estimated compression ratio.

The flops estimate (phase 1 of the paper's three-phase scheme) is computed
exactly as nnz-weighted column counts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .coo import COO, SENTINEL, _vmask, column_range, row_range, sentinel_like
from .semiring import ARITHMETIC, Semiring, dense_semiring_matmul


def spgemm_flops(a: COO, b: COO) -> torch.Tensor:
    """Phase 1 (paper §4.1): exact flops = Σ_t nnz(A(:, B.row[t])).

    When B carries the row-major tag the same sum is Σ_u nnz(B(A.col[u], :))
    over A's entries via binary search on B's rows — no sort of either
    operand. Otherwise A is col-sorted (free when it carries the 'col' tag).
    """
    if b.order == "row" and a.order != "col":
        m = a.mask()
        start, end = row_range(b.row, torch.where(m, a.col, sentinel_like(a.col)))
        return torch.where(m, end - start, 0).sum()
    sa = a.sort("col")
    m = b.mask()
    start, end = column_range(sa.col, torch.where(m, b.row, sentinel_like(b.row)))
    return torch.where(m, end - start, 0).sum()


def _products(lo_start, cnt, owner_cap, other_cap, prod_cap):
    """Slot layout of an expansion: for each product slot s, the owning
    entry t (the entry whose range covers s) and the partner index inside
    the other operand's range. Returns (t, partner, valid, nprod)."""
    dev = cnt.device
    off = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt      # exclusive prefix
    nprod = cnt.sum(dtype=torch.int32)
    s = torch.arange(prod_cap, dtype=torch.int32, device=dev)
    t = torch.searchsorted(off + cnt, s, right=True, out_int32=True)
    tc = t.clamp(0, owner_cap - 1).long()
    partner = (lo_start[tc] + (s - off[tc])).clamp(0, other_cap - 1).long()
    return tc, partner, s < nprod, nprod


def _expand(a: COO, b: COO, sr: Semiring, prod_cap: int):
    """ESC expansion: one slot per scalar multiply (O(flops) work).

    Returns (rows, cols, vals, nprod, ok). Padding slots hold SENTINEL/zero.

    Two symmetric formulations, selected by the order tags:
      - B row-sorted (the maintained 'row' invariant): walk A's entries and
        binary-search B's row ranges. Sort-free — the fast path.
      - otherwise: col-sort A (free when tagged 'col') and walk B's entries
        against A's column ranges.
    Both enumerate the identical product multiset.
    """
    if b.order == "row" and a.order != "col":
        return _expand_sorted_b(a, b, sr, prod_cap)
    sa = a.sort("col")
    m = b.mask()
    start, end = column_range(sa.col, torch.where(m, b.row, sentinel_like(b.row)))
    cnt = torch.where(m, end - start, 0)
    tc, a_idx, valid, nprod = _products(start, cnt, b.cap, sa.cap, prod_cap)
    rows = torch.where(valid, sa.row[a_idx], SENTINEL)
    cols = torch.where(valid, b.col[tc], SENTINEL)
    return rows, cols, _mul(sr, sa.val[a_idx], b.val[tc], valid, a, b), \
        nprod, nprod <= prod_cap


def _expand_sorted_b(a: COO, b: COO, sr: Semiring, prod_cap: int):
    """Sort-free expansion against a row-sorted B (the 'row' invariant path)."""
    m = a.mask()
    start, end = row_range(b.row, torch.where(m, a.col, sentinel_like(a.col)))
    cnt = torch.where(m, end - start, 0)
    tc, b_idx, valid, nprod = _products(start, cnt, a.cap, b.cap, prod_cap)
    rows = torch.where(valid, a.row[tc], SENTINEL)
    cols = torch.where(valid, b.col[b_idx], SENTINEL)
    return rows, cols, _mul(sr, a.val[tc], b.val[b_idx], valid, a, b), \
        nprod, nprod <= prod_cap


def _mul(sr: Semiring, av, bv, valid, a: COO, b: COO) -> torch.Tensor:
    """Products of gathered operands; padding slots hold the add identity."""
    out_dtype = sr.out_dtype(a.dtype, b.dtype)
    vals = sr.mul(av, bv).to(out_dtype)
    if vals.shape[0] != valid.shape[0]:        # a scalar-valued mul
        vals = vals.expand((valid.shape[0],) + tuple(vals.shape[1:]))
    return torch.where(_vmask(valid, vals.shape[1:]), vals,
                       torch.tensor(sr.add.identity, dtype=out_dtype,
                                    device=valid.device))


def spgemm_esc(a: COO, b: COO, sr: Semiring = ARITHMETIC, *,
               prod_cap: int, out_cap: int, order: str = "row",
               mask=None, val_pred=None) -> Tuple[COO, torch.Tensor]:
    """Expand-Sort-Compress SpGEMM. Returns (C, ok_flag).

    ``mask`` (a ``mask.LocalMask``) drops expanded products before the merge
    (the §4.7 pushdown — ``out_cap`` may then be mask-sized); ``val_pred``
    drops merged entries by output value before the capacity clamp.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    rows, cols, vals, nprod, ok = _expand(a, b, sr, prod_cap)
    shape = (a.shape[0], b.shape[1])
    if mask is not None:
        from .mask import filter_products
        rows, cols, vals = filter_products(rows, cols, vals, shape, mask,
                                           sr.add.identity)
    prods = COO(rows, cols, vals,
                torch.clamp(nprod, max=prod_cap).to(torch.int32), shape,
                "none")
    d = prods.dedup(sr.add, order=order)
    if val_pred is not None:
        from .mask import apply_val_pred
        d = apply_val_pred(d, val_pred, sr.add.identity)
    # check the PRE-clamp nnz: with_cap truncates nnz to out_cap, so
    # testing after the clamp would never detect output overflow
    ok = ok & (d.nnz <= out_cap)
    return d.with_cap(out_cap, sr.add.identity), ok


def compression_ratio(a: COO, b: COO) -> torch.Tensor:
    """flops / nnz(C) estimate. The paper's hybrid selector statistic.

    nnz(C) is estimated optimistically as min(flops, m*n) when no symbolic
    phase is run.
    """
    fl = spgemm_flops(a, b).to(torch.float32)
    mn = float(a.shape[0] * b.shape[1])
    est_nnz = torch.clamp(fl, max=mn)
    return fl / torch.clamp(est_nnz, min=1.0)


def spgemm_dense(a: COO, b: COO, sr: Semiring = ARITHMETIC, *,
                 out_cap: int, order: str = "row",
                 mask=None, val_pred=None) -> Tuple[COO, torch.Tensor]:
    """Dense-accumulator SpGEMM (the hash-table analogue).

    Densifies the inputs into tiles and contracts them with
    ``dense_semiring_matmul`` — the ``semiring_matmul`` kernel for its four
    algebras on the GPU. Masks apply on the dense accumulator (the member
    matrix is the mask's natural dense view). Returns (C, ok_flag).
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    zero = sr.add.identity
    cd = dense_semiring_matmul(a.to_dense(zero), b.to_dense(zero), sr)
    zt = torch.tensor(zero, dtype=cd.dtype, device=cd.device)
    if mask is not None:
        from .mask import mask_dense
        cd = torch.where(mask_dense(mask, (a.shape[0], b.shape[1])), cd, zt)
    if val_pred is not None:
        cd = torch.where(val_pred(cd), cd, zt)
    c = COO.from_dense(cd, out_cap, zero=zero, order=order)
    return c, (cd != zero).sum() <= out_cap


def local_algo(a: COO, b: COO, *, dense_threshold: float = 4.0,
               dense_tile_limit: int = 1 << 22,
               ratio: Optional[float] = None) -> str:
    """The hybrid's policy, shared by ``spgemm_auto`` and
    ``plan_local_spgemm``: ``"dense"`` when the output tile fits
    ``dense_tile_limit`` and the compression ratio is at least
    ``dense_threshold``, else ``"esc"``. The ratio is read back to the host
    once, unless the caller passes it."""
    if a.shape[0] * b.shape[1] > dense_tile_limit:
        return "esc"
    if ratio is None:
        ratio = float(compression_ratio(a, b))
    return "dense" if ratio >= dense_threshold else "esc"


def spgemm_auto(a: COO, b: COO, sr: Semiring = ARITHMETIC, *,
                prod_cap: int, out_cap: int, order: str = "row",
                dense_threshold: float = 4.0,
                dense_tile_limit: int = 1 << 22,
                mask=None, val_pred=None,
                algo: Optional[str] = None) -> Tuple[COO, torch.Tensor]:
    """Hybrid selector (the paper's hash/heap hybrid, adapted).

    Dense-accumulator path when the estimated compression ratio is at least
    ``dense_threshold`` and the output tile fits ``dense_tile_limit``; ESC
    otherwise. PyTorch has no ``lax.cond``: the branch is resolved here by
    ``local_algo``, unless the caller passes the ``algo`` of its
    ``plan_local_spgemm`` plan, which saves the ratio's host read.
    """
    if algo is None:
        algo = local_algo(a, b, dense_threshold=dense_threshold,
                          dense_tile_limit=dense_tile_limit)
    if algo not in ("dense", "esc"):
        raise ValueError(f"algo must be 'dense' or 'esc', not {algo!r}")
    kw = dict(out_cap=out_cap, order=order, mask=mask, val_pred=val_pred)
    if algo == "dense":
        return spgemm_dense(a, b, sr, **kw)
    return spgemm_esc(a, b, sr, prod_cap=prod_cap, **kw)
