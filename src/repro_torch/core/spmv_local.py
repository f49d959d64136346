"""Local SpMV / SpMSpV algorithm families (paper §4.2–4.3, Fig 3).

The paper's multithreaded variants as algorithmic variants, as in
``repro.core.spmv_local`` (the partitioning changes the data structures and
memory traffic, not just the schedule):

SpMV  (dense x):
  - ``spmv_row``  row-partitioned: row-major tile, per-row segments reduced
                  in order (sorted ids into the segmented-reduce kernel).
  - ``spmv_col``  col-partitioned: col-major tile, products scattered into
                  the output accumulator (unsorted ids into the same kernel).

SpMSpV (sparse x, f = nnz(x)):
  - ``spmspv_sort``   merge products by sorting (heap analogue; best for very
                      sparse vectors).
  - ``spmspv_spa``    dense SPA accumulator + re-sparsify (best dense-ish).
  - ``spmspv_bucket`` propagation blocking: products binned by row bucket,
                      then accumulated bucket by bucket.

All variants cost O(f + df) work like the paper's, accept arbitrary
semirings, and return (sparse_y, ok_overflow_flag). Tagged monoids reduce on
the segmented-reduce kernel on the GPU; JAX's ``lax.sort`` with one key and
carried operands is a stable ``torch.sort`` of the key plus one gather.
"""
from __future__ import annotations

import torch

from .coo import COO, SENTINEL, _vmask, column_range, first_present, \
    sentinel_like
from .local_spgemm import _products
from .semiring import (ARITHMETIC, MIN_INT, Monoid, Semiring,
                       scatter_onto_identity, segment_reduce)


# --------------------------------------------------------------------------
# sparse vector container (FullyDistSpVec's local piece)
# --------------------------------------------------------------------------

def spvec(idx, val, n: int, nnz=None):
    """Canonical padded sparse vector: (idx[i32 cap], val[cap], nnz)."""
    idx = torch.as_tensor(idx).to(torch.int32)
    nnz = torch.tensor(idx.shape[0] if nnz is None else int(nnz),
                       dtype=torch.int32, device=idx.device)
    live = torch.arange(idx.shape[0], dtype=torch.int32,
                        device=idx.device) < nnz
    return torch.where(live, idx, sentinel_like(idx)), val, nnz


def spvec_from_dense(x: torch.Tensor, cap: int, zero=0):
    """The first ``cap`` entries of ``x`` that differ from ``zero``."""
    lin, nnz = first_present(x != zero, cap)
    live = lin >= 0
    idx = torch.where(live, lin.to(torch.int32), sentinel_like(x))
    val = torch.where(live, x[lin.clamp(min=0)],
                      torch.tensor(zero, dtype=x.dtype, device=x.device))
    return idx, val, nnz


def spvec_to_dense(idx, val, n: int, zero=0) -> torch.Tensor:
    out = torch.full((n + 1,) + tuple(val.shape[1:]), zero, dtype=val.dtype,
                     device=val.device)
    inside = (idx >= 0) & (idx < n)
    out[torch.where(inside, idx.long(), n)] = val   # the rest: a spare slot
    return out[:n]


# --------------------------------------------------------------------------
# SpMV, dense input vector
# --------------------------------------------------------------------------

def _gathered_products(sa: COO, x: torch.Tensor, sr: Semiring):
    xc = x[sa.col.long().clamp(0, sa.shape[1] - 1)]
    return sr.mul(sa.val, xc)


def spmv_row(a: COO, x: torch.Tensor, sr: Semiring = ARITHMETIC):
    """Row-partitioned SpMV: y = A ⊕.⊗ x via row-segment reduction."""
    sa = a.sort("row")
    prod = _gathered_products(sa, x, sr)
    ids = torch.where(sa.mask(), sa.row, a.shape[0])
    return segment_reduce(prod, ids, a.shape[0], sr.add, sorted_ids=True)


def spmv_col(a: COO, x: torch.Tensor, sr: Semiring = ARITHMETIC):
    """Col-partitioned SpMV: products scattered into the output accumulator."""
    sa = a.sort("col")
    prod = _gathered_products(sa, x, sr)
    rows = torch.where(sa.mask(), sa.row, sentinel_like(sa.row))
    return _scatter_monoid(rows, prod, a.shape[0], sr.add)


# --------------------------------------------------------------------------
# SpMSpV, sparse input vector
# --------------------------------------------------------------------------

def _expand_spmspv(a: COO, xi, xv, xnnz, sr: Semiring, prod_cap: int,
                   allow=None):
    """Products A(:,k)·x_k for every nonzero x_k. O(df) like the paper.

    ``allow`` (dense bool over the tile's rows, or None) is the output-mask
    pushdown (§4.7): products landing on disallowed rows are dropped HERE,
    before any of the variant merges, so ``out_cap`` may be sized to the
    allowed count.
    """
    sa = a.sort("col")
    live = torch.arange(xi.shape[0], device=xi.device) < xnnz
    k = torch.where(live, xi, sentinel_like(xi))
    start, end = column_range(sa.col, k)
    cnt = torch.where(k != SENTINEL, end - start, 0)
    tc, a_idx, valid, nprod = _products(start, cnt, xi.shape[0], sa.cap,
                                        prod_cap)
    rr = sa.row[a_idx]
    if allow is not None:
        valid = valid & allow[rr.long().clamp(0, a.shape[0] - 1)]
    out_dtype = sr.out_dtype(a.dtype, xv.dtype)
    rows = torch.where(valid, rr, sentinel_like(rr))
    vals = sr.mul(sa.val[a_idx], xv[tc]).to(out_dtype)
    vals = torch.where(_vmask(valid, vals.shape[1:]), vals,
                       torch.tensor(sr.add.identity, dtype=out_dtype,
                                    device=vals.device))
    return rows, vals, nprod, nprod <= prod_cap


def spmspv_sort(a: COO, xi, xv, xnnz, sr: Semiring = ARITHMETIC, *,
                prod_cap: int, out_cap: int, allow=None):
    """Sort-merge SpMSpV (heap analogue). Returns ((yi, yv, ynnz), ok)."""
    rows, vals, nprod, ok = _expand_spmspv(a, xi, xv, xnnz, sr, prod_cap,
                                           allow)
    rows_s, perm = torch.sort(rows, stable=True)
    vals_s = vals[perm]
    prev = torch.cat([rows_s.new_full((1,), -1), rows_s[:-1]])
    newgrp = (rows_s != prev) & (rows_s != SENTINEL)
    gid = torch.cumsum(newgrp, 0, dtype=torch.int32) - 1
    ngrp = torch.clamp(gid[-1] + 1, min=0)
    gid = torch.where(rows_s != SENTINEL, gid, prod_cap)
    red = segment_reduce(vals_s, gid, out_cap, sr.add, sorted_ids=True)
    first = segment_reduce(
        torch.arange(prod_cap, dtype=torch.int32, device=rows.device), gid,
        out_cap, MIN_INT, sorted_ids=True)
    valid = torch.arange(out_cap, dtype=torch.int32,
                         device=rows.device) < ngrp
    yi = torch.where(valid, rows_s[first.long().clamp(0, prod_cap - 1)],
                     sentinel_like(rows_s))
    yv = torch.where(_vmask(valid, vals.shape[1:]), red,
                     torch.tensor(sr.add.identity, dtype=red.dtype,
                                  device=red.device))
    ok = ok & (ngrp <= out_cap)
    return (yi, yv, torch.clamp(ngrp, max=out_cap).to(torch.int32)), ok


def _resparsify(dense, sr: Semiring, out_cap: int, ok):
    yi, yv, ynnz = spvec_from_dense(dense, out_cap, zero=sr.add.identity)
    cnt = (dense != sr.add.identity).sum()
    return (yi, yv, ynnz), ok & (cnt <= out_cap)


def spmspv_spa(a: COO, xi, xv, xnnz, sr: Semiring = ARITHMETIC, *,
               prod_cap: int, out_cap: int, allow=None):
    """SPA SpMSpV: dense accumulator of length m, then re-sparsify."""
    rows, vals, nprod, ok = _expand_spmspv(a, xi, xv, xnnz, sr, prod_cap,
                                           allow)
    dense = _scatter_monoid(rows, vals, a.shape[0], sr.add)
    return _resparsify(dense, sr, out_cap, ok)


def spmspv_bucket(a: COO, xi, xv, xnnz, sr: Semiring = ARITHMETIC, *,
                  prod_cap: int, out_cap: int, nbuckets: int = 16,
                  allow=None):
    """Propagation-blocking SpMSpV (the paper's SpMSpV-Bucket).

    Products are partitioned by row bucket (rows // ceil(m / nbuckets),
    a stable sort, so rows keep their order inside a bucket) and then
    accumulated, each bucket touching only its window of the accumulator.
    """
    rows, vals, nprod, ok = _expand_spmspv(a, xi, xv, xnnz, sr, prod_cap,
                                           allow)
    m = a.shape[0]
    bwidth = -(-m // nbuckets)
    bucket = torch.where(rows != SENTINEL, rows // bwidth, nbuckets)
    _, perm = torch.sort(bucket, stable=True)
    dense = _scatter_monoid(rows[perm], vals[perm], m, sr.add)
    return _resparsify(dense, sr, out_cap, ok)


def _scatter_monoid(rows, vals, m: int, add: Monoid):
    """Accumulate ``vals`` into a length-``m`` identity-filled accumulator
    (SENTINEL rows dropped): tagged monoids on the segmented-reduce kernel,
    combined onto the identity as JAX's ``.at[].add/min/max`` is; others by
    the segmented scan after a sort by row (an honest extra cost)."""
    if add.tag in ("sum", "min", "max"):
        return scatter_onto_identity(vals, rows, m, add)
    ids = torch.where(rows == SENTINEL, m, rows)
    return segment_reduce(vals, ids, m, add)


SPMSPV_VARIANTS = {
    "sort": spmspv_sort,
    "spa": spmspv_spa,
    "bucket": spmspv_bucket,
}


def spmspv_auto(a: COO, xi, xv, xnnz, sr: Semiring = ARITHMETIC, *,
                prod_cap: int, out_cap: int, allow=None):
    """Fig-3 rule of thumb: sort below ~0.5% vector density, bucket to ~10%,
    SPA above (paper §4.5). The density is read back to the host once (no
    ``lax.cond`` in PyTorch) and compared in float32, as JAX does."""
    n = max(a.shape[1], 1)
    density = torch.as_tensor(xnnz).to(torch.float32) / n
    tier = (density >= 0.005).to(torch.int32) + (density >= 0.10).to(
        torch.int32)
    variant = ("sort", "bucket", "spa")[int(tier)]
    return SPMSPV_VARIANTS[variant](a, xi, xv, xnnz, sr, prod_cap=prod_cap,
                                    out_cap=out_cap, allow=allow)
