"""Distributed matrix/vector helper operations used by the graph apps.

Tile-local operations on a ``DistSpMat`` and piece-aligned vector ops:
elementwise tile ops and masking a sparse vector with a dense vector in the
same layout need no communication — the payoff of CombBLAS's superimposed
distributions. The reductions, the row/column scalings and the transpose
exchange along the grid's axes as the JAX package's bodies do
(``core/comm.py``); over axes of size 1 (the 1x1 grid) those collectives
are the identity.
"""
from __future__ import annotations

import torch

from . import comm
from .coo import COO, SENTINEL, _vmask, sentinel_like
from .dist import DistSpMat, DistSpVec, DistVec, Grid, grid_sum
from .semiring import Monoid


def transpose_perm(q: int):
    """(src, dst) pairs on a row-major q x q grid: (i, j) -> (j, i)."""
    return [(i * q + j, j * q + i) for i in range(q) for j in range(q)]


def mat_apply_local(a: DistSpMat, fn, *, mesh: Grid) -> DistSpMat:
    """Apply ``fn: COO -> COO`` (same capacity) tile-wise; the result
    carries the order tag ``fn`` reports."""
    del mesh                          # each rank's tile is local
    return DistSpMat.from_tile(fn(a.tile()), a.shape, a.grid)


def mat_ewise_local(a: DistSpMat, b: DistSpMat, fn, *, mesh: Grid) \
        -> DistSpMat:
    """fn: (COO, COO) -> COO on aligned tiles (same grid), no exchange."""
    del mesh
    assert a.grid == b.grid and a.shape == b.shape
    return DistSpMat.from_tile(fn(a.tile(), b.tile()), a.shape, a.grid)


def reduce_over(local: torch.Tensor, add: Monoid, g, axis):
    """This member's piece of ``local`` reduced over ``axis``: a
    ``psum_scatter`` for tagged sums, else an ``all_gather`` and ``add.op``
    in axis order (the JAX bodies' two forms)."""
    if add.tag == "sum":
        return comm.psum_scatter(local, g, axis)
    red = comm.psum(local, g, axis, add.op)
    return red.reshape((g.size(axis), -1) + tuple(red.shape[1:]))[
        g.index(axis)]


def mat_reduce(a: DistSpMat, axis: int, add: Monoid, *, mesh: Grid) \
        -> DistVec:
    """Row (axis=1) or column (axis=0) reduction → DistVec, layout 'row'
    for axis=1 (reduced along 'col') and 'col' for axis=0 (along 'row')."""
    del mesh
    g = comm.of(a.grid)
    local = a.tile().reduce(axis, add)       # (mb,) or (nb,)
    piece = reduce_over(local, add, g, "col" if axis == 1 else "row")
    n = a.shape[0] if axis == 1 else a.shape[1]
    return DistVec(piece[None, None], n, a.grid, "row" if axis == 1 else "col")


def mat_scale_cols(a: DistSpMat, v: DistVec, mul=torch.mul, *,
                   mesh: Grid) -> DistSpMat:
    """A[:, j] *= v[j]. v layout 'col' (all-gathered along 'row', as
    SpMV's x)."""
    del mesh
    assert v.layout == "col"
    xj = comm.all_gather(v.data.reshape(-1), comm.of(a.grid), "row",
                         tiled=True)
    t = a.tile().scale_cols(xj, mul)
    return DistSpMat.from_tile(t, a.shape, a.grid)


def mat_scale_rows(a: DistSpMat, v: DistVec, mul=torch.mul, *,
                   mesh: Grid) -> DistSpMat:
    """A[i, :] *= v[i]. v layout 'row' (all-gathered along 'col')."""
    del mesh
    assert v.layout == "row"
    xi = comm.all_gather(v.data.reshape(-1), comm.of(a.grid), "col",
                         tiled=True)
    t = a.tile().scale_rows(xi, mul)
    return DistSpMat.from_tile(t, a.shape, a.grid)


def mat_transpose(a: DistSpMat, *, mesh: Grid) -> DistSpMat:
    """A^T on a square grid: tiles swap across the diagonal (one packed
    ``ppermute``), then row and col swap locally; (row, col)-sorted tiles
    become (col, row)-sorted in the new coordinates."""
    del mesh
    assert a.pr == a.pc
    t, _ = comm.tile_permute(a.tile(), comm.of(a.grid), comm.WORLD,
                             transpose_perm(a.pr))
    return DistSpMat.from_tile(t.transpose(), (a.shape[1], a.shape[0]),
                               a.grid)


def mat_select_lower(a: DistSpMat, *, mesh: Grid, strict=True) -> DistSpMat:
    """Keep entries with global row > col (strict lower triangle)."""
    del mesh
    g = comm.of(a.grid)
    t = a.tile()
    grow = t.row.long() + g.i * a.mb
    gcol = t.col.long() + g.j * a.nb
    keep = (grow > gcol) if strict else (grow >= gcol)
    return DistSpMat.from_tile(_prune_mask(t, keep), a.shape, a.grid)


def _prune_mask(t: COO, keep: torch.Tensor) -> COO:
    keep = keep & t.mask()
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    k = keep[order]
    s = sentinel_like(t.row)
    val = torch.where(_vmask(k, t.vdims), t.val[order],
                      torch.zeros((), dtype=t.dtype, device=t.device))
    # stable compaction: surviving entries keep their relative order
    return COO(torch.where(k, t.row[order], s), torch.where(k, t.col[order], s),
               val, keep.sum(dtype=torch.int32), t.shape, t.order)


def mat_sum(a: DistSpMat) -> torch.Tensor:
    """Σ stored values (arithmetic) over the grid, the same on every rank."""
    return grid_sum(torch.where(a.row != SENTINEL, a.val, 0), a.grid)


def mat_nnz(a: DistSpMat) -> torch.Tensor:
    return grid_sum(a.nnz, a.grid)


# ---------------- piece-aligned vector ops (no communication) -------------

def vec_ewise(u: DistVec, v: DistVec, fn) -> DistVec:
    assert u.layout == v.layout and u.grid == v.grid
    return DistVec(fn(u.data, v.data), u.n, u.grid, u.layout)


def vec_apply(u: DistVec, fn) -> DistVec:
    return DistVec(fn(u.data), u.n, u.grid, u.layout)


def vec_sum(u: DistVec) -> torch.Tensor:
    # padding beyond n is zero by construction in from_global; keep it so
    return grid_sum(u.data, u.grid)


def spvec_mask(x: DistSpVec, v: DistVec, keep_fn) -> DistSpVec:
    """Filter sparse entries by keep_fn(x_val, v_val_at_idx); layouts must
    match so the lookup is piece-local. Stable compaction keeps order."""
    assert x.layout == v.layout and x.grid == v.grid
    xi, xv, vd = x.idx[0, 0], x.val[0, 0], v.data[0, 0]
    vals_at = vd[xi.long().clamp(0, v.vb - 1)]
    keep = (xi != SENTINEL) & keep_fn(xv, vals_at)
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    k = keep[order]
    ni = torch.where(k, xi[order], sentinel_like(xi))
    nv = torch.where(k, xv[order], torch.zeros((), dtype=xv.dtype,
                                                device=xv.device))
    return DistSpVec(ni[None, None], nv[None, None],
                     keep.sum(dtype=torch.int32).reshape(1, 1), x.n, x.grid,
                     x.layout)


def vec_scatter_spvec(v: DistVec, x: DistSpVec, fn) -> DistVec:
    """v[i] = fn(v[i], x[i]) for stored x entries: a piece-aligned scatter.
    Padding slots (SENTINEL, or any index past the piece) write to a spare
    slot past the end, which is dropped, as JAX's ``mode='drop'`` does."""
    assert x.layout == v.layout and x.grid == v.grid
    vd, xi = v.data[0, 0], x.idx[0, 0]
    vb = vd.shape[0]
    inside = (xi >= 0) & (xi < vb)
    new = fn(vd[xi.long().clamp(0, vb - 1)], x.val[0, 0])
    out = torch.cat([vd, vd[:1]])
    out[torch.where(inside, xi.long(), vb)] = new.to(vd.dtype)
    return DistVec(out[:vb][None, None], v.n, v.grid, v.layout)


def spvec_nnz(x: DistSpVec) -> torch.Tensor:
    return grid_sum(x.nnz, x.grid)
