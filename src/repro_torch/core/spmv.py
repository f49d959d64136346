"""Distributed SpMV / SpMSpV on the 2D grid (paper §3.1, Table 1).

y = A ⊕.⊗ x with A 2D-distributed and x fully distributed (DistVec layout
'col': block j of x is owned collectively by process column j). The JAX
package's pipeline, as in ``repro.core.spmv``:

  1. all-gather x pieces along the 'row' axis → every device in process
     column j holds the full column block x_j;
  2. a local SpMV variant (row- or col-partitioned, §4.2);
  3. reduce the partial y along the 'col' axis (``psum_scatter`` for
     tagged sums), yielding y fully distributed in layout 'row'.

SpMSpV keeps the frontier sparse end to end (§4.3): sparse pieces gather
along 'row', the local SpMSpV variant produces a sparse partial, and
partials merge along 'col' densely or sparsely (bucketed all-to-all).

The collectives are ``core/comm.py``'s; over axes of size 1 (the 1x1
grid) each is the identity. SpMSpV's frontier is guarded where it enters
its all-gather (``robust.audit.guard_exchange`` at ``spmspv.comm_x``) and
its result audited at ``spmspv.out`` (level ``full``).
"""
from __future__ import annotations

import torch

from ..obs import recorder as _obs
from ..robust import audit as _audit
from . import comm
from . import spmv_local as L
from .coo import COO, SENTINEL, sentinel_like
from .dist import DistSpMat, DistSpVec, DistVec, Grid
from .matops import reduce_over, transpose_perm
from .semiring import ARITHMETIC, Semiring


def transpose_layout(v: DistVec, *, mesh: Grid) -> DistVec:
    """Swap piece (i,j) <-> (j,i): converts layout 'row' <-> 'col' (one
    ``ppermute`` over the grid)."""
    del mesh
    assert v.grid[0] == v.grid[1], "layout transpose needs a square grid"
    d = comm.ppermute(v.data, comm.of(v.grid), comm.WORLD,
                      transpose_perm(v.grid[0]))
    return DistVec(d, v.n, v.grid, "row" if v.layout == "col" else "col")


@_obs.timed("spmv")
def spmv(a: DistSpMat, x: DistVec, sr: Semiring = ARITHMETIC, *,
         mesh: Grid, variant: str = "row") -> DistVec:
    """y = A x. x must be layout 'col'; the result is layout 'row'."""
    del mesh
    assert x.layout == "col", "spmv expects a column-layout input vector"
    g = comm.of(a.grid)
    local_fn = L.spmv_row if variant == "row" else L.spmv_col
    xj = comm.all_gather(x.data.reshape(-1), g, "row", tiled=True)  # (nb,)
    y_part = local_fn(a.tile(), xj, sr)                             # (mb,)
    # psum_scatter (tagged sums) or all_gather + add.op along 'col'
    y = reduce_over(y_part, sr.add, g, "col")
    return DistVec(y[None, None], a.shape[0], a.grid, "row")


def spmv_iter(a: DistSpMat, x: DistVec, sr: Semiring = ARITHMETIC, *,
              mesh: Grid, variant: str = "row") -> DistVec:
    """SpMV returning a column-layout vector (ready for the next iteration)."""
    return transpose_layout(spmv(a, x, sr, mesh=mesh, variant=variant),
                            mesh=mesh)


@_obs.timed("spmspv")
def spmspv(a: DistSpMat, x: DistSpVec, sr: Semiring = ARITHMETIC, *,
           mesh: Grid, variant: str = "sort", merge: str = "sparse",
           prod_cap: int, out_cap: int, mask=None):
    """y = A x with sparse x. Returns (DistSpVec layout 'row', ok[pr,pc]).

    merge='sparse': partial outputs stay sparse; destination pieces receive
    entries through a bucketed all-to-all along 'col' (paper §3.3).
    merge='dense' : partial SPA vectors are psum_scattered (tag 'sum' only).

    ``mask`` (a ``mask.vector_mask`` MaskSpec over a layout-'row' DistVec,
    piece-aligned with y) drops products on non-admissible output rows
    inside the local expansion, before the variant merges (§4.7).
    """
    assert x.layout == "col"
    # the frontier is about to enter the 'row' all-gather: the wire
    # boundary the audit checksums bracket (robust/audit.guard_exchange)
    x = _audit.guard_exchange("spmspv.comm_x", x)
    pr, pc = a.grid
    local_fn = L.SPMSPV_VARIANTS[variant]
    vb_out = -(-a.shape[0] // (pr * pc))
    mv = mask.vec if mask is not None else None
    if mask is not None:
        if mv is None:
            raise ValueError("spmspv masks are dense-vector masks "
                             "(mask.vector_mask)")
        assert mv.layout == "row" and mv.grid == a.grid \
            and mv.n == a.shape[0], "mask must be piece-aligned with y"
    g = comm.of(a.grid)
    with _obs.span("spmspv.execute", variant=variant, merge=merge):
        tile = a.tile()
        allow = None
        if mv is not None:
            member = torch.as_tensor(mask.pred(mv.data.reshape(-1)))
            if mask.complement:
                member = ~member
            # process row i's pieces j = 0..pc-1 are exactly the tile's row
            # range [i*mb, (i+1)*mb) in j order (layout 'row')
            allow = comm.all_gather(member, g, "col", tiled=True)  # (mb,)
        # gather the frontier pieces of column block j, localized to the
        # block, along 'row', and the psum of their counts
        xi_l = x.idx.reshape(-1)
        xv_l = x.val.reshape(-1)
        xn_l = x.nnz.reshape(())
        gi, gv, gn = xi_l, xv_l, xn_l
        if pr > 1:
            vb_in = a.nb // pr
            xi_blk = torch.where(xi_l != SENTINEL, xi_l + g.i * vb_in,
                                 sentinel_like(xi_l))
            gi = comm.all_gather(xi_blk, g, "row", tiled=True)
            gv = comm.all_gather(xv_l, g, "row", tiled=True)
            gn = comm.psum(xn_l, g, "row")
            # the gather interleaves each piece's padding: move it to the
            # end (a stable partition), as the local kernels expect
            order = torch.argsort((gi == SENTINEL).to(torch.uint8),
                                  stable=True)
            gi, gv = gi[order], gv[order]
        (yi, yv, yn), ok = local_fn(tile, gi, gv, gn, sr,
                                    prod_cap=prod_cap, out_cap=out_cap,
                                    allow=allow)
        if merge == "dense" and sr.add.tag == "sum":
            dense = L.spvec_to_dense(yi, yv, a.mb, zero=0)
            piece = comm.psum_scatter(dense, g, "col")
            # spvec_from_dense clamps nnz to out_cap: detect the overflow
            # before re-sparsifying
            ok = ok & ((piece != 0).sum() <= out_cap)
            ri, rv, rn = L.spvec_from_dense(piece, out_cap, zero=0)
        else:
            ri, rv, rn, ok = _sparse_merge(yi, yv, ok, sr, g, vb_out,
                                           out_cap)
        _obs.sync(ri.device)
    y = DistSpVec(ri[None, None], rv[None, None], rn.reshape(1, 1),
                  a.shape[0], a.grid, "row")
    _audit.audit_obj(y, "spmspv.out", min_level=_audit.FULL)
    return y, ok.reshape(1, 1)


def _sparse_merge(yi, yv, ok, sr: Semiring, g, vb_out: int, out_cap: int):
    """Bucket the partial entries by destination piece (``out_cap // pc``
    slots each, at least 8), exchange the buckets (an ``all_to_all`` along
    'col') and merge duplicates from the pc sources. ``ok`` turns false
    when a bucket or the merged piece overflows."""
    dev = yi.device
    pc = g.pc
    dest = torch.where(yi != SENTINEL, yi // vb_out, pc)
    cap_d = max(out_cap // pc, 8)
    d_s, order = torch.sort(dest, stable=True)
    seg = torch.searchsorted(d_s, torch.arange(pc + 1, dtype=d_s.dtype,
                                               device=dev), out_int32=True)
    ok = ok & ((seg[1:] - seg[:-1]) <= cap_d).all()
    within = torch.arange(yi.shape[0], dtype=torch.int32, device=dev) - \
        seg[d_s.clamp(0, pc - 1).long()]
    keep = (d_s < pc) & (within < cap_d)
    # entries past their bucket go to a spare slot past the end (dropped,
    # as JAX's mode='drop' drops them)
    slot = torch.where(keep, d_s * cap_d + within, pc * cap_d).long()
    bi = torch.full((pc * cap_d + 1,), SENTINEL, dtype=torch.int32,
                    device=dev)
    bv = torch.full((pc * cap_d + 1,), sr.add.identity, dtype=yv.dtype,
                    device=dev)
    bi[slot] = yi[order]
    bv[slot] = yv[order]
    bi = comm.all_to_all(bi[:-1], g, "col")
    bv = comm.all_to_all(bv[:-1], g, "col")
    # localize to my piece and merge duplicates from the pc sources
    valid = bi != SENTINEL
    s = sentinel_like(bi)
    d = COO(torch.where(valid, bi - g.j * vb_out, s),
            torch.where(valid, 0, s), bv,
            valid.sum(dtype=torch.int32), (vb_out, 1), "none").dedup(sr.add)
    ok = ok & (d.nnz <= out_cap)             # pre-clamp nnz
    merged = d.with_cap(out_cap, sr.add.identity)
    return merged.row, merged.val, merged.nnz, ok


def transpose_spvec_layout(v: DistSpVec, *, mesh: Grid) -> DistSpVec:
    """Layout 'row' <-> 'col' of a sparse vector: pieces (i,j) <-> (j,i),
    the three fields in one ``ppermute``."""
    del mesh
    assert v.grid[0] == v.grid[1]
    idx, val, nnz = comm.permute_fields(
        (v.idx, v.val, v.nnz), comm.of(v.grid), comm.WORLD,
        transpose_perm(v.grid[0]))
    return DistSpVec(idx, val, nnz, v.n, v.grid,
                     "row" if v.layout == "col" else "col")
