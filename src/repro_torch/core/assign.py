"""Distributed vector assign / extract (paper §3.3, VecAssign in Table 1).

Irregular vector updates are the latency-bound tail of graph algorithms
(Awerbuch-Shiloach / FastSV). CombBLAS 2.0's schemes, as in
``repro.core.assign``:

 - **Two-stage hierarchical all-to-all**: entries are routed first along the
   'row' axis (to the destination process row), then along 'col', each
   stage an all-to-all on a √p-sized communicator.
 - **Skew-aware path** (``skew_aware=True``): per-destination counts are
   summed grid-wide; destinations above ``heavy_frac`` of total traffic are
   served via an all-gather (every device sees heavy entries, owners
   filter), while the light remainder rides the bounded all-to-all.

The all-to-alls, the census's ``psum`` and the heavy entries'
``all_gather`` are ``core/comm.py``'s; over axes of size 1 (the 1x1 grid)
each is the identity. The routing itself runs on every grid, bucket
capacities and all, because the ``ok`` flags depend on it.

All updates use GLOBAL int32 indices, SENTINEL-padded.
"""
from __future__ import annotations

import torch

from . import comm
from .coo import SENTINEL, sentinel_like
from .dist import DistVec, Grid
from .semiring import PLUS, Monoid, segment_reduce


def _bucketize(dest: torch.Tensor, payloads, nb: int, cap_b: int, fills):
    """Radix-place entries into nb buckets of cap_b slots each.

    dest >= nb marks invalid entries. An entry past its bucket's cap_b
    slots is dropped and clears ``ok``. Returns (bucketed_payloads, ok).
    """
    n = dest.shape[0]
    dev = dest.device
    d_s, order = torch.sort(dest, stable=True)
    seg = torch.searchsorted(d_s, torch.arange(nb + 1, dtype=d_s.dtype,
                                               device=dev), out_int32=True)
    ok = ((seg[1:] - seg[:-1]) <= cap_b).all()
    within = torch.arange(n, dtype=torch.int32, device=dev) - \
        seg[d_s.clamp(0, nb - 1).long()]
    keep = (d_s < nb) & (within < cap_b)
    # dropped entries go to a spare slot past the end (JAX's mode='drop')
    slot = torch.where(keep, d_s * cap_b + within.clamp(max=cap_b - 1),
                       nb * cap_b).long()
    outs = []
    for p, fill in zip(payloads, fills):
        buf = torch.full((nb * cap_b + 1,) + tuple(p.shape[1:]), fill,
                         dtype=p.dtype, device=dev)
        buf[slot] = p[order]
        outs.append(buf[:-1])
    return tuple(outs), ok


def route_to_pieces(gidx: torch.Tensor, payloads, fills, *, n: int, grid,
                    cap: int):
    """Route (global_idx, payload) entries to the owning piece (layout 'col').

    Returns (local_idx, payloads, ok): entries on their owner, indices
    localized to the piece, SENTINEL padding.
    """
    pr, pc = grid
    g = comm.of(grid)
    vb = -(-n // (pr * pc))
    valid = gidx != SENTINEL
    piece = torch.where(valid, gidx // vb, pr * pc)
    dest_i = torch.where(valid, piece % pr, pr)          # layout 'col'
    dest_j = torch.where(valid, piece // pr, pc)
    # stage 1: along 'row' to the destination process row
    (g1, dj1, *p1), ok1 = _bucketize(
        dest_i, (gidx, dest_j) + tuple(payloads), pr, cap // pr,
        (SENTINEL, pc) + tuple(fills))
    g1, dj1, *p1 = comm.all_to_all_fields([g1, dj1] + p1, g, "row")
    # stage 2: along 'col' to the destination process column
    valid1 = g1 != SENTINEL
    dj1 = torch.where(valid1, dj1, pc)
    (g2, *p2), ok2 = _bucketize(dj1, (g1,) + tuple(p1), pc, cap // pc,
                                (SENTINEL,) + tuple(fills))
    g2, *p2 = comm.all_to_all_fields([g2] + p2, g, "col")
    lidx = torch.where(g2 != SENTINEL, g2 % vb, sentinel_like(g2))
    return lidx, tuple(p2), ok1 & ok2


def _route_cap(route_cap: int | None, cap: int, grid) -> int:
    """The router's slots: 2 x the request lists (at least 64) unless
    given, rounded up to a multiple of pr * pc."""
    pr, pc = grid
    route_cap = route_cap or max(cap * 2, 64)
    return -(-route_cap // (pr * pc)) * pr * pc      # divisible by pr, pc


def assign(v: DistVec, gidx: torch.Tensor, val: torch.Tensor, *,
           mesh: Grid, route_cap: int | None = None,
           add: Monoid | None = None, accumulate: bool = False,
           skew_aware: bool = False, heavy_frac: float = 0.5):
    """v[gidx] = val (distributed scatter). Returns (DistVec, ok[pr, pc]).

    gidx/val: (pr, pc, cap) per-device update lists, global indices,
    SENTINEL-padded. ``add`` merges duplicate updates (None = overwrite;
    duplicate targets then take an arbitrary writer, as in CombBLAS's
    non-deterministic assign). ``accumulate=True`` additionally combines
    the merged update with the existing value (v[i] = add(v[i], upd)).
    """
    del mesh
    assert v.layout == "col"
    pr, pc = v.grid
    g = comm.of(v.grid)
    route_cap = _route_cap(route_cap, gidx.shape[-1], v.grid)
    vb, n = v.vb, v.n
    gi = gidx.reshape(-1)
    gv = val.reshape((-1,) + tuple(val.shape[3:]))
    mine_extra = None
    if skew_aware:
        # grid-wide per-piece traffic census (p counts a device)
        piece = torch.where(gi != SENTINEL, gi // vb, pr * pc)
        counts = segment_reduce(torch.ones_like(piece), piece, pr * pc, PLUS)
        total = comm.psum(counts, g, comm.WORLD)
        heavy = total.to(torch.float32) > heavy_frac * torch.clamp(
            total.sum(), min=1).to(torch.float32)
        is_heavy = heavy[piece.clamp(0, pr * pc - 1).long()] & \
            (gi != SENTINEL)
        # heavy entries: broadcast to all (all_gather over the grid),
        # owners filter; my piece is j * pr + i (layout 'col')
        hg = torch.where(is_heavy, gi, sentinel_like(gi))
        hg_all = comm.all_gather(hg, g, comm.WORLD, tiled=True)
        hv_all = comm.all_gather(gv, g, comm.WORLD, tiled=True)
        mine = (hg_all != SENTINEL) & (hg_all // vb == g.j * pr + g.i)
        mine_extra = (torch.where(mine, hg_all % vb, sentinel_like(gi)),
                      hv_all)
        gi = torch.where(is_heavy, sentinel_like(gi), gi)  # light path only
    lidx, (lval,), ok = route_to_pieces(
        gi, (gv,), (torch.zeros((), dtype=gv.dtype).item(),),
        n=n, grid=(pr, pc), cap=route_cap)
    d = v.data.reshape((-1,) + tuple(v.data.shape[3:]))
    if mine_extra is not None:
        # the heavy entries after the light ones: this order decides an
        # overwrite (add=None) with duplicate targets
        lidx = torch.cat([lidx, mine_extra[0]])
        lval = torch.cat([lval, mine_extra[1]])
    nd = d.shape[0]
    if add is None:
        # padding writes a spare slot past the end (JAX's mode='drop')
        out = torch.cat([d, d[:1]])
        out[torch.where(lidx != SENTINEL, lidx, nd).long()] = \
            lval.to(d.dtype)
        d = out[:nd]
    else:
        # duplicates merged under the monoid, then REPLACE (CombBLAS
        # assign semantics) or accumulate into the existing value
        ids = torch.where(lidx != SENTINEL, lidx, nd)
        upd = segment_reduce(lval, ids, nd, add)
        touched = segment_reduce(torch.ones_like(ids), ids, nd, PLUS) > 0
        d = torch.where(touched, add.op(d, upd) if accumulate else upd, d)
    return DistVec(d[None, None], v.n, v.grid, v.layout), ok.reshape(1, 1)


def extract(v: DistVec, gidx: torch.Tensor, *, mesh: Grid,
            route_cap: int | None = None):
    """w[s] = v[gidx[s]] (distributed gather). Returns (vals, ok[pr, pc]).

    gidx: (pr, pc, cap) request lists (global indices, SENTINEL padding);
    result vals aligned with gidx slots, 0 where a request went unanswered.
    Requests are routed to owners with provenance (src rank + slot),
    answered, and routed back: 4 all-to-alls on √p communicators.
    """
    del mesh
    assert v.layout == "col"
    pr, pc = v.grid
    g = comm.of(v.grid)
    cap = gidx.shape[-1]
    route_cap = _route_cap(route_cap, cap, v.grid)
    n, vb = v.n, v.vb
    dev = gidx.device
    gi = gidx.reshape(-1)
    d = v.data.reshape(-1)
    src = g.rank                              # row-major rank i * pc + j
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    lidx, (src_r, slot_r), ok1 = route_to_pieces(
        gi, (torch.full((cap,), src, dtype=torch.int32, device=dev), slots),
        (pr * pc, cap), n=n, grid=(pr, pc), cap=route_cap)
    ans = d[lidx.clamp(0, vb - 1).long()]
    # route answers back: destination = src rank (row-major i*pc+j)
    valid = lidx != SENTINEL
    back_i = torch.where(valid, src_r // pc, pr)
    back_j = torch.where(valid, src_r % pc, pc)
    zero = torch.zeros((), dtype=ans.dtype).item()
    (s1, bj1, a1), okb1 = _bucketize(
        back_i, (slot_r, back_j, ans), pr, route_cap // pr, (cap, pc, zero))
    s1, bj1, a1 = comm.all_to_all_fields([s1, bj1, a1], g, "row")
    bj1 = torch.where(s1 != cap, bj1, pc)
    (s2, a2), okb2 = _bucketize(bj1, (s1, a1), pc, route_cap // pc,
                                (cap, zero))
    s2, a2 = comm.all_to_all_fields([s2, a2], g, "col")
    out = torch.zeros(cap + 1, dtype=ans.dtype, device=dev)
    out[torch.where(s2 != cap, s2, cap).long()] = a2   # spare slot: dropped
    return out[:cap][None, None], (ok1 & okb1 & okb2).reshape(1, 1)
