"""Capacity-padded local sparse matrix (CombBLAS local SpMat analogue).

The port keeps ``repro``'s tile layout, so the planner's retry loop and the
parity tests read the same fields:

    COO(row[i32 cap], col[i32 cap], val[cap, *vdims], nnz[i32 scalar])

Canonical padding: entries at positions >= nnz hold ``row = col = SENTINEL``
and ``val = fill`` (the caller's semiring zero). SENTINEL sorts *after* all
real indices, so sorted tiles stay sorted under padding.

Column ranges are found by binary search over the sorted ``col`` array
(``column_range``) — an O(nnz)-storage DCSC analogue, no O(n) pointers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .semiring import Monoid, scatter_onto_identity, segment_reduce

SENTINEL = 2**31 - 1


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU, and raises when
    there is none (entry points never fall back to the CPU silently)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "port on the CPU")
        device = "cuda"
    return torch.device(device)


def _vmask(m: torch.Tensor, vdims) -> torch.Tensor:
    """Broadcast a per-entry mask over the value dims."""
    return m.reshape((-1,) + (1,) * len(vdims))


def sentinel_like(x: torch.Tensor) -> torch.Tensor:
    """A 0-d int32 SENTINEL on ``x``'s device (for ``torch.where``)."""
    return torch.tensor(SENTINEL, dtype=torch.int32, device=x.device)


def first_present(present: torch.Tensor, cap: int):
    """Flat positions of the first ``cap`` True entries of the 1-d
    ``present``, in order, padded with -1 (``jnp.nonzero(size=cap)``), and
    their count ``min(sum(present), cap)`` as an int32 scalar. A prefix sum
    places each entry, so nothing is read back to the host."""
    dev = present.device
    pos = torch.cumsum(present, 0) - 1
    keep = present & (pos < cap)
    tgt = torch.where(keep, pos, cap)           # the rest: a spare slot
    out = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    out[tgt] = torch.arange(present.shape[0], device=dev)
    nnz = torch.clamp(present.sum(), max=cap).to(torch.int32)
    return out[:cap], nnz


@dataclasses.dataclass(frozen=True)
class COO:
    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    nnz: torch.Tensor                # int32 scalar, actual entry count
    shape: tuple[int, int]
    order: str = "none"
    # order in {'none', 'row' (row-major: sorted by (row, col)),
    #           'col' (col-major: sorted by (col, row))}

    @property
    def cap(self) -> int:
        return self.row.shape[0]

    @property
    def vdims(self) -> tuple[int, ...]:
        return tuple(self.val.shape[1:])

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.row.device

    def mask(self) -> torch.Tensor:
        return torch.arange(self.cap, dtype=torch.int32,
                            device=self.device) < self.nnz

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def empty(shape, cap, dtype=torch.float32, vdims=(), fill=0, order="row",
              device=None) -> "COO":
        device = resolve_device(device)
        return COO(
            row=torch.full((cap,), SENTINEL, dtype=torch.int32, device=device),
            col=torch.full((cap,), SENTINEL, dtype=torch.int32, device=device),
            val=torch.full((cap,) + tuple(vdims), fill, dtype=dtype,
                           device=device),
            nnz=torch.zeros((), dtype=torch.int32, device=device),
            shape=tuple(shape), order=order)

    @staticmethod
    def from_entries(shape, row, col, val, cap=None, nnz=None, fill=0,
                     order="none", device=None) -> "COO":
        """Build from (possibly unpadded) entry arrays; pads to ``cap``."""
        device = resolve_device(device)
        row = torch.as_tensor(row, device=device).to(torch.int32)
        col = torch.as_tensor(col, device=device).to(torch.int32)
        val = torch.as_tensor(val, device=device)
        n = row.shape[0]
        cap = int(cap if cap is not None else n)
        nnz = torch.tensor(n if nnz is None else int(nnz), dtype=torch.int32,
                           device=device)
        pad = cap - n
        if pad < 0:
            raise ValueError(f"cap {cap} < entries {n}")
        if pad:
            row = torch.cat([row, row.new_full((pad,), SENTINEL)])
            col = torch.cat([col, col.new_full((pad,), SENTINEL)])
            val = torch.cat([val, val.new_full((pad,) + tuple(val.shape[1:]),
                                               fill)])
        return COO(row, col, val, nnz, tuple(shape), order).canonicalize(fill)

    @staticmethod
    def from_numpy(row, col, val, nnz, shape, order="none",
                   device=None) -> "COO":
        """A tile from host arrays taken verbatim, padding included — e.g.
        the arrays of a ``repro`` COO, so both packages compute on the same
        tile."""
        dev = resolve_device(device)
        return COO(torch.tensor(np.asarray(row, np.int32), device=dev),
                   torch.tensor(np.asarray(col, np.int32), device=dev),
                   torch.tensor(np.asarray(val), device=dev),
                   torch.tensor(int(np.asarray(nnz)), dtype=torch.int32,
                                device=dev),
                   (int(shape[0]), int(shape[1])), order)

    @staticmethod
    def from_dense(dense: torch.Tensor, cap: int, zero=0,
                   order="row") -> "COO":
        """The first ``cap`` entries of ``dense`` that differ from ``zero``,
        row-major, SENTINEL-padded, ``nnz = min(count, cap)``. A vector-valued
        tile (m, n, *vdims) counts an entry present where any element differs
        from ``zero``. For ``order='col'`` the same entries are sorted
        col-major, so the tile matches its tag (the JAX package tags them
        'col' in row-major order)."""
        m, n = dense.shape[:2]
        vdims = tuple(dense.shape[2:])
        present = dense != zero
        if vdims:
            present = present.reshape(m, n, -1).any(dim=-1)
        lin, nnz = first_present(present.reshape(-1), cap)
        live = lin >= 0
        src = lin.clamp(min=0)
        s = sentinel_like(lin)
        row = torch.where(live, (src // n).to(torch.int32), s)
        col = torch.where(live, (src % n).to(torch.int32), s)
        val = torch.where(_vmask(live, vdims),
                          dense.reshape((m * n,) + vdims)[src],
                          torch.tensor(zero, dtype=dense.dtype,
                                       device=dense.device))
        shape = (int(m), int(n))
        if order == "col":
            return COO(row, col, val, nnz, shape, "none").sort("col")
        return COO(row, col, val, nnz, shape, order)

    # ------------------------------------------------------------------
    # canonicalization / sorting / dedup
    # ------------------------------------------------------------------
    def canonicalize(self, fill=0) -> "COO":
        """Force padding entries to the canonical (SENTINEL, SENTINEL, fill)."""
        m = self.mask()
        s = sentinel_like(self.row)
        return COO(torch.where(m, self.row, s), torch.where(m, self.col, s),
                   torch.where(_vmask(m, self.vdims), self.val,
                               torch.tensor(fill, dtype=self.dtype,
                                            device=self.device)),
                   self.nnz, self.shape, self.order)

    def sort(self, order: str = "row") -> "COO":
        """Lexicographic sort by (row, col) ['row'] or (col, row) ['col']:
        packed single-key argsort + one gather (the merge engine)."""
        from .merge import sort_packed
        return sort_packed(self, order)

    def dedup(self, add: Monoid, order: str = "row") -> "COO":
        """Merge duplicate (row, col) entries with the add monoid (the merge
        engine: sort-free run reduction when the order tag already matches)."""
        from .merge import dedup as _dedup
        return _dedup(self, add, order)

    def dedup_sorted(self, add: Monoid) -> "COO":
        """Sort-free dedup for tiles already carrying an order tag."""
        from .merge import dedup_sorted as _dedup_sorted
        return _dedup_sorted(self, add)

    # ------------------------------------------------------------------
    # conversions / elementwise
    # ------------------------------------------------------------------
    def to_dense(self, zero=0) -> torch.Tensor:
        m, n = self.shape
        out = torch.full((m + 1, n + 1) + self.vdims, zero, dtype=self.dtype,
                         device=self.device)
        # SENTINEL coordinates land in the spare last row/column (dropped)
        out[self.row.long().clamp(max=m), self.col.long().clamp(max=n)] = \
            self.val
        return out[:m, :n]

    def to_dense_add(self, add: Monoid) -> torch.Tensor:
        """Dense with duplicate merging (for non-canonical tiles): entries
        combine onto an identity-filled tile, as JAX's ``.at[].add/min/max``;
        tagged monoids on the segmented-reduce kernel, others through a
        dedup."""
        m, n = self.shape
        if add.tag not in ("sum", "min", "max"):
            return self.dedup(add).to_dense(add.identity)
        inside = (self.row >= 0) & (self.row < m) & (self.col >= 0) \
            & (self.col < n)
        ids = torch.where(inside, self.row.long() * n + self.col.long(), -1)
        flat = scatter_onto_identity(self.val, ids, m * n, add)
        return flat.reshape((m, n) + self.vdims)

    def transpose(self) -> "COO":
        # (row, col)-sorted becomes (col, row)-sorted in the new coordinates
        order = {"row": "col", "col": "row"}.get(self.order, "none")
        return COO(self.col, self.row, self.val, self.nnz,
                   (self.shape[1], self.shape[0]), order)

    def apply(self, fn) -> "COO":
        """Elementwise apply on stored values (GraphBLAS apply)."""
        return dataclasses.replace(self, val=torch.where(
            _vmask(self.mask(), self.vdims), fn(self.val), self.val))

    def prune(self, keep_fn, fill=0) -> "COO":
        """Drop stored entries where ``keep_fn(val)`` is False (GraphBLAS
        select). Stable compaction keeps surviving entries in order."""
        keep = keep_fn(self.val) & self.mask()
        order = torch.argsort((~keep).to(torch.uint8), stable=True)
        k = keep[order]
        s = sentinel_like(self.row)
        val = torch.where(_vmask(k, self.vdims), self.val[order],
                          torch.tensor(fill, dtype=self.dtype,
                                       device=self.device))
        return COO(torch.where(k, self.row[order], s),
                   torch.where(k, self.col[order], s), val,
                   keep.sum(dtype=torch.int32), self.shape, self.order)

    def reduce(self, axis: int, add: Monoid) -> torch.Tensor:
        """Row (axis=1) or column (axis=0) reduction to a dense vector."""
        ids = self.row if axis == 1 else self.col
        n_out = self.shape[0] if axis == 1 else self.shape[1]
        ids = torch.where(self.mask(), ids,
                          torch.tensor(n_out, dtype=ids.dtype,
                                       device=ids.device))
        return segment_reduce(self.val, ids, n_out, add)

    def scale_rows(self, d: torch.Tensor, mul=torch.mul) -> "COO":
        """val[k] = mul(val[k], d[row[k]]) on stored entries."""
        return self._scale(d, self.row, self.shape[0], mul)

    def scale_cols(self, d: torch.Tensor, mul=torch.mul) -> "COO":
        """val[k] = mul(val[k], d[col[k]]) on stored entries."""
        return self._scale(d, self.col, self.shape[1], mul)

    def _scale(self, d, idx, n, mul) -> "COO":
        newv = mul(self.val, d[idx.long().clamp(0, n - 1)])
        return dataclasses.replace(self, val=torch.where(
            _vmask(self.mask(), self.vdims), newv, self.val))

    def with_cap(self, cap: int, fill=0) -> "COO":
        """Grow (or shrink, keeping first entries) capacity."""
        if cap == self.cap:
            return self
        if cap > self.cap:
            pad = cap - self.cap
            return COO(
                torch.cat([self.row, self.row.new_full((pad,), SENTINEL)]),
                torch.cat([self.col, self.col.new_full((pad,), SENTINEL)]),
                torch.cat([self.val,
                           self.val.new_full((pad,) + self.vdims, fill)]),
                self.nnz, self.shape, self.order)
        return COO(self.row[:cap], self.col[:cap], self.val[:cap],
                   torch.clamp(self.nnz, max=cap), self.shape, self.order)


def column_range(sorted_cols: torch.Tensor, k: torch.Tensor):
    """(start, end) of column ``k`` in a col-major-sorted index array.

    O(log cap) per query, O(nnz) storage — the DCSC analogue (no O(n)
    pointer array). ``k`` may be an array of queries.
    """
    start = torch.searchsorted(sorted_cols, k, out_int32=True)
    end = torch.searchsorted(sorted_cols, k, right=True, out_int32=True)
    return start, end


def row_range(sorted_rows: torch.Tensor, i: torch.Tensor):
    return column_range(sorted_rows, i)


def ewise_union(a: COO, b: COO, add: Monoid, cap: int | None = None) -> COO:
    """C = A ⊕ B (entries present in either; add where both): both operands
    row-sort (free under the 'row' invariant) and interleave by the
    rank-placement merge, no concat-and-sort of the combined stream."""
    assert a.shape == b.shape
    from .merge import merge_sorted
    cap = cap or (a.cap + b.cap)
    return merge_sorted(a, b, add).with_cap(cap, add.identity)


def ewise_intersect(a: COO, b: COO, mul, out_cap: int | None = None,
                    zero=0) -> COO:
    """C = A ⊗ B on the intersection pattern (A .* B)."""
    assert a.shape == b.shape
    sa, sb = a.sort("row"), b.sort("row")
    out_cap = out_cap or min(a.cap, b.cap)
    # pair keys are encoded in 32 bits: the CombBLAS "local indices are
    # 32-bit" contract, which tiles after a 2D/3D decomposition satisfy
    m, n = a.shape
    if (m + 1) * (n + 1) >= 2**31:
        raise ValueError("local tile exceeds 32-bit key space; "
                         "increase the process grid (paper §1, local indices)")
    s = sentinel_like(sa.row)
    ka = torch.where(sa.mask(), sa.row * (n + 1) + sa.col.clamp(max=n), s)
    kb = torch.where(sb.mask(), sb.row * (n + 1) + sb.col.clamp(max=n), s)
    # mark a-entries that also appear in b: binary search b's (row, col)
    posc = torch.searchsorted(kb, ka).clamp(0, b.cap - 1)
    hit = (kb[posc] == ka) & sa.mask() & (posc < sb.nnz)
    val = mul(sa.val, sb.val[posc])
    val = torch.where(_vmask(hit, val.shape[1:]), val,
                      torch.tensor(zero, dtype=val.dtype, device=val.device))
    # compact kept entries to the front; stable, so the row-major order of
    # sa survives and the result keeps the 'row' tag
    order = torch.argsort((~hit).to(torch.uint8), stable=True)
    out = COO(torch.where(hit, sa.row, s)[order],
              torch.where(hit, sa.col, s)[order], val[order],
              hit.sum(dtype=torch.int32), a.shape, "row")
    return out.with_cap(out_cap, zero)
