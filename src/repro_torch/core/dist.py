"""Distributed sparse matrix container (SpParMat analogue) and its grid.

Data model (DESIGN.md §3): a distributed matrix stores each field as ONE
tensor whose leading dims are the process-grid dims:

  DistSpMat  : row/col/val/nnz with shapes (pr, pc, cap …)
  DistVec    : data (pr, pc, vb)            — fully distributed dense vector
  DistSpVec  : idx/val (pr, pc, cap), nnz (pr, pc) — sparse vector

Index discipline (paper §1, two index types): global indices are int64 and
live ONLY on the host (numpy) during assembly/extraction; device-resident
indices are tile-local int32.

Load balance (paper §2.3/§6): ``random_permute=True`` at assembly applies a
seeded random row+column permutation — CombBLAS's standard trick.

This slice of the port runs the 1x1 grid only: a grid of several processes
needs the ``torch.distributed`` slice (ROADMAP.md, modules to port).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..obs import recorder as _obs
from .coo import COO, SENTINEL, resolve_device


def _ceil(a, b):
    return -(-a // b)


def _check_grid(pr: int, pc: int) -> None:
    if pr * pc != 1:
        raise NotImplementedError(
            f"a {pr}x{pc} grid needs the torch.distributed slice of the port "
            "(ROADMAP.md); this slice runs the 1x1 grid only")


@dataclasses.dataclass(frozen=True)
class Grid:
    """Process grid for sparse ops: ``pr`` x ``pc`` ranks on ``device``."""

    pr: int
    pc: int
    device: torch.device


def make_grid(pr: int, pc: int, *, device=None) -> Grid:
    """Process grid for sparse ops (the JAX package's mesh)."""
    _check_grid(pr, pc)
    return Grid(pr, pc, resolve_device(device))


@dataclasses.dataclass(frozen=True)
class DistSpMat:
    """2D-distributed sparse matrix on a (pr, pc) grid.

    Tile (i, j) covers global rows [i*mb, (i+1)*mb) × cols [j*nb, (j+1)*nb)
    with mb = vbm*pc and nb = vbn*pr (padded so the superimposed vector
    pieces align).
    """

    row: torch.Tensor   # (pr, pc, cap) int32, tile-local row index
    col: torch.Tensor   # (pr, pc, cap) int32, tile-local col index
    val: torch.Tensor   # (pr, pc, cap, *vdims)
    nnz: torch.Tensor   # (pr, pc) int32
    shape: tuple[int, int]
    grid: tuple[int, int]
    # per-tile entry order, same vocabulary as COO.order. 'row' is the
    # maintained invariant: assembly sorts tiles row-major and every core op
    # either preserves it or re-establishes it via dedup (DESIGN.md §4.3).
    order: str = "none"

    def __post_init__(self):
        _check_grid(*self.grid)

    @property
    def pr(self):
        return self.grid[0]

    @property
    def pc(self):
        return self.grid[1]

    @property
    def cap(self):
        return self.row.shape[-1]

    @property
    def mb(self):
        return _ceil(self.shape[0], self.pr * self.pc) * self.pc

    @property
    def nb(self):
        return _ceil(self.shape[1], self.pr * self.pc) * self.pr

    def tile(self) -> COO:
        """The local COO view (the 1x1 grid's one tile)."""
        return COO(self.row.reshape(self.cap), self.col.reshape(self.cap),
                   self.val.reshape((self.cap,) + tuple(self.val.shape[3:])),
                   self.nnz.reshape(()), (self.mb, self.nb), self.order)

    @staticmethod
    def from_tile(t: COO, shape, grid) -> "DistSpMat":
        """Wrap the 1x1 grid's one tile back into a DistSpMat."""
        return DistSpMat(t.row[None, None], t.col[None, None],
                         t.val[None, None], t.nnz.reshape(1, 1),
                         tuple(shape), tuple(grid), order=t.order)

    # ---------------- host-side assembly / extraction ----------------
    @staticmethod
    @_obs.timed("dist.assemble")
    def from_global_coo(shape, rows, cols, vals, grid, *, mesh: Grid = None,
                        device=None, cap: int | None = None,
                        pad: float = 1.25, random_permute: bool = False,
                        seed: int = 0, vdims=(), order: str = "row"):
        """Assemble from global int64 COO (host-side numpy).

        The tiles land on ``mesh.device`` (else ``device``; the GPU by
        default). ``order`` picks the per-tile entry sort — ``'row'`` (the
        maintained invariant) or ``'col'``.
        """
        M, N = shape
        pr, pc = grid
        _check_grid(pr, pc)
        if order not in ("row", "col"):
            raise ValueError(f"order must be 'row' or 'col', got {order!r}")
        dev = mesh.device if mesh is not None else resolve_device(device)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        if random_permute:
            rng = np.random.default_rng(seed)
            rp = rng.permutation(M).astype(np.int64)
            cp = rp if M == N else rng.permutation(N).astype(np.int64)
            rows, cols = rp[rows], cp[cols]
        mb = _ceil(M, pr * pc) * pc
        nb = _ceil(N, pr * pc) * pr
        ti, tj = rows // mb, cols // nb
        lr = (rows % mb).astype(np.int32)
        lc = (cols % nb).astype(np.int32)
        tid = ti * pc + tj
        within_keys = (lc, lr) if order == "row" else (lr, lc)
        perm = np.lexsort(within_keys + (tid,))
        tid, lr, lc, vals_s = tid[perm], lr[perm], lc[perm], vals[perm]
        counts = np.bincount(tid, minlength=pr * pc)
        if cap is None:
            cap = max(8, int(math.ceil(counts.max() * pad / 8) * 8)) \
                if len(rows) else 8
        if counts.max() > cap:
            raise ValueError(f"tile overflow: max nnz {counts.max()} > cap {cap}")
        starts = np.zeros(pr * pc, np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        R = np.full((pr * pc, cap), SENTINEL, np.int32)
        Cc = np.full((pr * pc, cap), SENTINEL, np.int32)
        V = np.zeros((pr * pc, cap) + tuple(vdims), vals.dtype)
        within = np.arange(len(rows)) - starts[tid]
        R[tid, within] = lr
        Cc[tid, within] = lc
        V[tid, within] = vals_s
        return DistSpMat.from_numpy(
            R.reshape(pr, pc, cap), Cc.reshape(pr, pc, cap),
            V.reshape((pr, pc, cap) + tuple(vdims)),
            counts.reshape(pr, pc).astype(np.int32), (int(M), int(N)),
            (pr, pc), order, dev)

    @staticmethod
    def from_numpy(row, col, val, nnz, shape, grid, order, device=None):
        """A DistSpMat from host arrays laid out like the fields — e.g. the
        arrays of a ``repro`` DistSpMat, so both packages compute on the
        same tiles."""
        dev = resolve_device(device)
        return DistSpMat(
            row=torch.tensor(np.asarray(row, np.int32), device=dev),
            col=torch.tensor(np.asarray(col, np.int32), device=dev),
            val=torch.tensor(np.asarray(val), device=dev),
            nnz=torch.tensor(np.asarray(nnz, np.int32), device=dev),
            shape=(int(shape[0]), int(shape[1])),
            grid=(int(grid[0]), int(grid[1])), order=order)

    def to_global_coo(self):
        """Gather to host as (rows, cols, vals) in global int64 coords."""
        pr, pc, cap = self.pr, self.pc, self.cap
        R = self.row.cpu().numpy().reshape(pr, pc, cap)
        C = self.col.cpu().numpy().reshape(pr, pc, cap)
        V = self.val.cpu().numpy().reshape((pr, pc, cap)
                                           + tuple(self.val.shape[3:]))
        Nz = self.nnz.cpu().numpy().reshape(pr, pc)
        rows, cols, vals = [], [], []
        for i in range(pr):
            for j in range(pc):
                k = int(Nz[i, j])
                rows.append(R[i, j, :k].astype(np.int64) + i * self.mb)
                cols.append(C[i, j, :k].astype(np.int64) + j * self.nb)
                vals.append(V[i, j, :k])
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))

    def to_dense(self, zero=0.0) -> np.ndarray:
        r, c, v = self.to_global_coo()
        out = np.full(self.shape + tuple(self.val.shape[3:]), zero, v.dtype)
        out[r, c] = v
        return out


# --------------------------------------------------------------------------
# distributed dense / sparse vectors
# --------------------------------------------------------------------------

def _piece_id(i: int, j: int, grid, layout: str) -> int:
    """Which of the pr*pc pieces grid position (i, j) holds: pieces run down
    the process columns in layout 'col', along the process rows in 'row'."""
    return j * grid[0] + i if layout == "col" else i * grid[1] + j


def _vec_device(mesh: Grid | None, device) -> torch.device:
    return mesh.device if mesh is not None else resolve_device(device)


@dataclasses.dataclass(frozen=True)
class DistVec:
    """Fully distributed dense vector, no replication (paper §2.2)."""

    data: torch.Tensor  # (pr, pc, vb, *vdims)
    n: int
    grid: tuple[int, int]
    layout: str = "col"

    def __post_init__(self):
        _check_grid(*self.grid)

    @property
    def vb(self):
        return self.data.shape[2]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def piece_id(self, i, j):
        return _piece_id(i, j, self.grid, self.layout)

    @staticmethod
    def from_global(x, grid, layout="col", mesh: Grid = None,
                    device=None) -> "DistVec":
        """Split the host vector ``x`` into pieces of vb = ceil(n / (pr*pc))
        (zero-padded past n) on ``mesh.device`` (else ``device``)."""
        pr, pc = grid
        _check_grid(pr, pc)
        x = np.asarray(x)
        n = x.shape[0]
        vb = _ceil(n, pr * pc)
        xp = np.zeros((pr * pc * vb,) + x.shape[1:], x.dtype)
        xp[:n] = x
        pieces = xp.reshape((pr * pc, vb) + x.shape[1:])
        out = np.empty((pr, pc, vb) + x.shape[1:], x.dtype)
        for i in range(pr):
            for j in range(pc):
                out[i, j] = pieces[_piece_id(i, j, grid, layout)]
        return DistVec(torch.from_numpy(out).to(_vec_device(mesh, device)),
                       int(n), (pr, pc), layout)

    def to_global(self) -> np.ndarray:
        pr, pc = self.grid
        d = self.data.cpu().numpy()
        xp = np.empty((pr * pc, self.vb) + d.shape[3:], d.dtype)
        for i in range(pr):
            for j in range(pc):
                xp[self.piece_id(i, j)] = d[i, j]
        return xp.reshape((pr * pc * self.vb,) + d.shape[3:])[:self.n]


@dataclasses.dataclass(frozen=True)
class DistSpVec:
    """Fully distributed sparse vector (FullyDistSpVec): piece-local int32
    indices, SENTINEL-padded past each piece's ``nnz``."""

    idx: torch.Tensor   # (pr, pc, cap) int32, piece-local indices
    val: torch.Tensor   # (pr, pc, cap)
    nnz: torch.Tensor   # (pr, pc) int32
    n: int
    grid: tuple[int, int]
    layout: str = "col"

    def __post_init__(self):
        _check_grid(*self.grid)

    @property
    def cap(self):
        return self.idx.shape[-1]

    @property
    def vb(self):
        pr, pc = self.grid
        return _ceil(self.n, pr * pc)

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @staticmethod
    def from_global(idx, val, n, grid, cap=None, layout="col",
                    mesh: Grid = None, pad=1.5, device=None) -> "DistSpVec":
        """Assemble from global int64 indices and their values (host numpy).
        ``cap`` defaults to ``pad`` × the fullest piece, rounded up to 8;
        a piece above ``cap`` raises ``ValueError('piece overflow')``."""
        pr, pc = grid
        _check_grid(pr, pc)
        idx = np.asarray(idx, np.int64)
        val = np.asarray(val)
        vb = _ceil(n, pr * pc)
        piece = idx // vb
        local = (idx % vb).astype(np.int32)
        counts = np.bincount(piece, minlength=pr * pc)
        if cap is None:
            cap = max(8, int(math.ceil((counts.max() if len(idx) else 1)
                                       * pad / 8) * 8))
        if len(idx) and counts.max() > cap:
            raise ValueError("piece overflow")
        order = np.lexsort((local, piece))
        piece, local, val_s = piece[order], local[order], val[order]
        starts = np.zeros(pr * pc, np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        I = np.full((pr * pc, cap), SENTINEL, np.int32)
        V = np.zeros((pr * pc, cap), val.dtype)
        within = np.arange(len(idx)) - starts[piece]
        I[piece, within] = local
        V[piece, within] = val_s
        Ii = np.empty((pr, pc, cap), np.int32)
        Vv = np.empty((pr, pc, cap), val.dtype)
        Nz = np.empty((pr, pc), np.int32)
        for i in range(pr):
            for j in range(pc):
                k = _piece_id(i, j, grid, layout)
                Ii[i, j], Vv[i, j], Nz[i, j] = I[k], V[k], counts[k]
        dev = _vec_device(mesh, device)
        return DistSpVec(torch.from_numpy(Ii).to(dev),
                         torch.from_numpy(Vv).to(dev),
                         torch.from_numpy(Nz).to(dev), int(n), (pr, pc),
                         layout)

    def to_global(self):
        """(global int64 indices, values) of the stored entries below n."""
        pr, pc = self.grid
        I = self.idx.cpu().numpy()
        V = self.val.cpu().numpy()
        Nz = self.nnz.cpu().numpy()
        idxs, vals = [], []
        for i in range(pr):
            for j in range(pc):
                k = _piece_id(i, j, self.grid, self.layout)
                c = int(Nz[i, j])
                idxs.append(I[i, j, :c].astype(np.int64) + k * self.vb)
                vals.append(V[i, j, :c])
        idx = np.concatenate(idxs)
        val = np.concatenate(vals)
        keep = idx < self.n
        return idx[keep], val[keep]

    def to_global_dense(self, zero=0.0) -> np.ndarray:
        idx, val = self.to_global()
        out = np.full((self.n,), zero, val.dtype)
        out[idx] = val
        return out
