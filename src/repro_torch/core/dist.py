"""Distributed sparse matrix container (SpParMat analogue) and its grid.

Data model (DESIGN.md §3): a distributed matrix stores each field as ONE
tensor whose leading dims are the process-grid dims. In the JAX package
that tensor is global, sharded so each device owns its tile; in the port
every grid position is one process (SPMD, ``core/comm.py``), and a
process's fields are its own shard of JAX's global array:

  DistSpMat  : row/col/val/nnz with shapes (1, 1, cap …) of (pr, pc, cap …)
  DistSpMat3D: (1, 1, 1, cap) of (L, q, q, cap) on a grid of L layers
  DistVec    : data (1, 1, vb)            — fully distributed dense vector
  DistSpVec  : idx/val (1, 1, cap), nnz (1, 1) — sparse vector

``cap`` is one value across the grid, as in JAX, so ``.tile()`` and all
the local code see one tile as on the 1x1 grid.

Index discipline (paper §1, two index types): global indices are int64 and
live ONLY on the host (numpy) during assembly/extraction; device-resident
indices are tile-local int32. Assembly takes the same global COO on every
rank (as JAX's host code does) and each rank keeps its own tile;
extraction gathers every tile's nnz prefix, so every rank gets the same
global arrays.

Load balance (paper §2.3/§6): ``random_permute=True`` at assembly applies a
seeded random row+column permutation — CombBLAS's standard trick.

A grid of several positions needs ``torch.distributed`` initialized with
a rank a position (``make_grid``); the 1x1 grid needs no process group. A
grid may be smaller than the world: it lives on world ranks ``0 .. n-1``
(``core/comm.py``), and ``regrid`` moves a matrix onto such a grid in the
same world (an elastic shrink) or back onto a larger one (a grow).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..obs import recorder as _obs
from ..robust import audit as _audit, faults as _faults
from . import comm
from .coo import COO, SENTINEL, resolve_device


def _ceil(a, b):
    return -(-a // b)


def _check_grid(*grid) -> comm.GridComm:
    """This process's place in a ``(pr, pc)`` or ``(L, pr, pc)`` grid; a
    grid of several positions raises ``RuntimeError`` unless the world has
    a rank for each and this rank holds one (no tile lives off the
    grid)."""
    g = comm.of(grid)
    if not g.member:
        raise RuntimeError(
            f"rank {g.rank} holds no position of the "
            f"{'x'.join(map(str, grid))} grid (its ranks are 0 .. "
            f"{comm.positions(grid) - 1}): no tile lives here")
    return g


@dataclasses.dataclass(frozen=True)
class Grid:
    """Process grid for sparse ops: ``layers`` x ``pr`` x ``pc`` ranks, this
    process's tensors on ``device``."""

    pr: int
    pc: int
    device: torch.device
    layers: int = 1


def make_grid(pr: int, pc: int, layers: int = 1, *, device=None) -> Grid:
    """Process grid for sparse ops (the JAX package's mesh): axes
    ('row', 'col'), or ('layer', 'row', 'col') with ``layers`` > 1.

    A grid of several positions needs ``torch.distributed`` initialized
    with at least ``layers * pr * pc`` ranks; every rank of the world calls
    ``make_grid`` (it creates the row, column and layer groups, a
    collective), and rank r below the grid's positions is grid position
    ``(l, i, j)``, row-major (``divmod(rank, pc)`` on one layer), as the
    JAX package's mesh takes the first devices. A rank past them gets the
    grid's handle but holds no tile (``comm.holds``). The device is
    ``cuda:(rank % device_count)`` unless the caller asks for another
    (``device='cpu'``).
    """
    g = comm.of((layers, pr, pc))
    if device is None and layers * pr * pc > 1 and torch.cuda.is_available():
        device = f"cuda:{g.rank % torch.cuda.device_count()}"
    return Grid(pr, pc, resolve_device(device), layers)


def grid_all(ok: torch.Tensor, grid) -> bool:
    """``bool(jnp.all(ok))`` of the global flags of a 2-D or 3-D grid: the
    same answer on every rank, so every rank takes the same branch."""
    return bool(comm.gather_grid(ok.all().reshape(1), grid).all())


def grid_sum(x: torch.Tensor, grid) -> torch.Tensor:
    """``jnp.sum`` of the global array whose shard is ``x``, the same bits
    on every rank."""
    return comm.psum(x.sum().reshape(1), comm.of(grid),
                     comm.WORLD).reshape(())


@dataclasses.dataclass(frozen=True)
class DistSpMat:
    """2D-distributed sparse matrix on a (pr, pc) grid.

    Tile (i, j) covers global rows [i*mb, (i+1)*mb) × cols [j*nb, (j+1)*nb)
    with mb = vbm*pc and nb = vbn*pr (padded so the superimposed vector
    pieces align).
    """

    row: torch.Tensor   # (1, 1, cap) int32, tile-local row index
    col: torch.Tensor   # (1, 1, cap) int32, tile-local col index
    val: torch.Tensor   # (1, 1, cap, *vdims)
    nnz: torch.Tensor   # (1, 1) int32
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
        """This process's tile as a local COO."""
        return COO(self.row.reshape(self.cap), self.col.reshape(self.cap),
                   self.val.reshape((self.cap,) + tuple(self.val.shape[3:])),
                   self.nnz.reshape(()), (self.mb, self.nb), self.order)

    @staticmethod
    def from_tile(t: COO, shape, grid) -> "DistSpMat":
        """Wrap this process's tile back into a DistSpMat."""
        return DistSpMat(t.row[None, None], t.col[None, None],
                         t.val[None, None], t.nnz.reshape(1, 1),
                         tuple(shape), tuple(grid), order=t.order)

    def host_nnz(self) -> np.ndarray:
        """Every tile's nnz as a host (pr, pc) array, the same on every
        rank (the JAX package's ``device_get(a.nnz)``)."""
        return comm.gather_grid(self.nnz.reshape(()), self.grid)

    @property
    def total_nnz(self) -> torch.Tensor:
        return grid_sum(self.nnz, self.grid)

    # ---------------- host-side assembly / extraction ----------------
    @staticmethod
    @_obs.timed("dist.assemble")
    def from_global_coo(shape, rows, cols, vals, grid, *, mesh: Grid = None,
                        device=None, cap: int | None = None,
                        pad: float = 1.25, random_permute: bool = False,
                        seed: int = 0, vdims=(), order: str = "row"):
        """Assemble from global int64 COO (host-side numpy), the same on
        every rank; each rank keeps its own tile.

        The tiles land on ``mesh.device`` (else ``device``; the GPU by
        default). ``order`` picks the per-tile entry sort — ``'row'`` (the
        maintained invariant) or ``'col'``. ``cap`` defaults to ``pad`` x
        the fullest tile of the grid, rounded up to 8.
        """
        M, N = shape
        pr, pc = grid
        g = _check_grid(pr, pc)
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
        tid = (rows // mb) * pc + cols // nb
        counts = np.bincount(tid, minlength=pr * pc)
        if cap is None:
            cap = max(8, int(math.ceil(counts.max() * pad / 8) * 8)) \
                if len(rows) else 8
        if counts.max() > cap:
            raise ValueError(f"tile overflow: max nnz {counts.max()} > cap {cap}")
        all_counts = counts
        if pr * pc > 1:
            # this rank's entries only, before any sort
            mine = tid == g.rank
            rows, cols, vals = rows[mine], cols[mine], vals[mine]
            tid = np.zeros(len(rows), np.int64)
            counts = counts[g.rank:g.rank + 1]
        lr = (rows % mb).astype(np.int32)
        lc = (cols % nb).astype(np.int32)
        # this rank keeps one tile (tid is 0 throughout): its entries by
        # (row, col), or (col, row), stably, as np.lexsort orders them, but
        # in one sort of one int64 key (local indices are below 2^31)
        major, minor, width = (lr, lc, nb) if order == "row" else \
            (lc, lr, mb)
        perm = np.argsort(major.astype(np.int64) * width + minor,
                          kind="stable")
        tid, lr, lc, vals_s = tid[perm], lr[perm], lc[perm], vals[perm]
        ntile = len(counts)
        starts = np.zeros(ntile, np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        R = np.full((ntile, cap), SENTINEL, np.int32)
        Cc = np.full((ntile, cap), SENTINEL, np.int32)
        V = np.zeros((ntile, cap) + tuple(vdims), vals.dtype)
        within = np.arange(len(rows)) - starts[tid]
        R[tid, within] = lr
        Cc[tid, within] = lc
        V[tid, within] = vals_s
        out = DistSpMat._local(
            R.reshape(1, 1, cap), Cc.reshape(1, 1, cap),
            V.reshape((1, 1, cap) + tuple(vdims)),
            counts.reshape(1, 1).astype(np.int32), (int(M), int(N)),
            (pr, pc), order, dev)
        # every rank holds every tile's count: the fault's tile draw needs
        # no gather
        out = _faults.corrupt_spmat("dist.assemble", out, nnz=all_counts)
        _audit.audit_obj(out, "dist.assemble", min_level=_audit.FULL)
        return out

    @staticmethod
    def _local(row, col, val, nnz, shape, grid, order, dev):
        return DistSpMat(
            row=torch.tensor(np.asarray(row, np.int32), device=dev),
            col=torch.tensor(np.asarray(col, np.int32), device=dev),
            val=torch.tensor(np.asarray(val), device=dev),
            nnz=torch.tensor(np.asarray(nnz, np.int32), device=dev),
            shape=(int(shape[0]), int(shape[1])),
            grid=(int(grid[0]), int(grid[1])), order=order)

    @staticmethod
    def from_numpy(row, col, val, nnz, shape, grid, order, device=None):
        """A DistSpMat from host arrays laid out like the JAX package's
        global fields (leading dims (pr, pc)) — e.g. the arrays of a
        ``repro`` DistSpMat, so both packages compute on the same tiles.
        Each rank keeps its own tile."""
        g = _check_grid(*grid)
        sl = (slice(g.i, g.i + 1), slice(g.j, g.j + 1))
        return DistSpMat._local(
            np.asarray(row)[sl], np.asarray(col)[sl], np.asarray(val)[sl],
            np.asarray(nnz)[sl], shape, grid, order, resolve_device(device))

    def to_global_coo(self):
        """Gather to host as (rows, cols, vals) in global int64 coords, the
        same on every rank. Only each tile's nnz prefix crosses the wire."""
        pr, pc = self.grid
        t = self.tile()
        cnt, (R, C, V) = comm.gather_prefixes(
            (t.row, t.col, t.val), int(t.nnz), self.grid)
        rows, cols, vals = [], [], []
        for i in range(pr):
            for j in range(pc):
                k = int(cnt[i * pc + j])
                rows.append(R[i * pc + j, :k].astype(np.int64) + i * self.mb)
                cols.append(C[i * pc + j, :k].astype(np.int64) + j * self.nb)
                vals.append(V[i * pc + j, :k])
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))

    @_obs.timed("dist.regrid")
    def regrid(self, grid, *, mesh: Grid = None, cap: int | None = None,
               pad: float = 1.25) -> "DistSpMat | None":
        """Re-distribute onto a new process grid (elastic shrink/grow).

        Round-trips through global COO and the normal assembly path, as
        the JAX package does, so entry values are bit-identical, the
        ``order`` tag is preserved ('none' tightens to 'row' — assembly
        sorts anyway), and the tile capacity is re-planned for the new
        tiling unless ``cap`` is given. The tiles land on ``mesh.device``.

        A grid position is a process, so the new grid is world ranks ``0
        .. n-1`` (``core/comm.py``). The call is collective over every rank
        of the larger of the two grids: every rank of the world first
        creates the new grid's groups (``comm.of``, collective over the
        world, so a rank outside both grids calls ``comm.of(grid)``
        alone), then the old grid's ranks gather the global COO.

        - Shrink: a rank the new grid leaves out gets ``None`` (it
          retires); the others get their tile.
        - Grow: a rank that holds no position of the old grid calls
          :meth:`join` instead (a rank holding a 1x1 copy of its own may
          call ``regrid``: only rank 0's is read); rank 0 broadcasts the
          global COO over the new grid, and every rank of it gets its tile.
        """
        return _regrid(self, grid, mesh=mesh, cap=cap, pad=pad)

    @staticmethod
    @_obs.timed("dist.regrid")
    def join(grid, *, mesh: Grid = None, cap: int | None = None,
             pad: float = 1.25) -> "DistSpMat":
        """:meth:`regrid`'s partner on a rank that holds no position of the
        old grid, in a grow: its tile of the new grid, assembled from the
        global COO rank 0 broadcasts."""
        return _regrid(None, grid, mesh=mesh, cap=cap, pad=pad)

    def to_dense(self, zero=0.0) -> np.ndarray:
        r, c, v = self.to_global_coo()
        out = np.full(self.shape + tuple(self.val.shape[3:]), zero, v.dtype)
        out[r, c] = v
        return out


# --------------------------------------------------------------------------
# 3D (communication-avoiding) distributed sparse matrix
# --------------------------------------------------------------------------

def _pad_to(n, mult):
    return _ceil(n, mult) * mult


@dataclasses.dataclass(frozen=True)
class DistSpMat3D:
    """Sparse matrix on an (L, q, q) grid (paper §3.2, Fig 1).

    dist='acol': input-A style — columns sliced into L outer slabs; layer l
                 holds slab l as a 2D (q×q) matrix.
    dist='brow': input-B style — rows sliced into L outer slabs.
    dist='csub': output style (Fig 2) — within each column block j, columns
                 are sub-sliced into L pieces; layer l holds sub-piece l.

    This process holds tile ``(l, i, j)``: fields of shape (1, 1, 1, cap).
    """

    row: torch.Tensor   # (1, 1, 1, cap) int32
    col: torch.Tensor
    val: torch.Tensor
    nnz: torch.Tensor   # (1, 1, 1) int32
    shape: tuple[int, int]
    grid: tuple[int, int, int]
    dist: str
    order: str = "none"

    def __post_init__(self):
        _check_grid(*self.grid)

    @property
    def L(self):
        return self.grid[0]

    @property
    def q(self):
        return self.grid[1]

    @property
    def cap(self):
        return self.row.shape[-1]

    def block_sizes(self):
        """(tile_rows, tile_cols) of each local tile.

        Every dimension is padded to a multiple of L*q*q so that (a) the
        contraction dims of acol-A and brow-B tiles agree and (b) partial-C
        column blocks subdivide exactly L ways for the inter-layer
        all-to-all.
        """
        return _block_sizes(self.shape, self.L, self.q, self.dist)

    def tile(self) -> COO:
        """This process's tile as a local COO."""
        return COO(self.row.reshape(self.cap), self.col.reshape(self.cap),
                   self.val.reshape(self.cap), self.nnz.reshape(()),
                   self.block_sizes(), self.order)

    @staticmethod
    def from_tile(t: COO, shape, grid, dist: str) -> "DistSpMat3D":
        """Wrap this process's tile back into a DistSpMat3D."""
        return DistSpMat3D(t.row.reshape(1, 1, 1, -1),
                           t.col.reshape(1, 1, 1, -1),
                           t.val.reshape(1, 1, 1, -1), t.nnz.reshape(1, 1, 1),
                           tuple(shape), tuple(grid), dist, order=t.order)

    def _global_offsets(self, l, i, j):
        tr, tc = self.block_sizes()
        if self.dist == "acol":
            return i * tr, l * (tc * self.q) + j * tc
        if self.dist == "brow":
            return l * (tr * self.q) + i * tr, j * tc
        if self.dist == "csub":
            return i * tr, j * (tc * self.L) + l * tc
        raise ValueError(self.dist)

    def host_nnz(self) -> np.ndarray:
        """Every tile's nnz as a host (L, q, q) array, the same on every
        rank."""
        return comm.gather_grid(self.nnz.reshape(()), self.grid)

    @staticmethod
    @_obs.timed("dist.assemble3d")
    def from_global_coo(shape, rows, cols, vals, grid, dist, *,
                        mesh: Grid = None, device=None, cap=None, pad=1.25,
                        random_permute=False, seed=0) -> "DistSpMat3D":
        """Assemble from global int64 COO (host numpy), the same on every
        rank; each rank keeps its own tile ``(l, i, j)``, on ``mesh.device``
        (else ``device``; the GPU by default). ``cap`` defaults to ``pad`` x
        the fullest tile of the grid, rounded up to 8."""
        L, q, _ = grid
        M, N = shape
        g = _check_grid(*grid)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        if random_permute:
            rng = np.random.default_rng(seed)
            rp = rng.permutation(M).astype(np.int64)
            cp = rp if M == N else rng.permutation(N).astype(np.int64)
            rows, cols = rp[rows], cp[cols]
        tr, tc = _block_sizes((M, N), L, q, dist)
        if dist == "acol":
            l = cols // (tc * q)
            i, j = rows // tr, (cols % (tc * q)) // tc
            lr, lc = rows % tr, cols % tc
        elif dist == "brow":
            l = rows // (tr * q)
            i, j = (rows % (tr * q)) // tr, cols // tc
            lr, lc = rows % tr, cols % tc
        else:  # csub
            rem = cols % (tc * L)
            l, j = rem // tc, cols // (tc * L)
            i = rows // tr
            lr, lc = rows % tr, rem % tc
        tid = (l * q + i) * q + j
        counts = np.bincount(tid, minlength=L * q * q)
        if cap is None:
            cap = max(8, int(math.ceil((counts.max() if len(rows) else 1)
                                       * pad / 8) * 8))
        if len(rows) and counts.max() > cap:
            raise ValueError(f"tile overflow: {counts.max()} > {cap}")
        # this rank's entries, sorted (row, col) within the tile
        mine = tid == g.rank
        lr = lr[mine].astype(np.int32)
        lc = lc[mine].astype(np.int32)
        vals = vals[mine]
        order = np.argsort(lr.astype(np.int64) * tc + lc,   # lexsort's
                           kind="stable")                      # order
        n = len(order)
        R = np.full((1, 1, 1, cap), SENTINEL, np.int32)
        Cc = np.full((1, 1, 1, cap), SENTINEL, np.int32)
        V = np.zeros((1, 1, 1, cap), vals.dtype)
        R[0, 0, 0, :n] = lr[order]
        Cc[0, 0, 0, :n] = lc[order]
        V[0, 0, 0, :n] = vals[order]
        dev = mesh.device if mesh is not None else resolve_device(device)
        return DistSpMat3D(
            row=torch.from_numpy(R).to(dev), col=torch.from_numpy(Cc).to(dev),
            val=torch.from_numpy(V).to(dev),
            nnz=torch.full((1, 1, 1), n, dtype=torch.int32, device=dev),
            shape=(int(M), int(N)), grid=(L, q, q), dist=dist, order="row")

    def to_global_coo(self):
        """Gather to host as (rows, cols, vals) in global int64 coords, the
        same on every rank. Only each tile's nnz prefix crosses the wire."""
        L, q = self.L, self.q
        t = self.tile()
        cnt, (R, C, V) = comm.gather_prefixes(
            (t.row, t.col, t.val), int(t.nnz), self.grid)
        rows, cols, vals = [], [], []
        for l in range(L):
            for i in range(q):
                for j in range(q):
                    r = (l * q + i) * q + j
                    k = int(cnt[r])
                    ro, co = self._global_offsets(l, i, j)
                    rows.append(R[r, :k].astype(np.int64) + ro)
                    cols.append(C[r, :k].astype(np.int64) + co)
                    vals.append(V[r, :k])
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))

    @_obs.timed("dist.regrid3d")
    def regrid(self, grid, *, mesh: Grid = None, cap: int | None = None,
               pad: float = 1.25, dist: str | None = None
               ) -> "DistSpMat3D | None":
        """Re-distribute onto a new (L, q, q) grid (elastic shrink/grow).

        The 3D analogue of :meth:`DistSpMat.regrid`, with its collectives
        and its ``None`` on a rank the new grid leaves out — a
        replication-layer loss regrids (2, q, q) → (1, q, q) through global
        COO and the normal assembly path. ``dist`` defaults to the current
        distribution style; capacity is re-planned unless ``cap`` is
        given. In a grow, a rank new to the grid calls :meth:`join`.
        """
        return _regrid(self, grid, mesh=mesh, cap=cap, pad=pad, dist=dist)

    @staticmethod
    @_obs.timed("dist.regrid3d")
    def join(grid, *, mesh: Grid = None, cap: int | None = None,
             pad: float = 1.25, dist: str | None = None) -> "DistSpMat3D":
        """:meth:`regrid`'s partner on a rank new to the grid (a grow)."""
        return _regrid(None, grid, mesh=mesh, cap=cap, pad=pad, dist=dist)


def _regrid(m, grid, *, mesh, cap, pad, dist=None):
    """``m`` (this rank's matrix; None on a rank that joins) re-assembled
    on ``grid`` through its global COO: this rank's matrix of the new grid,
    or None on a rank the new grid leaves out (``DistSpMat.regrid``)."""
    grid = tuple(int(x) for x in grid)
    comm.of(grid)                   # the new grid's groups, on every rank
    in_old = m is not None and comm.holds(m.grid)
    in_new = comm.holds(grid)
    src = None
    if in_old:
        rows, cols, vals = m.to_global_coo()    # over the old grid
        three = isinstance(m, DistSpMat3D)
        head = (m.shape, m.dist if three else m.order,
                tuple(m.val.shape[m.row.ndim:]))            # vdims
        src = (three, head, rows, cols, vals)
    if in_new and (not in_old or
                   comm.positions(grid) > comm.positions(m.grid)):
        src = comm.broadcast_object(src, grid)  # a grow: rank 0's COO
    if not in_new:
        return None
    three, (shape, tag, vdims), rows, cols, vals = src
    if three:
        return DistSpMat3D.from_global_coo(
            shape, rows, cols, vals, grid, dist or tag, mesh=mesh, cap=cap,
            pad=pad)
    return DistSpMat.from_global_coo(
        shape, rows, cols, vals, grid, mesh=mesh, cap=cap, pad=pad,
        vdims=vdims, order=tag if tag in ("row", "col") else "row")


def _block_sizes(shape, L, q, dist):
    M, N = shape
    if dist == "acol":
        return _pad_to(M, L * q * q) // q, _pad_to(N, L * q * q) // (L * q)
    if dist == "brow":
        return _pad_to(M, L * q * q) // (L * q), _pad_to(N, L * q * q) // q
    if dist == "csub":
        return _pad_to(M, L * q * q) // q, _pad_to(N, L * q * q) // (L * q)
    raise ValueError(dist)


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

    data: torch.Tensor  # (1, 1, vb, *vdims): this rank's piece
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
        """Split the host vector ``x`` (the same on every rank) into pieces
        of vb = ceil(n / (pr*pc)) (zero-padded past n); this rank keeps
        its piece, on ``mesh.device`` (else ``device``)."""
        pr, pc = grid
        g = _check_grid(pr, pc)
        x = np.asarray(x)
        n = x.shape[0]
        vb = _ceil(n, pr * pc)
        k = _piece_id(g.i, g.j, grid, layout)
        piece = np.zeros((vb,) + x.shape[1:], x.dtype)
        mine = x[k * vb:(k + 1) * vb]
        piece[:len(mine)] = mine
        return DistVec(torch.from_numpy(piece[None, None]).to(
            _vec_device(mesh, device)), int(n), (pr, pc), layout)

    def to_global(self) -> np.ndarray:
        """The whole vector on the host, the same on every rank."""
        pr, pc = self.grid
        d = comm.gather_grid(self.data[0, 0], self.grid)
        xp = np.empty((pr * pc, self.vb) + d.shape[3:], d.dtype)
        for i in range(pr):
            for j in range(pc):
                xp[self.piece_id(i, j)] = d[i, j]
        return xp.reshape((pr * pc * self.vb,) + d.shape[3:])[:self.n]


@dataclasses.dataclass(frozen=True)
class DistSpVec:
    """Fully distributed sparse vector (FullyDistSpVec): piece-local int32
    indices, SENTINEL-padded past each piece's ``nnz``."""

    idx: torch.Tensor   # (1, 1, cap) int32, piece-local indices
    val: torch.Tensor   # (1, 1, cap)
    nnz: torch.Tensor   # (1, 1) int32
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
        g = _check_grid(pr, pc)
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
        k = _piece_id(g.i, g.j, grid, layout)
        mine = piece == k
        local, val_s = local[mine], val[mine]
        order = np.argsort(local, kind="stable")
        c = len(order)
        I = np.full((1, 1, cap), SENTINEL, np.int32)
        V = np.zeros((1, 1, cap), val.dtype)
        I[0, 0, :c] = local[order]
        V[0, 0, :c] = val_s[order]
        dev = _vec_device(mesh, device)
        return DistSpVec(torch.from_numpy(I).to(dev),
                         torch.from_numpy(V).to(dev),
                         torch.tensor([[c]], dtype=torch.int32, device=dev),
                         int(n), (pr, pc), layout)

    def to_global(self):
        """(global int64 indices, values) of the stored entries below n,
        the same on every rank; only each piece's nnz prefix is
        gathered."""
        pr, pc = self.grid
        cnt, (I, V) = comm.gather_prefixes(
            (self.idx[0, 0], self.val[0, 0]), int(self.nnz.reshape(())),
            self.grid)
        idxs, vals = [], []
        for i in range(pr):
            for j in range(pc):
                k = _piece_id(i, j, self.grid, self.layout)
                c = int(cnt[i * pc + j])
                idxs.append(I[i * pc + j, :c].astype(np.int64) + k * self.vb)
                vals.append(V[i * pc + j, :c])
        idx = np.concatenate(idxs)
        val = np.concatenate(vals)
        keep = idx < self.n
        return idx[keep], val[keep]

    def to_global_dense(self, zero=0.0) -> np.ndarray:
        idx, val = self.to_global()
        out = np.full((self.n,), zero, val.dtype)
        out[idx] = val
        return out


# --------------------------------------------------------------------------
# grid-independent sparse checkpoints
# --------------------------------------------------------------------------

@_obs.timed("dist.ckpt_save")
def save_spmat(ckpt_dir: str, step: int, m, *, keep: int = 3) -> str:
    """Checkpoint a DistSpMat/DistSpMat3D through the CRC-manifest path
    (``train/checkpoint.py``), as the JAX package does.

    The matrix is saved as *global COO* plus metadata — not as grid-shaped
    tiles — so :func:`restore_spmat` can re-assemble it onto any grid, in
    this world or a new one (saved on 2x2, restored on 1x1). On a grid
    every rank gathers the COO, rank 0 writes and the grid's ranks wait
    for it.
    """
    from ..train.checkpoint import save_checkpoint
    rows, cols, vals = m.to_global_coo()
    tree = {"rows": rows, "cols": cols, "vals": vals,
            "shape": np.asarray(m.shape, np.int64),
            "order": np.frombuffer(m.order.encode(), np.uint8),
            "kind": np.frombuffer(type(m).__name__.encode(), np.uint8)}
    if isinstance(m, DistSpMat3D):
        tree["dist"] = np.frombuffer(m.dist.encode(), np.uint8)
    return save_checkpoint(ckpt_dir, step, tree, keep=keep, grid=m.grid)


@_obs.timed("dist.ckpt_restore")
def restore_spmat(ckpt_dir: str, grid, *, mesh: Grid = None, device=None,
                  step: int | None = None, cap: int | None = None,
                  pad: float = 1.25, dist: str | None = None):
    """Restore a sparse checkpoint onto ``grid`` (any shape); returns
    ``(matrix, step)``.

    A 2-tuple ``grid`` rebuilds a :class:`DistSpMat`, a 3-tuple a
    :class:`DistSpMat3D` (``dist`` defaults to the saved distribution).
    Capacity is re-planned for the target tiling and the saved ``order``
    tag is kept. The tiles land on ``mesh.device`` (else ``device``).
    """
    from ..train.checkpoint import restore_flat
    state, step = restore_flat(ckpt_dir, step)
    shape = tuple(int(x) for x in np.asarray(state["shape"]))
    saved_order = bytes(np.asarray(state["order"])).decode()
    tag = saved_order if saved_order in ("row", "col") else "row"
    grid = tuple(int(g) for g in grid)
    if len(grid) == 3:
        d = dist or bytes(np.asarray(state["dist"])).decode()
        m = DistSpMat3D.from_global_coo(
            shape, state["rows"], state["cols"], state["vals"], grid, d,
            mesh=mesh, device=device, cap=cap, pad=pad)
    else:
        vals = np.asarray(state["vals"])
        m = DistSpMat.from_global_coo(
            shape, state["rows"], state["cols"], vals, grid, mesh=mesh,
            device=device, cap=cap, pad=pad, vdims=vals.shape[1:],
            order=tag)
    return m, step
