"""The process grid's collectives over ``torch.distributed``.

This is the port's counterpart of the named-axis collectives that the JAX
package's bodies call under ``shard_map`` (``jax.lax.all_gather``,
``psum``, ``psum_scatter``, ``all_to_all``, ``ppermute``,
``axis_index``), and the only module of the port that imports
``torch.distributed``: ``launch/mesh.py``'s named ``DeviceMesh`` and
``dist/shardings.py``'s DTensors (the LM stack's parameter blocks) take
their types from here, and their exchanges are this module's, over the
mesh's groups (``MeshComm``). As in CombBLAS (MPI, one process per grid
position), every grid position is one process: on a
``pr`` x ``pc`` grid of ``L`` layers, rank ``r`` is position ``(l, i, j)``,
row-major over ``(layer, row, col)``, as JAX orders the devices of its
mesh (on one layer, ``(i, j) = divmod(r, pc)``).

Axes are named as in JAX. Axis ``'col'`` varies ``j`` within process row
``i`` of one layer; axis ``'row'`` varies ``i`` within process column
``j`` of one layer; ``PLANE = ('row', 'col')`` is one layer's grid,
indexed ``i*pc + j``; axis ``'layer'`` varies ``l`` over the ``L`` ranks
that share ``(i, j)``; ``WORLD`` is every rank, indexed by the rank. On one
layer ``PLANE`` and ``WORLD`` are the same ranks and the same group. Every
rank creates the sub-groups in the same order (``GridComm.create``).

The 1x1 grid needs no process group: over an axis of size 1 every
collective is the identity and is computed as such, so the 1x1 results
are those of a single process. Every process may use it as its own grid;
where grid positions are counted (``holds``: a regrid's or a loop's
retired ranks) its one position is rank 0's.

A grid of ``n`` positions in a world of ``N >= n`` ranks lives on world
ranks ``0 .. n-1``, as the JAX package's ``make_grid`` takes the first
``n`` devices; its ``WORLD`` axis is then a group over those ranks. Every
world rank creates every group of a grid, member or not
(``torch.distributed.new_group`` is collective over the world); a rank
past the grid's positions gets a ``GridComm`` with ``member`` False and no
groups, so it never reaches one of the grid's collectives. That is what
lets a grid shrink in one world (``DistSpMat.regrid``): the ranks it
leaves out retire.

Transport follows the process group's backend. NCCL moves CUDA tensors
directly. Gloo moves host tensors only, so on a gloo group a CUDA payload
is copied to pinned host memory, exchanged, and copied back; that is the
configuration of several ranks sharing one card, where NCCL refuses two
ranks on one GPU. The kernels run on the card either way. When every
rank of a gloo world holds the same card, a gather of a CUDA payload
crosses through the card's memory instead, on a grid and a named mesh
alike (``CardMailbox``: each rank's buffer, opened by the others through
CUDA IPC when the world forms, ``init_world``), since gloo over a slow
loopback moves a few hundred MB/s a rank and the LM stack gathers
gigabytes a forward; the other collectives stay staged.

Data-moving collectives (gathers, all-to-alls, permutes, broadcasts) view
their payload as bytes, so any dtype (bool included) moves in one call and
several fields can share one buffer (``tile_permute``). Reductions are
computed as a gather followed by a sum in axis order, so every rank of the
axis gets the same bits and a float sum does not depend on the backend's
reduction order.

``stats`` books every exchange by axis as well as in total, so a caller
can tell one layer's SUMMA (``'row'``, ``'col'``, ``PLANE``) from the
inter-layer exchanges (``'layer'``); inside ``tagged(name)`` an exchange is
booked under ``stats["tags"][name]`` too (the LM stack's leaf gathers and
expert sums share the mesh's axes).

A named mesh (``MeshComm``, from a ``DeviceMesh``) is an object these
collectives take in place of a ``GridComm``: its axes are the mesh's dim
names, each with the mesh's process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..obs import recorder as _obs
from .coo import COO

PLANE = ("row", "col")
WORLD = ("layer", "row", "col")


@dataclasses.dataclass(frozen=True)
class GridComm:
    """This process's place in a ``layers`` x ``pr`` x ``pc`` grid and its
    groups."""

    pr: int
    pc: int
    rank: int
    backend: str | None         # None on the 1x1 grid (no process group)
    groups: dict                # axis -> ProcessGroup
    layers: int = 1
    member: bool = True         # False on a world rank past the grid

    @property
    def plane(self) -> int:
        """Ranks in one layer."""
        return self.pr * self.pc

    @property
    def l(self) -> int:                                    # noqa: E743
        return self.rank // self.plane

    @property
    def i(self) -> int:
        return self.rank % self.plane // self.pc

    @property
    def j(self) -> int:
        return self.rank % self.pc

    def size(self, axis) -> int:
        if axis == "row":
            return self.pr
        if axis == "col":
            return self.pc
        if axis == "layer":
            return self.layers
        if axis == PLANE:
            return self.plane
        return self.layers * self.plane

    def index(self, axis) -> int:
        """``jax.lax.axis_index(axis)``."""
        if axis == "row":
            return self.i
        if axis == "col":
            return self.j
        if axis == "layer":
            return self.l
        if axis == PLANE:
            return self.rank % self.plane
        return self.rank

    def global_rank(self, axis, k: int) -> int:
        """The world rank of member ``k`` of this process's ``axis``."""
        base = self.l * self.plane
        if axis == "row":
            return base + k * self.pc + self.j
        if axis == "col":
            return base + self.i * self.pc + k
        if axis == "layer":
            return k * self.plane + self.i * self.pc + self.j
        if axis == PLANE:
            return base + k
        return k

    @staticmethod
    def create(pr: int, pc: int, layers: int = 1) -> "GridComm":
        n = layers * pr * pc
        if n == 1:
            return GridComm(1, 1, 0, None, {})
        name = f"{pr}x{pc}" if layers == 1 else f"{layers}x{pr}x{pc}"
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"a {name} grid needs torch.distributed initialized with "
                f"{n} ranks (one process a grid position), e.g. "
                "init_process_group('nccl' or 'gloo', "
                f"init_method='tcp://localhost:<port>', world_size={n}, "
                "rank=...); none is initialized")
        world = dist.get_world_size()
        if world < n:
            raise RuntimeError(
                f"a {name} grid needs a world of at least {n} ranks; "
                f"torch.distributed has {world}")
        rank = dist.get_rank()
        plane = pr * pc
        # every rank creates every group, in this one order: each layer's
        # process rows, then its process columns; then, with several
        # layers, the layers' planes and the layer axes; last, in a world
        # larger than the grid, the grid's ranks
        rows, cols = [], []
        for l in range(layers):
            b = l * plane
            rows.append([dist.new_group([b + i * pc + j for j in range(pc)])
                         for i in range(pr)])
            cols.append([dist.new_group([b + i * pc + j for i in range(pr)])
                         for j in range(pc)])
        planes, layer_axes = [], []
        if layers > 1:
            planes = [dist.new_group(range(l * plane, (l + 1) * plane))
                      for l in range(layers)]
            layer_axes = [dist.new_group([l * plane + p
                                          for l in range(layers)])
                          for p in range(plane)]
        whole = dist.group.WORLD if world == n else dist.new_group(range(n))
        planes = planes or [whole]
        if rank >= n:
            return GridComm(pr, pc, rank, dist.get_backend(), {}, layers,
                            member=False)
        l, p = divmod(rank, plane)
        i, j = divmod(p, pc)
        groups = {"col": rows[l][i], "row": cols[l][j], PLANE: planes[l],
                  WORLD: whole}
        if layer_axes:
            groups["layer"] = layer_axes[p]
        return GridComm(pr, pc, rank, dist.get_backend(), groups, layers)


@dataclasses.dataclass(frozen=True)
class MeshComm:
    """A named mesh's axes as the collectives below take them: each axis'
    process group, size, this rank's index on it and its members' world
    ranks in axis order (``mesh_comm``)."""

    backend: str
    groups: dict                # axis name -> ProcessGroup
    sizes: dict                 # axis name -> size
    coords: dict                # axis name -> this rank's index
    ranks: dict                 # axis name -> world ranks in axis order

    def size(self, axis) -> int:
        return self.sizes[axis]

    def index(self, axis) -> int:
        return self.coords[axis]

    def global_rank(self, axis, k: int) -> int:
        """The world rank of member ``k`` of this process's ``axis``."""
        return self.ranks[axis][k]


_MESHES: dict = {}


def mesh_comm(mesh) -> MeshComm:
    """The ``MeshComm`` of a ``torch.distributed`` ``DeviceMesh`` with named
    dims (``launch/mesh.make_mesh``), on a rank of it; made once a mesh."""
    got = _MESHES.get(id(mesh))
    if got is not None and got[0] is mesh:
        return got[1]
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    groups = {a: mesh.get_group(a) for a in names}
    mc = MeshComm(dist.get_backend(), groups, dict(zip(names, mesh.shape)),
                  dict(zip(names, coord)),
                  {a: dist.get_process_group_ranks(g)
                   for a, g in groups.items()})
    _MESHES[id(mesh)] = (mesh, mc)
    return mc


class CardMailbox:
    """Ranks that share one card exchange through it: each rank's buffer on
    the card (``nbytes``), opened by every other rank through CUDA IPC.

    Gloo moves host tensors only, and on a host whose loopback is slow its
    staged exchanges run at a few hundred MB/s a rank (``chip_smoke.py``
    phase 28 times both); a copy between two buffers of one card runs at
    the card's memory rate. An exchange over a group writes this rank's
    bytes into its own buffer, waits for the group (a gloo barrier: every
    member's bytes are there), copies the members' buffers, and waits for
    the group again (every member has read this rank's buffer, which the
    next exchange overwrites); a payload larger than the buffer goes in
    pieces. Opened by ``init_world`` (collective over the world)."""

    def __init__(self, nbytes: int):
        from torch.multiprocessing.reductions import reduce_tensor
        self.mine = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        n, me = dist.get_world_size(), dist.get_rank()
        # a handle for each other rank: CUDA IPC counts each one's release
        sent = [None if r == me else reduce_tensor(self.mine)
                for r in range(n)]
        handles = [None] * n
        dist.all_gather_object(handles, sent)
        self.boxes = [self.mine if r == me else
                      handles[r][me][0](*handles[r][me][1]) for r in range(n)]

    def all_gather(self, b: torch.Tensor, ranks, group) -> torch.Tensor:
        """The members' bytes ``b`` (uint8 on the card), stacked in the
        order of ``ranks`` (their world ranks)."""
        n, cap = b.numel(), self.mine.numel()
        out = torch.empty((len(ranks), n), dtype=torch.uint8, device=b.device)
        stream = torch.cuda.current_stream()
        for lo in range(0, n, cap):
            k = min(cap, n - lo)
            self.mine[:k].copy_(b[lo:lo + k])
            stream.synchronize()
            dist.barrier(group=group)
            for i, r in enumerate(ranks):
                out[i, lo:lo + k].copy_(self.boxes[r][:k])
            stream.synchronize()
            dist.barrier(group=group)
        return out

    def close(self) -> None:
        """Drop the other ranks' buffers, then (after every rank has) this
        rank's own: its producer outlives every use of it."""
        torch.cuda.synchronize()
        self.boxes = []
        dist.barrier()
        torch.cuda.ipc_collect()
        self.mine = None


_CARD: "CardMailbox | None" = None
CARD_MAILBOX_BYTES = 64 << 20


def _open_card_mailbox() -> None:
    """Open the world's ``CardMailbox`` when the backend is gloo and every
    world rank has taken the same card (CUDA initialized, same host, same
    device UUID). Collective over a gloo world: every rank calls it."""
    global _CARD
    if dist.get_backend() != "gloo" or dist.get_world_size() == 1:
        return
    import socket
    me = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        me = (socket.gethostname(), str(torch.cuda.get_device_properties(
            torch.cuda.current_device()).uuid))
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, me)
    if me is not None and len(set(where)) == 1:
        _CARD = CardMailbox(CARD_MAILBOX_BYTES)


_GRIDS: dict = {}


def init_world(rank: int, world: int, port: int, backend: str) -> None:
    """Join this process to a world of ``world`` ranks on this host
    (``tcp://localhost:<port>``), as rank ``rank``, over ``backend``
    ('nccl' with a card a rank, 'gloo' otherwise). The flight recorder
    learns the rank, to name this process's trace file. On gloo, when every
    rank took the same card before joining (``torch.cuda.set_device``), the
    world opens that card's ``CardMailbox``, which then carries every
    gather of a CUDA payload."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    _obs.set_rank(rank, world)
    _open_card_mailbox()


def close_world() -> None:
    """Leave the world and forget its grids and meshes (and the card's
    mailbox, after every rank has let go of it)."""
    global _CARD
    _GRIDS.clear()
    _MESHES.clear()
    if _CARD is not None:
        _CARD.close()
        _CARD = None
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """``(rank, size)`` of this process in the world; ``(0, 1)`` without
    a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier(grid=None) -> None:
    """Wait for every rank of ``grid`` (a ``(pr, pc)`` or ``(L, pr, pc)``
    grid; the whole world by default). Free without a process group and on
    a grid of one position."""
    if grid is None:
        if world()[1] > 1:
            dist.barrier()
        return
    g = of(grid)
    if g.size(WORLD) > 1:
        dist.barrier(group=g.groups[WORLD])


def positions(grid) -> int:
    """The number of positions of a ``(pr, pc)`` or ``(L, pr, pc)``
    grid."""
    L, pr, pc = _key(grid)
    return L * pr * pc


def holds(grid) -> bool:
    """Whether this process holds a position of ``grid``: its world rank
    is below the grid's positions (the 1x1 grid's is rank 0's)."""
    return world()[0] < positions(grid)


def _key(grid) -> tuple[int, int, int]:
    """``(L, pr, pc)`` of a 2-D ``(pr, pc)`` or 3-D ``(L, pr, pc)`` grid."""
    if len(grid) == 2:
        return 1, int(grid[0]), int(grid[1])
    return int(grid[0]), int(grid[1]), int(grid[2])


def of(grid) -> GridComm:
    """The ``GridComm`` of a ``(pr, pc)`` or ``(L, pr, pc)`` grid on this
    process, created on first use (a collective: every rank of the world
    reaches it in the same order). Cached by the grid and the world's size,
    so a grid of one world is never another's; ``close_world`` forgets
    them all. Raises ``RuntimeError`` unless the grid has one position or
    the world has a rank for each; on a rank past the grid's positions the
    result has ``member`` False."""
    key = _key(grid) + (world()[1],)
    if key not in _GRIDS:
        L, pr, pc, _ = key
        _GRIDS[key] = GridComm.create(pr, pc, L)
    return _GRIDS[key]


# --------------------------------------------------------------------------
# transport
# --------------------------------------------------------------------------

# exchange accounting of this process: the collectives called, the bytes
# this rank put on the wire (its send buffer) and the host seconds spent in
# them, staging copies included (for an exchange in flight, the seconds to
# issue it and to wait for it: the time it was not hidden); in total and
# by axis ('row', 'col', 'layer', 'plane' for PLANE, 'world')
stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "axes": {}, "tags": {}}
_TAGS: list = []


def reset_stats() -> None:
    stats.update(calls=0, bytes=0, seconds=0.0, axes={}, tags={})


@contextlib.contextmanager
def tagged(name: str):
    """Book the exchanges made inside under ``stats["tags"][name]`` as well
    (the innermost tag, where they nest)."""
    _TAGS.append(name)
    try:
        yield
    finally:
        _TAGS.pop()


def _axis_name(axis) -> str:
    if axis == PLANE:
        return "plane"
    if axis == WORLD:
        return "world"
    return axis


def _book(nbytes: int, seconds: float, axis) -> None:
    recs = [stats, stats["axes"].setdefault(
        _axis_name(axis), {"calls": 0, "bytes": 0, "seconds": 0.0})]
    if _TAGS:
        recs.append(stats["tags"].setdefault(
            _TAGS[-1], {"calls": 0, "bytes": 0, "seconds": 0.0}))
    for rec in recs:
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["seconds"] += seconds


def _staged(g: GridComm, x: torch.Tensor) -> bool:
    """Whether ``x`` crosses the wire through host memory: a CUDA payload
    on a gloo group (gloo moves host tensors only)."""
    return g.backend == "gloo" and x.is_cuda


def _on_card(x: torch.Tensor) -> bool:
    """Whether a gathered ``x`` crosses through the card's memory: a CUDA
    payload in a world whose ranks share one card (``CardMailbox``)."""
    return _CARD is not None and x.is_cuda


def _to_wire(g: GridComm, x: torch.Tensor) -> torch.Tensor:
    if not _staged(g, x):
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)                # synchronous: gloo reads it on its thread
    return host


def _from_wire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if x.device == like.device:
        return x
    return x.to(like.device, non_blocking=True)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _unbytes(b: torch.Tensor, dtype, shape) -> torch.Tensor:
    itemsize = torch.empty((), dtype=dtype).element_size()
    if b.storage_offset() % itemsize:
        b = b.clone()                 # a field packed at an odd offset
    return b.view(dtype).reshape(shape)


class Pending:
    """An exchange in flight; ``wait()`` returns its result."""

    def __init__(self, work, finish, nbytes=None, issued=0.0, axis=None):
        self._work, self._finish = work, finish
        self._nbytes, self._issued, self._axis = nbytes, issued, axis

    def wait(self):
        t0 = time.perf_counter()
        if self._work is not None:
            self._work.wait()
        out = self._finish()
        if self._nbytes is not None:
            _book(self._nbytes, self._issued + time.perf_counter() - t0,
                  self._axis)
        return out


def _issued(work, finish, nbytes, t0, async_op, axis):
    """The result of a collective over ``axis`` issued at ``t0``: a
    ``Pending`` that books it on ``wait()``, or the value, booked now."""
    p = Pending(work, finish, nbytes, time.perf_counter() - t0, axis)
    return p if async_op else p.wait()


def _done(value) -> Pending:
    return Pending(None, lambda: value)


# --------------------------------------------------------------------------
# data-moving collectives
# --------------------------------------------------------------------------

def _gathered_wire(x: torch.Tensor, g: GridComm, axis) -> torch.Tensor:
    """Every member's bytes of ``x`` over ``axis``, concatenated in axis
    order, where the backend delivers them (host memory on a gloo group)."""
    t0 = time.perf_counter()
    wire = _to_wire(g, _bytes(x))
    parts = [torch.empty_like(wire) for _ in range(g.size(axis))]
    dist.all_gather(parts, wire, group=g.groups[axis])
    out = torch.cat(parts)
    _book(wire.numel(), time.perf_counter() - t0, axis)
    return out


def all_gather(x: torch.Tensor, g: GridComm, axis, *, tiled: bool = False):
    """``jax.lax.all_gather(x, axis, tiled=tiled)``: stacked on a new dim 0
    in axis order, or concatenated along dim 0 with ``tiled``."""
    n = g.size(axis)
    if n == 1:
        return x if tiled else x[None]
    if _on_card(x):
        t0 = time.perf_counter()
        out = _CARD.all_gather(_bytes(x), [g.global_rank(axis, k)
                                           for k in range(n)],
                               g.groups[axis])
        _book(x.numel() * x.element_size(), time.perf_counter() - t0, axis)
    else:
        out = _from_wire(_gathered_wire(x, g, axis), x)
    out = _unbytes(out, x.dtype, (n,) + tuple(x.shape))
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:])) if tiled \
        else out


def _all_gather_host(x: torch.Tensor, g: GridComm, axis) -> torch.Tensor:
    """``all_gather`` (stacked) delivered on the host, for a caller that
    reads it there: a gloo result stays where it arrived."""
    n = g.size(axis)
    if n == 1:
        return x.cpu()[None]
    out = _gathered_wire(x, g, axis).cpu()
    return _unbytes(out, x.dtype, (n,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, g: GridComm, axis):
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``: dim 0 of ``x``
    splits into ``n`` equal chunks, chunk ``t`` goes to member ``t``, and
    the result's chunk ``s`` came from member ``s``."""
    n = g.size(axis)
    if n == 1:
        return x
    t0 = time.perf_counter()
    wire = _to_wire(g, _bytes(x))
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=g.groups[axis])
    res = _unbytes(_from_wire(out, x), x.dtype, x.shape)
    _book(wire.numel(), time.perf_counter() - t0, axis)
    return res


def ppermute(x: torch.Tensor, g: GridComm, axis, perm, *,
             async_op: bool = False):
    """``jax.lax.ppermute(x, axis, perm)``: ``perm`` holds (src, dst)
    pairs of axis positions; a member no pair sends to gets zeros. An
    ``all_to_all_single`` with one non-empty split each way (gloo has no
    send/recv for CUDA tensors)."""
    n = g.size(axis)
    if n == 1:
        return _done(x) if async_op else x
    t0 = time.perf_counter()
    me = g.index(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    wire = _to_wire(g, _bytes(x))
    nb = wire.numel()
    ins = [0] * n
    outs = [0] * n
    if dst:
        ins[dst[0]] = nb
    if src:
        outs[src[0]] = nb
    send = wire if dst else wire[:0]
    out = torch.empty_like(wire) if src else wire.new_empty(0)
    work = dist.all_to_all_single(out, send, outs, ins,
                                  group=g.groups[axis], async_op=async_op)

    def finish():
        got = out if src else torch.zeros_like(wire)
        return _unbytes(_from_wire(got, x), x.dtype, x.shape)

    return _issued(work, finish, send.numel(), t0, async_op, axis)


def broadcast(x: torch.Tensor, g: GridComm, axis, owner: int, *,
              async_op: bool = False):
    """Member ``owner``'s ``x`` on every member of ``axis``."""
    if g.size(axis) == 1:
        return _done(x) if async_op else x
    t0 = time.perf_counter()
    wire = _to_wire(g, _bytes(x))
    if wire.data_ptr() == x.data_ptr():
        wire = wire.clone()           # never overwrite the caller's tensor
    work = dist.broadcast(wire, src=g.global_rank(axis, owner),
                          group=g.groups[axis], async_op=async_op)
    finish = lambda: _unbytes(_from_wire(wire, x), x.dtype, x.shape)
    sent = wire.numel() if g.index(axis) == owner else 0
    return _issued(work, finish, sent, t0, async_op, axis)


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------

def _sum_in_order(parts, op=torch.add):
    red = parts[0]
    for t in range(1, parts.shape[0]):
        red = op(red, parts[t])
    return red


def psum(x: torch.Tensor, g: GridComm, axis, op=torch.add):
    """``jax.lax.psum(x, axis)``: the sum over the axis, in axis order, the
    same bits on every member (``op`` replaces the sum: a monoid's min or
    max)."""
    if g.size(axis) == 1:
        return x
    return _sum_in_order(all_gather(x, g, axis), op)


def psum_scatter(x: torch.Tensor, g: GridComm, axis):
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``:
    member ``k`` gets chunk ``k`` of dim 0 summed over the axis (an
    all-to-all, then the sum in axis order)."""
    n = g.size(axis)
    if n == 1:
        return x
    parts = all_to_all(x, g, axis)
    return _sum_in_order(parts.reshape((n, x.shape[0] // n)
                                       + tuple(x.shape[1:])))


# --------------------------------------------------------------------------
# tiles
# --------------------------------------------------------------------------

def _pack(fields):
    return torch.cat([_bytes(f) for f in fields])


def _unpack(buf, like):
    """Split a ``_pack`` buffer back into tensors shaped and typed like
    ``like``."""
    out, o = [], 0
    for f in like:
        nb = f.numel() * f.element_size()
        out.append(_unbytes(buf[o:o + nb], f.dtype, f.shape))
        o += nb
    return out


def permute_fields(fields, g: GridComm, axis, perm, *,
                   async_op: bool = False):
    """``ppermute`` of several tensors in ONE collective: they are packed
    into one byte buffer (the JAX package's tree-level ``ppermute``)."""
    if g.size(axis) == 1:
        return _done(tuple(fields)) if async_op else tuple(fields)
    p = ppermute(_pack(fields), g, axis, perm, async_op=True)
    finish = lambda: tuple(_unpack(p.wait(), fields))
    return Pending(None, finish) if async_op else finish()


def broadcast_fields(fields, g: GridComm, axis, owner: int, *,
                     async_op: bool = False):
    """Member ``owner``'s tensors on every member of ``axis``, in one
    collective."""
    if g.size(axis) == 1:
        return _done(tuple(fields)) if async_op else tuple(fields)
    p = broadcast(_pack(fields), g, axis, owner, async_op=True)
    finish = lambda: tuple(_unpack(p.wait(), fields))
    return Pending(None, finish) if async_op else finish()


def all_gather_fields(fields, g: GridComm, axis):
    """Every member's tensors of ``axis``, in axis order, in one
    collective: a list of tuples."""
    if g.size(axis) == 1:
        return [tuple(fields)]
    parts = all_gather(_pack(fields), g, axis)
    return [tuple(_unpack(parts[k], fields)) for k in range(g.size(axis))]


def all_to_all_fields(fields, g: GridComm, axis):
    """``all_to_all`` of several tensors in ONE collective: chunk ``t`` of
    dim 0 of every field travels to member ``t`` in one row of bytes."""
    n = g.size(axis)
    if n == 1:
        return tuple(fields)
    wide = [_bytes(f).reshape(n, -1) for f in fields]
    out = all_to_all(torch.cat(wide, dim=1), g, axis)
    res, o = [], 0
    for f, w in zip(fields, wide):
        res.append(_unbytes(out[:, o:o + w.shape[1]].contiguous(), f.dtype,
                            f.shape))
        o += w.shape[1]
    return tuple(res)


# A tile on the wire is a payload: the tile and, when its values are
# int8-compressed, its dequantization scale (else None). The scale travels
# in the same packed exchange as the tile's four fields, as the JAX
# package's tree-level collectives carry it.

def _fields(tile: COO, scale=None):
    fields = (tile.row, tile.col, tile.val, tile.nnz)
    return fields if scale is None else fields + (scale,)


def _payload(fields, like: COO):
    tile = COO(*fields[:4], like.shape, like.order)
    return tile, (fields[4] if len(fields) > 4 else None)


def tile_permute(tile: COO, g: GridComm, axis, perm, *, scale=None,
                 async_op: bool = False):
    """Move whole tiles (and their scales) between ranks in one
    collective; each tile keeps its entry order and tag. Returns the
    payload (tile, scale)."""
    p = permute_fields(_fields(tile, scale), g, axis, perm, async_op=True)
    finish = lambda: _payload(p.wait(), tile)              # noqa: E731
    return Pending(None, finish) if async_op else finish()


def as_psum(tile: COO, g: GridComm, axis) -> COO:
    """A tile as the JAX package's masked ``psum`` along ``axis`` delivers
    it (the owner's tile plus zeros from every other member): that sum
    turns a float -0.0 into +0.0, and adding +0.0 reproduces it bit for bit
    (x + 0 + ... + 0 == x + 0). An int8 payload and its positive scale
    come through that sum unchanged."""
    if g.size(axis) == 1 or not tile.val.is_floating_point():
        return tile
    return COO(tile.row, tile.col, tile.val + 0.0, tile.nnz, tile.shape,
               tile.order)


def tile_broadcast(tile: COO, g: GridComm, axis, owner: int, *,
                   scale=None, async_op: bool = False):
    """Member ``owner``'s payload on every member of ``axis``, in one
    collective, its tile as a masked ``psum`` delivers it (``as_psum``)."""
    p = broadcast_fields(_fields(tile, scale), g, axis, owner, async_op=True)

    def finish():
        t, sc = _payload(p.wait(), tile)
        return as_psum(t, g, axis), sc

    return Pending(None, finish) if async_op else finish()


def tile_all_gather(tile: COO, g: GridComm, axis, *, scale=None):
    """Every member's payload of ``axis``, in axis order, in one
    collective."""
    return [_payload(f, tile)
            for f in all_gather_fields(_fields(tile, scale), g, axis)]


# --------------------------------------------------------------------------
# host views of every rank's data (the same on every rank)
# --------------------------------------------------------------------------

def broadcast_object(obj, grid, owner: int = 0):
    """Position ``owner``'s picklable ``obj`` on every rank of ``grid``:
    its pickled size, then its bytes, in two broadcasts over ``WORLD``
    (host tensors on gloo, the current card's on NCCL)."""
    g = of(grid)
    if g.size(WORLD) == 1:
        return obj
    import pickle
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if g.backend == "nccl" else torch.device("cpu")
    mine = g.index(WORLD) == owner
    data = pickle.dumps(obj) if mine else b""
    n = broadcast(torch.tensor([len(data)], dtype=torch.int64, device=dev),
                  g, WORLD, owner)
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if mine \
        else torch.empty(int(n[0]), dtype=torch.uint8)
    buf = broadcast(buf.to(dev), g, WORLD, owner)
    return obj if mine else pickle.loads(buf.cpu().numpy().tobytes())


def gather_grid(x: torch.Tensor, grid):
    """Every rank's ``x`` as one host array shaped ``grid + x.shape`` (the
    global array of a per-rank field), the same on every rank."""
    full = _all_gather_host(x, of(grid), WORLD)
    return full.numpy().reshape(tuple(grid) + tuple(x.shape))


def gather_prefixes(fields, n: int, grid):
    """Every rank's first ``n`` entries of each 1-d-leading ``fields``
    array, without the padding past them: the counts are gathered first,
    then each rank sends its prefix padded to the largest count. Returns
    (counts[ranks], [host arrays shaped (ranks, max) + rest]) in rank
    order."""
    g = of(grid)
    dev = fields[0].device
    cnt = gather_grid(torch.tensor([int(n)], dtype=torch.int64, device=dev),
                      grid).reshape(-1)
    m = int(cnt.max()) if cnt.size else 0
    heads = [f[:m] for f in fields]
    buf = _pack(heads)
    parts = _all_gather_host(buf, g, WORLD)
    like = [torch.empty(h.shape, dtype=h.dtype, device="meta")
            for h in heads]
    out = [[] for _ in fields]
    for k in range(g.size(WORLD)):
        for t, h in enumerate(_unpack(parts[k], like)):
            out[t].append(h.numpy())
    return cnt, [np.stack(o) for o in out]

