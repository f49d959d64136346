"""Deterministic fault injection for the distributed sparse stack.

The port's copy of ``repro.robust.faults``: the same named **fault sites**
at the stack's host-level boundaries (where tiles enter an exchange, where
the planner reads overflow flags, where checkpoints and matrix files hit
disk), the same spec grammar and the same seeded draws, so one
``REPRO_FAULTS``/``REPRO_FAULT_SEED`` corrupts the same entries in both
packages.

Design rules:

  * **Deterministic.** Every fault carries a seed; corruption draws from
    ``numpy.random.default_rng`` keyed on (fault seed, global seed, site
    name).
  * **Zero overhead when disarmed.** ``enabled()`` is one module-global
    boolean read; every hook checks it first.
  * **Host-boundary semantics.** "Corruption in flight" is modeled by
    corrupting the operand at the host-level call boundary, before the
    exchange consumes it. The hooks copy before they mutate: the caller's
    tensors stay pristine, so a retry starts from the uncorrupted inputs.
    Sites with ``at=N`` count *activations* (host calls). ``merge.kv_ok``
    is a trace-time site in the JAX package (it fires once a compilation);
    the port runs eagerly and fires it on every call while armed — the
    same thing :func:`trace_fault` documents for JAX's traced calls.
  * **One tile on a grid.** The JAX package corrupts one tile of the
    global ``(pr, pc, cap)`` tile family. In the port each rank holds one
    tile: every rank counts the activation, gathers every tile's nnz
    (in JAX's tile order: ``(i, j)`` row-major, ``(l, i, j)`` with layers;
    a rank's index in it is its rank) and makes the same draws; only the
    rank that owns the drawn tile mutates its tensors. The same entries
    are hit as in JAX.
  * **No core imports at module scope.** Core modules import this module;
    containers are duck-typed on their fields, and ``torch`` and the
    grid's collectives are imported inside the hooks that need them.

Spec grammar (env ``REPRO_FAULTS`` or :func:`inject`)::

    site:kind[:key=val[,key=val...]][;site2:kind2...]

    e.g.  REPRO_FAULTS="spgemm2d.comm_a:nan:at=2,seed=7;loop.crash:crash"

Kinds: ``nan`` ``corrupt_val`` ``corrupt_idx`` ``drop`` ``dup`` ``flip``
``truncate`` ``corrupt_bytes`` ``crash`` ``delay``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import zlib

import numpy as np

# Matches core.coo.SENTINEL (int32 max), duplicated so this module needs
# nothing of core.
SENTINEL = 2**31 - 1

# Every named fault site in the stack, with the boundary it models: the
# JAX package's keys and texts.
KNOWN_SITES = {
    "dist.assemble": "host COO -> DistSpMat tile assembly",
    "spgemm2d.comm_a": "2D SUMMA: A entering the rotation/allgather",
    "spgemm2d.comm_b": "2D SUMMA: B entering the rotation/allgather",
    "spgemm3d.comm_a": "3D CA SpGEMM: A entering the per-layer multiply",
    "spgemm3d.comm_b": "3D CA SpGEMM: B entering the per-layer multiply",
    "spmspv.comm_x": "SpMSpV: frontier x entering the 'row' all-gather",
    "dist.compressed_exchange": "2D SUMMA: int8-compressed value payload "
                                "entering the exchange collectives",
    "merge.kv_ok": "merge engine: kv-tree overflow flag (trace-time)",
    "plan.spgemm.ok": "planner: SpGEMM ok flags read on the host",
    "plan.spmspv.ok": "planner: SpMSpV ok flags read on the host",
    "checkpoint.leaf": "checkpoint leaf file bytes on disk",
    "io.mm_body": "MatrixMarket body byte stream during read",
    "io.bin_body": "binary-format body byte stream after write",
    "loop.crash": "iterative app: hard crash at iteration start",
    "loop.delay": "iterative app: straggler delay inside an iteration",
    "dist.exchange_deadline": "hung/straggling collective: delay inside the "
                              "timed region of a guarded exchange "
                              "(robust/deadline.ExchangeGuard)",
    "loop.device_loss": "iterative app: device/node loss at iteration start "
                        "(TopologyError -> checkpoint, regrid, continue)",
}


class InjectedCrash(RuntimeError):
    """Raised by a ``crash`` fault — models a process dying mid-run."""


@dataclasses.dataclass
class Fault:
    site: str
    kind: str
    at: int = 1          # fire on the at-th .. (at+count-1)-th activation
    count: int = 1
    seed: int = 0
    amount: float = 0.25  # fraction of entries / seconds of delay
    hits: int = 0        # activations seen (mutable bookkeeping)
    fired: int = 0       # activations that actually fired


_FAULTS: list[Fault] = []
_ENABLED = False         # fast-path flag, kept in sync with _FAULTS
_ENV_LOADED = False


def _parse_spec(spec: str) -> list[Fault]:
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 2:
            raise ValueError(f"bad fault spec {part!r} (want site:kind[:k=v])")
        site, kind = bits[0], bits[1]
        kw = {}
        if len(bits) > 2:
            for kv in bits[2].split(","):
                k, _, v = kv.partition("=")
                kw[k] = float(v) if k == "amount" else int(v)
        out.append(Fault(site, kind, **kw))
    return out


def _ensure_env():
    global _ENV_LOADED, _ENABLED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    spec = os.environ.get("REPRO_FAULTS", "")
    if spec:
        _FAULTS.extend(_parse_spec(spec))
        _ENABLED = bool(_FAULTS)


def global_seed() -> int:
    return int(os.environ.get("REPRO_FAULT_SEED", "0"))


def enabled() -> bool:
    """One-boolean fast path; hooks bail here when nothing is armed."""
    if not _ENV_LOADED:
        _ensure_env()
    return _ENABLED


def active() -> list[Fault]:
    _ensure_env()
    return list(_FAULTS)


def reset_counters():
    for f in _FAULTS:
        f.hits = f.fired = 0


@contextlib.contextmanager
def inject(*specs: str):
    """Arm faults for a scope: ``with inject("spgemm2d.comm_a:nan"): ...``.

    Counters of the injected faults start at zero and the previous registry
    is restored (with its counters) on exit.
    """
    global _ENABLED
    _ensure_env()
    added = []
    for s in specs:
        added.extend(_parse_spec(s))
    _FAULTS.extend(added)
    _ENABLED = bool(_FAULTS)
    try:
        yield added
    finally:
        for f in added:
            _FAULTS.remove(f)
        _ENABLED = bool(_FAULTS)


def fire(site: str) -> Fault | None:
    """Count one activation of ``site``; return the fault if it fires now."""
    if not enabled():
        return None
    for f in _FAULTS:
        if f.site == site:
            f.hits += 1
            if f.at <= f.hits < f.at + f.count:
                f.fired += 1
                return f
    return None


def trace_fault(site: str) -> Fault | None:
    """Armed-fault lookup WITHOUT activation counting.

    The JAX package calls it at trace time (once a compilation); the port
    calls it on every eager call. Either way the fault applies to every
    call while armed: bound it with an :func:`inject` scope.
    """
    if not enabled():
        return None
    for f in _FAULTS:
        if f.site == site:
            f.fired += 1
            return f
    return None


def _rng(f: Fault) -> np.random.Generator:
    return np.random.default_rng(
        (int(f.seed) << 16) ^ global_seed() ^ zlib.crc32(f.site.encode()))


# --------------------------------------------------------------------------
# corruption helpers (host-level, numpy)
# --------------------------------------------------------------------------

def _pick(f: Fault, nnz):
    """The draws of one tile corruption over the family's per-tile ``nnz``
    (flattened in tile order): ``(t, n, k, idxs)``, or None when every
    tile is empty."""
    N = np.asarray(nnz).reshape(-1)
    rng = _rng(f)
    livable = np.nonzero(N > 0)[0]
    if livable.size == 0:
        return None
    t = int(rng.choice(livable))
    n = int(N[t])
    k = max(1, min(n, int(round(f.amount * n))))
    idxs = rng.choice(n, size=k, replace=False)
    return t, n, k, idxs


def _corrupt_one(f: Fault, R, C, V, N, t, n, k, idxs):
    """Apply ``f`` to tile ``t`` of (ntile, cap) views, in place."""
    cap = R.shape[-1]
    if f.kind == "nan":
        if np.issubdtype(V.dtype, np.floating):
            V[t, idxs] = np.nan
        else:
            V[t, idxs] = np.iinfo(V.dtype).max
    elif f.kind == "corrupt_val":
        if np.issubdtype(V.dtype, np.integer):
            # narrow wire dtypes (int8 compressed payloads): numpy 2
            # rejects out-of-range Python scalars — widen, then truncate
            # back with C-cast wraparound
            V[t, idxs] = (V[t, idxs].astype(np.int64) * 1000 + 7) \
                .astype(V.dtype)
        else:
            V[t, idxs] = V[t, idxs] * 1000 + 7
    elif f.kind == "corrupt_idx":
        # out of tile bounds but not the padding sentinel
        R[t, idxs] = 2**30 + np.arange(k, dtype=R.dtype)
    elif f.kind == "drop":
        # silently lose k entries: compact the live prefix and shrink nnz —
        # only a checksum (or a result oracle) can see this one
        keep = np.ones(cap, bool)
        keep[idxs] = False
        keep[n:] = False
        m = int(keep.sum())
        for A, pad in ((R, SENTINEL), (C, SENTINEL), (V, 0)):
            if A is None:
                continue
            live = A[t][keep]
            A[t][:m] = live
            A[t][m:] = pad
        N[t] = m
    elif f.kind == "dup":
        if n < cap:   # need slack to duplicate into; else corrupt instead
            src = int(idxs[0])
            R[t, n] = R[t, src]
            if C is not None:
                C[t, n] = C[t, src]
            V[t, n] = V[t, src]
            N[t] = n + 1
        else:
            V[t, idxs] = V[t, idxs] * 1000 + 7
    else:
        raise ValueError(f"fault kind {f.kind!r} cannot corrupt tiles")


def _family(row, col, val, nnz, has_col):
    cap = row.shape[-1]
    return (row.reshape(-1, cap), col.reshape(-1, cap) if has_col else None,
            val.reshape((-1, cap) + val.shape[row.ndim:]), nnz.reshape(-1))


def _corrupt_tiles(f: Fault, row, col, val, nnz, has_col: bool):
    """Apply ``f`` to one tile of a capacity-padded tile family.

    Arrays are (..., cap) numpy copies; returns them mutated. ``row`` (and
    ``col`` when present) use SENTINEL padding; ``nnz`` counts live slots.
    """
    R, C, V, N = _family(row, col, val, nnz, has_col)
    drawn = _pick(f, N)
    if drawn is not None:
        _corrupt_one(f, R, C, V, N, *drawn)
    return row, col, val, nnz


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy().copy()


def _corrupt_obj(f: Fault, obj, names, nnz=None):
    """Corrupt the drawn tile of a distributed container: every rank draws
    over every tile's nnz (``nnz``, else gathered over the grid), and the
    owner of the tile — the rank, in the grid's flattened tile order —
    rebuilds its tensors from mutated copies. Returns the (possibly new)
    container."""
    import torch
    from ..core import comm
    if nnz is None:
        nnz = comm.gather_grid(obj.nnz.reshape(()), obj.grid)
    drawn = _pick(f, nnz)
    if drawn is None or drawn[0] != comm.of(obj.grid).rank:
        return obj
    arrays = [_host(getattr(obj, name)) for name in names]
    if len(names) == 3:                          # (idx, val, nnz): a vector
        views = _family(arrays[0], None, arrays[1], arrays[2], False)
    else:
        views = _family(*arrays, True)
    _corrupt_one(f, *views, 0, *drawn[1:])       # this rank's only tile
    dev = obj.nnz.device
    return dataclasses.replace(obj, **{
        name: torch.from_numpy(a).to(dev) for name, a in zip(names, arrays)})


def corrupt_spmat(site: str, m, nnz=None):
    """Fault hook for DistSpMat / DistSpMat3D operands at a comm boundary.
    ``nnz``: every tile's nnz, where the caller holds it already."""
    f = fire(site)
    if f is None:
        return m
    return _corrupt_obj(f, m, ("row", "col", "val", "nnz"), nnz)


def corrupt_spvec(site: str, v):
    """Fault hook for DistSpVec operands at a comm boundary."""
    f = fire(site)
    if f is None:
        return v
    return _corrupt_obj(f, v, ("idx", "val", "nnz"))


def corrupt_obj(site: str, obj):
    """Dispatch on the distributed container's fields (duck-typed)."""
    return corrupt_spvec(site, obj) if hasattr(obj, "idx") \
        else corrupt_spmat(site, obj)


def flip_ok(site: str, ok):
    """Flip a planner overflow flag to all-False (models a lying kernel).
    Every rank fires, so every rank reads the flipped flags."""
    f = fire(site)
    if f is None:
        return ok
    import torch
    return torch.zeros_like(ok)


def corrupt_bytes(site: str, data: bytes) -> bytes:
    """Fault hook for an in-memory byte stream (I/O read paths)."""
    f = fire(site)
    if f is None or not data:
        return data
    rng = _rng(f)
    if f.kind == "truncate":
        keep = max(1, int(len(data) * (1.0 - f.amount)))
        return data[:keep]
    buf = bytearray(data)
    k = max(1, int(len(buf) * min(f.amount, 1.0) * 0.05))
    for pos in rng.integers(0, len(buf), size=k):
        buf[pos] = int(rng.integers(0, 256))
    return bytes(buf)


def corrupt_file(site: str, path: str):
    """Fault hook for a file just written to disk (checkpoint leaves)."""
    f = fire(site)
    if f is None:
        return
    size = os.path.getsize(path)
    if f.kind == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(max(1, int(size * (1.0 - f.amount))))
        return
    rng = _rng(f)
    with open(path, "r+b") as fh:
        # flip bytes in the back half: past any .npy header, into the data
        for pos in rng.integers(size // 2, size, size=max(4, size // 256)):
            fh.seek(int(pos))
            b = fh.read(1)
            fh.seek(int(pos))
            fh.write(bytes([b[0] ^ 0xFF]))


def maybe_crash(site: str):
    """Raise InjectedCrash when a ``crash`` fault fires at ``site``."""
    f = fire(site)
    if f is not None:
        raise InjectedCrash(f"injected crash at {site} (hit {f.hits})")


def maybe_delay(site: str):
    """Sleep ``amount`` seconds when a ``delay`` fault fires (straggler)."""
    f = fire(site)
    if f is not None:
        time.sleep(f.amount)
