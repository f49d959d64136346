"""Tiered invariant auditor for the distributed sparse containers.

The port's copy of ``repro.robust.audit``. Every operand and result is a
capacity-padded COO tile family with hard invariants (DESIGN.md §3/§4.3):
live indices in tile bounds, ``SENTINEL`` padding exactly beyond ``nnz``,
``nnz ≤ cap``, and — for ``order='row'``/``'col'`` tagged objects —
strictly increasing packed keys per tile. This module checks them, at a
level chosen per run:

  ``REPRO_AUDIT=off``       (default) zero checks — hooks are one boolean
                            read.
  ``REPRO_AUDIT=boundary``  structural invariants + packed-key/value
                            checksums bracketing every communication stage
                            (the SUMMA/3D/SpMSpV operand boundaries). Each
                            check copies the operand to the host.
  ``REPRO_AUDIT=full``      boundary + sortedness/dedup/finiteness sweeps on
                            operands and results.

A failed check raises :class:`AuditError` naming the site; the planner's
retry loop (core/plan.py) treats that as a failed attempt — re-running from
the pristine inputs — and escalates to the degradation ladder
(robust/recover.py) when corruption persists.

**On a grid** each rank checks and checksums its own tile. Whether to
raise is decided collectively: the ranks gather each one's first failing
check (or the checksum verdict), and every rank raises at the same site,
or none does — a rank raising alone would leave the others waiting in the
next collective. The check raised is the first in check order that fails
on any tile, which is the one the JAX package raises over the whole
family. On the 1x1 grid :func:`checksum_obj` is the JAX package's CRC bit
for bit.

Like :mod:`faults`, this module imports nothing of ``core`` at module
scope (core imports us): containers are duck-typed on their fields, and
the grid's collective is imported where a decision needs it.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
import zlib

import numpy as np

from ..obs import recorder as _obs
from .faults import SENTINEL

OFF, BOUNDARY, FULL = 0, 1, 2
_NAMES = {"off": OFF, "boundary": BOUNDARY, "full": FULL}

_env_level: int | None = None
_override: list[int] = []


class AuditError(RuntimeError):
    """An invariant or checksum check failed at a named site."""

    def __init__(self, msg: str, site: str = "?"):
        super().__init__(msg)
        self.site = site


def level() -> int:
    global _env_level
    if _override:
        return _override[-1]
    if _env_level is None:
        name = os.environ.get("REPRO_AUDIT", "off").strip().lower()
        if name not in _NAMES:
            raise ValueError(f"REPRO_AUDIT={name!r}: want off|boundary|full")
        _env_level = _NAMES[name]
    return _env_level


def enabled() -> bool:
    return level() > OFF


@contextlib.contextmanager
def at_level(name: str):
    """Scoped override: ``with audit.at_level('full'): ...`` (tests)."""
    _override.append(_NAMES[name] if isinstance(name, str) else int(name))
    try:
        yield
    finally:
        _override.pop()


# --------------------------------------------------------------------------
# container views (duck-typed — no core import)
# --------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _views(obj):
    """(R, C|None, V, N, (bound_r, bound_c|None), order) host views of this
    rank's tiles.

    R/C are (ntile, cap) int, V (ntile, cap, ...), N (ntile,).
    """
    if hasattr(obj, "idx"):                      # DistSpVec
        I = _np(obj.idx)
        cap = I.shape[-1]
        V = _np(obj.val)
        return (I.reshape(-1, cap), None,
                V.reshape((-1, cap) + V.shape[I.ndim:]),
                _np(obj.nnz).reshape(-1), (obj.vb, None), "none")
    R = _np(obj.row)
    cap = R.shape[-1]
    if hasattr(obj, "block_sizes"):              # DistSpMat3D
        tr, tc = obj.block_sizes()
    else:                                        # DistSpMat
        tr, tc = obj.mb, obj.nb
    V = _np(obj.val)
    return (R.reshape(-1, cap), _np(obj.col).reshape(-1, cap),
            V.reshape((-1, cap) + V.shape[R.ndim:]),
            _np(obj.nnz).reshape(-1), (tr, tc),
            getattr(obj, "order", "none"))


def _keys(R, C, bounds, order):
    """Packed int64 per-entry keys in the tile's order (padding -> max)."""
    tr, tc = bounds
    if C is None:
        k = R.astype(np.int64)
        pad = R == SENTINEL
    else:
        pad = (R == SENTINEL) | (C == SENTINEL)
        if order == "col":
            k = C.astype(np.int64) * (tr + 1) + R.astype(np.int64)
        else:
            k = R.astype(np.int64) * (tc + 1) + C.astype(np.int64)
    return np.where(pad, np.iinfo(np.int64).max, k)


# --------------------------------------------------------------------------
# invariant checks
# --------------------------------------------------------------------------

# the checks in the order they run; a failure's code is its index + 1
_CHECKS = ("nnz outside [0, cap]",
           "SENTINEL row inside live region",
           "row index out of bounds",
           "non-canonical padding (row != SENTINEL beyond nnz)",
           "SENTINEL col inside live region",
           "col index out of bounds",
           "non-canonical padding (col != SENTINEL beyond nnz)",
           "non-finite value in live region",
           "order violated (keys not strictly increasing — unsorted or "
           "duplicate (row, col))",
           "duplicate sparse-vector index within a piece")


def _first_failure(R, C, V, N, bounds, order, where: str, lvl: int):
    """The first failing check on these tiles: ``(code, message)``, or
    None. The messages are the JAX package's."""
    cap = R.shape[-1]
    if (N < 0).any() or (N > cap).any():
        return 1, (f"{where}: nnz outside [0, cap={cap}] "
                   f"(min={N.min()}, max={N.max()})")
    live = np.arange(cap)[None, :] < N[:, None]
    tr, tc = bounds
    for base, name, A, bound in ((2, "row", R, tr), (5, "col", C, tc)):
        if A is None:
            continue
        if (A[live] == SENTINEL).any():
            return base, f"{where}: SENTINEL {name} inside live region"
        bad = A[live]
        if bad.size and (int(bad.min()) < 0 or int(bad.max()) >= bound):
            return base + 1, (
                f"{where}: {name} index out of bounds [0, {bound}) "
                f"(min={bad.min()}, max={bad.max()})")
        if (A[~live] != SENTINEL).any():
            return base + 2, (
                f"{where}: non-canonical padding ({name} != SENTINEL "
                "beyond nnz)")
    if lvl < FULL:
        return None
    if np.issubdtype(V.dtype, np.floating):
        Vl = V.reshape(V.shape[0], cap, -1)
        lv = live[:, :, None] & np.ones(Vl.shape[-1], bool)
        if not np.isfinite(Vl[lv]).all():
            return 8, f"{where}: non-finite value in live region"
    keys = _keys(R, C, bounds, order)
    if order in ("row", "col"):
        d = np.diff(keys, axis=-1)
        both_live = live[:, 1:] & live[:, :-1]
        if (d[both_live] <= 0).any():
            return 9, (
                f"{where}: order='{order}' violated (keys not strictly "
                "increasing — unsorted or duplicate (row, col))")
    elif C is None:
        # vectors carry no order tag; still reject duplicate indices
        ks = np.sort(np.where(live, keys, np.iinfo(np.int64).max), axis=-1)
        dup = (np.diff(ks, axis=-1) == 0) & (ks[:, :-1]
                                             != np.iinfo(np.int64).max)
        if dup.any():
            return 10, (f"{where}: duplicate sparse-vector index within a "
                        "piece")
    return None


def _gathered(obj, values):
    """Every rank's ``values`` (floats) as a host (ranks, len) array, the
    same on every rank; this rank's alone on the 1x1 grid."""
    if math.prod(obj.grid) == 1:
        return np.asarray([values], np.float64)
    import torch
    from ..core import comm
    x = torch.tensor(values, dtype=torch.float64, device=obj.nnz.device)
    return comm.gather_grid(x, obj.grid).reshape(-1, len(values))


def audit_obj(obj, where: str, min_level: int = BOUNDARY):
    """Validate a distributed container's invariants at the current level.

    On a grid every rank raises, with the first check in check order that
    fails on any tile, or none does."""
    lvl = level()
    if lvl < min_level:
        return
    fail = _first_failure(*_views(obj), where, lvl)
    codes = _gathered(obj, [fail[0] if fail else 0])[:, 0]
    failed = codes[codes > 0]
    if failed.size == 0:
        return
    code = int(failed.min())
    if fail is not None and fail[0] == code:
        raise AuditError(fail[1], where)
    ranks = np.nonzero(codes == code)[0].tolist()
    raise AuditError(f"{where}: {_CHECKS[code - 1]} (on rank(s) {ranks})",
                     where)



# --------------------------------------------------------------------------
# checksums + communication bracketing
# --------------------------------------------------------------------------

def checksum_obj(obj) -> int:
    """CRC32 over (nnz, live packed keys, live values) of this rank's tiles
    — stored order."""
    R, C, V, N, bounds, order = _views(obj)
    cap = R.shape[-1]
    live = np.arange(cap)[None, :] < N[:, None]
    keys = _keys(R, C, bounds, order)
    crc = zlib.crc32(np.ascontiguousarray(N, np.int64).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(keys[live]).tobytes(), crc)
    Vl = V.reshape(V.shape[0], cap, -1)
    lv = live[:, :, None] & np.ones(Vl.shape[-1], bool)
    crc = zlib.crc32(np.ascontiguousarray(Vl[lv]).tobytes(), crc)
    return crc


def payload_nbytes(obj) -> int:
    """Live wire-payload bytes of this rank's tiles: Σnnz × per-entry bytes.

    Index dtypes + the value payload (including trailing vdims) per live
    entry — the volume a real wire would move, and the quantity the
    ``comm.bytes.*`` counters accumulate. Derives only from nnz and dtypes
    (one host copy of the nnz array).
    """
    n = int(obj.nnz.sum())
    if hasattr(obj, "idx"):                      # DistSpVec
        base_ndim = obj.idx.dim()
        per = obj.idx.element_size()
    else:                                        # DistSpMat / DistSpMat3D
        base_ndim = obj.row.dim()
        per = obj.row.element_size() + obj.col.element_size()
    vper = obj.val.element_size()
    for d in obj.val.shape[base_ndim:]:
        vper *= d
    return n * (per + vper)


def guard_exchange(site: str, obj):
    """Bracket one communication stage.

    checksum(pre) → apply any armed fault (the simulated in-flight
    corruption, on copies: the caller's operand stays pristine) →
    checksum(post); a mismatch on any rank raises :class:`AuditError` on
    every rank. At audit level off the fault passes through undetected
    (the documented trade); with nothing armed, auditing off and the
    deadline guard disabled this is three boolean reads.

    The whole bracket runs under the wall-time deadline of
    ``robust/deadline.ExchangeGuard``: a straggling exchange — provoked by
    a ``delay`` fault at ``dist.exchange_deadline``, which sleeps inside
    the timed region — raises
    :class:`~repro_torch.robust.deadline.ExchangeTimeout` on every rank.

    On a grid the bracket ends in at most one gather: each rank's
    checksum verdict, elapsed time and budget. Below ``boundary`` the
    region holds no checksum, so the default guard there times nothing
    and gathers nothing; a guard installed on purpose
    (``deadline.configured()``) still gathers, so a straggler armed on one
    rank only trips every rank. Which faults are armed may differ by rank,
    so it steers no collective.
    """
    from . import deadline, faults
    f_on = faults.enabled()
    lvl = level()
    obs_on = _obs.recording()
    guard = deadline.active_guard()
    if not f_on and lvl < BOUNDARY and guard is None and not obs_on:
        return obj
    if obs_on:
        # the comm-volume tier: this rank's live payload bytes at every
        # guarded boundary, under a per-site span (DESIGN.md §9)
        _obs.counter_add("comm.bytes." + site, payload_nbytes(obj))
    if guard is not None and lvl < BOUNDARY and math.prod(obj.grid) > 1 \
            and not deadline.configured():
        guard = None
    with _obs.span(site):
        try:
            t0 = time.monotonic()
            faults.maybe_delay(deadline.DELAY_SITE)
            pre = checksum_obj(obj) if lvl >= BOUNDARY else None
            if f_on:
                obj = faults.corrupt_obj(site, obj)
            post = checksum_obj(obj) if pre is not None else None
            if pre is None and guard is None:
                return obj
            dt = time.monotonic() - t0
            rows = _gathered(obj, [float(post != pre), dt,
                                   guard.budget(site) if guard else 0.0])
            bad = rows[:, 0]
            if bad.any():
                if post != pre:
                    raise AuditError(
                        f"{site}: packed-key/value checksum mismatch "
                        f"across exchange ({pre:#010x} -> {post:#010x})",
                        site)
                raise AuditError(
                    f"{site}: packed-key/value checksum mismatch across "
                    f"exchange (on rank(s) {np.nonzero(bad)[0].tolist()})",
                    site)
            if guard is not None:
                guard.settle(site, dt, rows[:, 1:])
        except AuditError as err:
            # the guard already evented its own trips; only plain
            # checksum/invariant failures are counted here
            from .deadline import ExchangeTimeout
            if not isinstance(err, ExchangeTimeout):
                _obs.event("audit.failure", site=site, error=str(err))
                _obs.counter_add("audit.failures")
            raise
    return obj
