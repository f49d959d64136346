"""Host-side flight recorder: spans, counters and structured events.

The port's own copy of ``repro``'s recorder, with the same span and event
names, so traces of the two packages read alike. Design rules:

1. **Near-zero overhead when disabled.** Every hook starts with one read
   of the module-level ``_enabled`` boolean and returns immediately —
   ``span()`` hands back a shared no-op singleton, ``counter_add``/``event``
   return before touching any state. Raw values are stored and stringified
   only when read.
2. **Host boundaries only.** Hooks sit in host-level code. PyTorch runs
   eagerly, so there is no trace to guard against; instead :func:`sync`
   waits for the GPU while recording, so a span covers device execution,
   not just the asynchronous launch.
3. **Deterministic metrics.** Counter and event values derive only from
   data sizes and control-flow decisions (caps, retry counts), so two
   identically-seeded runs produce identical totals.

Enablement, as in the JAX package: ``REPRO_TRACE=<path>`` (Chrome-trace
dump at exit, ``export.py``) or ``REPRO_OBS=1`` (record and
``snapshot()`` only) at import, or :func:`enable` / the scoped
:func:`capture` at runtime. The port's ranks are processes that share one
environment, so ``REPRO_TRACE`` names one path for all of them: a process
that joined a world of several ranks (``core/comm.py::init_world`` calls
:func:`set_rank`) writes ``<stem>.rank<r><suffix>`` beside it, one file a
rank (``trace.json`` -> ``trace.rank0.json``, ``trace.rank1.json``, ...).

This module imports nothing of the port (robust and core import it).
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
import time
from typing import Any

_lock = threading.Lock()
_tls = threading.local()

_enabled = False                 # THE fast-path check — one module global
_epoch_perf = 0.0                # perf_counter() at enable-time (t=0)
_epoch_wall = 0.0                # matching wall-clock epoch (seconds)
_rank = None                     # (rank, world) once this process joined one

# finished spans: (name, tid, t0, dur, depth, attrs)   [t0 rel. epoch_perf]
_spans: list[tuple] = []
# instant events: (name, tid, t, attrs)
_events: list[tuple] = []
# counters: monotonic totals + a (name, t, total) series for counter
# tracks; gauges: last value by name, every setting in the same series
_counters: dict[str, float] = {}
_counter_series: list[tuple] = []
_gauges: dict[str, float] = {}

_MAX_RECORDS = 1_000_000         # backstop against unbounded growth


def tracing() -> bool:
    """False: the JAX package's guard against hooks reached from inside
    jax tracing (jit, shard_map, scan). The port runs eagerly, so a hook is
    never called from inside a trace."""
    return False


def enabled() -> bool:
    """The raw switch — cheapest possible read."""
    return _enabled


def recording() -> bool:
    """True when hooks should record: enabled and not tracing (never, in
    the port). Guard any host transfer made only for observability with it
    (summing ``nnz`` for the payload-byte counters)."""
    return _enabled and not tracing()


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class _NoopSpan:
    """Shared do-nothing span — what ``span()`` returns when disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0", "depth")

    def __init__(self, name: str, attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        self.depth = len(stack)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:                    # exited out of order
            stack.remove(self)
        with _lock:
            if len(_spans) < _MAX_RECORDS:
                _spans.append((self.name, threading.get_ident(),
                               self.t0 - _epoch_perf, dur, self.depth,
                               self.attrs))
        return False


def span(name: str, **attrs):
    """Context manager timing one host-side region (thread-safe, nestable);
    a shared no-op when disabled."""
    if not _enabled:
        return _NOOP
    return _Span(name, attrs)


def timed(name: str, **attrs):
    """Decorator form of :func:`span` for whole host-level functions."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            with span(name, **attrs):
                return fn(*a, **kw)
        return wrapper
    return deco


def sync(device) -> None:
    """``torch.cuda.synchronize(device)`` while recording on a CUDA device
    (else free), so the enclosing span covers the device's work."""
    if _enabled and getattr(device, "type", device) == "cuda":
        import torch
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# metrics: counters / instant events
# --------------------------------------------------------------------------

def counter_add(name: str, value: float = 1):
    """Add to a monotonic counter (also sampled for the trace track)."""
    if not _enabled:
        return
    t = time.perf_counter() - _epoch_perf
    with _lock:
        total = _counters.get(name, 0) + value
        _counters[name] = total
        if len(_counter_series) < _MAX_RECORDS:
            _counter_series.append((name, t, total))


def gauge_set(name: str, value: float):
    """Set a gauge (a level, not a total); every setting is kept in
    order."""
    if not _enabled:
        return
    t = time.perf_counter() - _epoch_perf
    with _lock:
        _gauges[name] = value
        if len(_counter_series) < _MAX_RECORDS:
            _counter_series.append((name, t, value))


def event(name: str, **attrs):
    """Record an instant structured event (planner decision, retry)."""
    if not _enabled:
        return
    t = time.perf_counter() - _epoch_perf
    with _lock:
        if len(_events) < _MAX_RECORDS:
            _events.append((name, threading.get_ident(), t, attrs))


def counters() -> dict[str, float]:
    """The counters' totals, a copy."""
    with _lock:
        return dict(_counters)


def events(name: str | None = None) -> list[dict]:
    """Recorded instant events as plain dicts (newest last)."""
    with _lock:
        evs = list(_events)
    return [dict(name=n, t=t, **a) for n, _tid, t, a in evs
            if name is None or n == name]


# --------------------------------------------------------------------------
# lifecycle
# --------------------------------------------------------------------------

def enable():
    """Start recording (idempotent). The epoch anchors trace timestamps."""
    global _enabled, _epoch_perf, _epoch_wall
    if _enabled:
        return
    _epoch_perf = time.perf_counter()
    _epoch_wall = time.time()
    _enabled = True


def disable():
    """Stop recording; what was recorded stays."""
    global _enabled
    _enabled = False


def set_rank(rank: int, world: int):
    """Note this process's rank in a world of ``world`` ranks: its trace
    file takes the rank in its name (kept after the world is left, for the
    dump at exit)."""
    global _rank
    _rank = (int(rank), int(world))


def trace_path(path: str) -> str:
    """Where this process writes the trace that ``REPRO_TRACE=path``
    names: ``path`` itself, or ``<stem>.rank<r><suffix>`` in a world of
    several ranks."""
    if _rank is None or _rank[1] <= 1:
        return path
    stem, suffix = os.path.splitext(path)
    return f"{stem}.rank{_rank[0]}{suffix}"


def reset():
    """Clear every recorded span, event, counter and gauge (keeps the
    enabled state)."""
    with _lock:
        _spans.clear()
        _events.clear()
        _counters.clear()
        _counter_series.clear()
        _gauges.clear()


@contextlib.contextmanager
def capture():
    """Scoped recording into fresh buffers; prior state restored on exit.

    ``with obs.capture() as rec: ... rec.snapshot()`` never leaks spans
    into (or inherits spans from) the surrounding run. Yields the
    ``repro_torch.obs`` package, so callers can ``rec.snapshot()``,
    ``rec.coverage(...)``, ``rec.trace_events()``, ``rec.write_trace(path)``.
    """
    global _enabled
    with _lock:
        saved = (_enabled, list(_spans), list(_events), dict(_counters),
                 list(_counter_series), dict(_gauges))
        _spans.clear()
        _events.clear()
        _counters.clear()
        _counter_series.clear()
        _gauges.clear()
    _enabled = False
    enable()
    try:
        yield sys.modules[__package__]
    finally:
        with _lock:
            _enabled = saved[0]
            _spans[:] = saved[1]
            _events[:] = saved[2]
            _counters.clear()
            _counters.update(saved[3])
            _counter_series[:] = saved[4]
            _gauges.clear()
            _gauges.update(saved[5])


# --------------------------------------------------------------------------
# aggregation
# --------------------------------------------------------------------------

def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def snapshot() -> dict[str, Any]:
    """Plain-dict summary: per-site span stats + counter/gauge totals.

    ``{"spans": {site: {count, total_us, p50_us, p99_us}},
       "counters": {...}, "gauges": {...}, "events": {name: count},
       "deadline": {site: {n, median_s, budget_s, trips}}}``

    The deadline section is pulled live from ``robust/deadline``'s active
    guard (a lazy import: obs stays free of the port's other modules), and
    is left out when no guard has a site.
    """
    with _lock:
        spans = list(_spans)
        evs = list(_events)
        cts = dict(_counters)
        gs = dict(_gauges)
    per_site: dict[str, list[float]] = {}
    for name, _tid, _t0, dur, _depth, _attrs in spans:
        per_site.setdefault(name, []).append(dur * 1e6)
    span_stats = {}
    for name, durs in sorted(per_site.items()):
        durs.sort()
        span_stats[name] = {
            "count": len(durs),
            "total_us": round(sum(durs), 1),
            "p50_us": round(_percentile(durs, 0.50), 1),
            "p99_us": round(_percentile(durs, 0.99), 1),
        }
    ev_counts: dict[str, int] = {}
    for name, _tid, _t, _attrs in evs:
        ev_counts[name] = ev_counts.get(name, 0) + 1
    out = {"spans": span_stats, "counters": cts, "gauges": gs,
           "events": ev_counts}
    dl = _deadline_stats()
    if dl:
        out["deadline"] = dl
    return out


def _deadline_stats() -> dict:
    from ..robust import deadline
    g = deadline.active_guard()
    if g is None:
        return {}
    return {site: g.stats(site) for site in g.sites()}


def coverage(parent: str) -> float:
    """Fraction of ``parent`` span time covered by directly-nested spans.

    For every finished span named ``parent``, sums the durations of spans
    one level deeper on the same thread whose window falls inside the
    parent's, and divides by the summed parent durations (the JAX
    package's definition).
    """
    with _lock:
        spans = list(_spans)
    parents = [(tid, t0, dur, depth) for name, tid, t0, dur, depth, _ in spans
               if name == parent]
    if not parents:
        return 0.0
    total = sum(p[2] for p in parents)
    covered = 0.0
    for name, tid, t0, dur, depth, _ in spans:
        if name == parent:
            continue
        for ptid, pt0, pdur, pdepth in parents:
            if tid == ptid and depth == pdepth + 1 \
                    and pt0 <= t0 and t0 + dur <= pt0 + pdur + 1e-9:
                covered += dur
                break
    return covered / max(total, 1e-12)


def _raw_records():
    """(spans, events, counter_series, epoch_wall) for the trace export."""
    with _lock:
        return (list(_spans), list(_events), list(_counter_series),
                _epoch_wall)


# --------------------------------------------------------------------------
# environment init (REPRO_TRACE=<path> | REPRO_OBS=1)
# --------------------------------------------------------------------------

def _env_init():
    path = os.environ.get("REPRO_TRACE", "").strip()
    if path:
        enable()
        import atexit

        def _dump(path=path):
            # lazy: export imports this module
            from . import export
            export.write_trace(trace_path(path))

        atexit.register(_dump)
    elif os.environ.get("REPRO_OBS", "").strip() not in ("", "0"):
        enable()


_env_init()
