"""Wall-time exchange deadlines, seeded retry backoff, topology errors.

The port's copy of ``repro.robust.deadline``. The fault/audit tier
recovers from *data* faults — corrupted payloads caught by checksum
brackets. This module adds the *topology* tier: a hung collective or a
persistently straggling peer produces no checksum mismatch at all. The
:class:`ExchangeGuard` wraps the same comm boundaries that
``audit.guard_exchange`` brackets and gives each site a wall-time deadline
learned from a trailing-median model (``launch/elastic.StepWatchdog``
generalized from per-step to per-site):

  * **Warmup.** With fewer than ``min_samples`` recorded exchanges at a
    site, the budget is the flat ``startup_deadline`` (default 60 s).
  * **Steady state.** Budget = ``max(floor, grace × trailing median)``.
    The floor keeps a fast site from tripping on an unrelated host hiccup.
  * **Escalation** is owned by the planner retry loops (core/plan.py):
    an :class:`ExchangeTimeout` (an ``AuditError`` subclass) is retried
    from pristine inputs with deterministic seeded exponential backoff,
    then shed to the ``serial-schedule`` ladder rung, and only when the
    ladder is exhausted escalates to :class:`TopologyError`.

**On a grid** budgets are learned per rank, so the trip decision is made
collectively after the watched region: ``audit.guard_exchange`` gathers
each rank's elapsed time and budget (in the same gather as its checksum
verdict) and every rank settles the trip on the gathered rows
(:meth:`ExchangeGuard.settle`): when any rank ran over its budget every
rank raises :class:`ExchangeTimeout` together — a delay armed on one rank
only still ends in every rank retrying (after the same seeded backoff).
Below the ``boundary`` audit the bracket has nothing of its own to time,
so on a grid it gathers only under a guard installed on purpose
(:func:`configure`, or ``REPRO_DEADLINE=<seconds>``: :func:`configured`);
the default guard adds no collective there.

Determinism: backoff delays are drawn from ``numpy.random.default_rng``
keyed on (``REPRO_FAULT_SEED``, site, attempt) — the same draws as the JAX
package. Stragglers are provoked on demand through the
``dist.exchange_deadline`` fault site (a ``delay`` fault armed there
sleeps inside the timed region of whichever guarded exchange runs next).

Like the rest of ``repro_torch.robust``, this module imports nothing of
``core`` at module scope (core imports us).
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings
import zlib
from collections import deque

import numpy as np

from ..obs import recorder as _obs
from . import faults
from .audit import AuditError

# Fault site whose armed ``delay`` fires inside the timed region of the
# next guarded exchange — the deterministic stand-in for a hung collective.
DELAY_SITE = "dist.exchange_deadline"


class TopologyError(RuntimeError):
    """The process topology is no longer serviceable at a named site.

    Raised when the degradation ladder is exhausted under a persistent
    exchange deadline, or by an injected ``loop.device_loss`` fault. The
    ``CheckpointedLoop`` responds by checkpointing the last completed
    iteration and calling its ``on_topology`` hook, or re-raising.
    """

    def __init__(self, msg: str, site: str = "?"):
        super().__init__(msg)
        self.site = site


class ExchangeTimeout(AuditError):
    """A guarded exchange exceeded its wall-time budget.

    Subclasses :class:`AuditError` so the planner retry loops treat a
    deadline trip exactly like a failed checksum — retry from pristine
    inputs — while ``isinstance`` checks can still tell the two apart
    (timeouts additionally back off and escalate to TopologyError).
    """

    def __init__(self, site: str, elapsed: float, budget: float):
        super().__init__(
            f"{site}: exchange exceeded wall-time deadline "
            f"({elapsed:.3f}s > budget {budget:.3f}s)", site)
        self.elapsed = elapsed
        self.budget_s = budget


class ExchangeGuard:
    """Per-site wall-time deadlines from a trailing-median model."""

    def __init__(self, *, grace: float = 4.0, window: int = 32,
                 min_samples: int = 5, floor: float = 1.0,
                 startup_deadline: float = 60.0,
                 backoff_base: float = 0.05, backoff_cap: float = 5.0,
                 max_retries: int = 3):
        self.grace = grace
        self.window = window
        self.min_samples = min_samples
        self.floor = floor
        self.startup_deadline = startup_deadline
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.max_retries = max_retries
        self._times: dict[str, deque] = {}
        self._trips: dict[str, int] = {}

    def budget(self, site: str) -> float:
        """Current wall-time budget for one exchange at ``site``."""
        ts = self._times.get(site)
        if ts is None or len(ts) < self.min_samples:
            return self.startup_deadline
        med = sorted(ts)[len(ts) // 2]
        return max(self.floor, med * self.grace)

    def record(self, site: str, dt: float):
        self._times.setdefault(site, deque(maxlen=self.window)).append(dt)

    def samples(self, site: str) -> int:
        return len(self._times.get(site, ()))

    def trips(self, site: str) -> int:
        """Deadline trips recorded at ``site`` (survives :meth:`reset`)."""
        return self._trips.get(site, 0)

    def sites(self) -> list[str]:
        """Every site with recorded samples or trips (sorted)."""
        return sorted(set(self._times) | set(self._trips))

    def stats(self, site: str) -> dict:
        """Public window state: ``{n, median_s, budget_s, trips}``.

        The supported way to inspect a site's timing model (obs.snapshot
        embeds this per site) — callers must not reach into ``_times``.
        ``median_s`` is None during warmup (fewer than one sample).
        """
        ts = self._times.get(site)
        n = len(ts) if ts else 0
        med = float(sorted(ts)[n // 2]) if n else None
        return {"n": n, "median_s": med,
                "budget_s": float(self.budget(site)),
                "trips": self.trips(site)}

    def reset(self, site: str | None = None):
        """Forget trailing times — for all sites or one.

        Called after a topology change or a schedule-ladder descent: the
        new configuration's exchanges have different timing, so budgets
        learned from the old one would either mask a regression or trip
        spuriously. Trip counts are diagnostics, not a timing model — they
        deliberately survive the reset.
        """
        if site is None:
            self._times.clear()
        else:
            self._times.pop(site, None)

    @contextlib.contextmanager
    def watch(self, site: str):
        """Time one exchange at ``site``; raise ExchangeTimeout over budget.

        The ``dist.exchange_deadline`` delay fault fires *inside* the timed
        region, so an armed straggler is seen exactly as a slow wire would
        be. This rank's decision alone: on a grid of several ranks
        ``audit.guard_exchange`` gathers the ranks' times and calls
        :meth:`settle` on every rank instead.
        """
        t0 = time.monotonic()
        faults.maybe_delay(DELAY_SITE)
        yield
        dt = time.monotonic() - t0
        self.settle(site, dt, [(dt, self.budget(site))])

    def settle(self, site: str, dt: float, rows):
        """Trip or record one exchange that took this rank ``dt`` seconds.

        ``rows`` holds every rank's (elapsed, budget) — the same on every
        rank — and the rank furthest over its budget trips every rank.
        Tripped times are NOT recorded — a straggler must not poison the
        trailing median it is judged against.
        """
        eb = np.asarray(rows, np.float64).reshape(-1, 2)
        over = eb[:, 0] - eb[:, 1]
        r = int(np.argmax(over))
        if over[r] > 0:
            dt_w, b_w = float(eb[r, 0]), float(eb[r, 1])
            self._trips[site] = self._trips.get(site, 0) + 1
            _obs.event("deadline.trip", site=site, elapsed_s=dt_w,
                       budget_s=b_w)
            _obs.counter_add("deadline.trips")
            raise ExchangeTimeout(site, dt_w, b_w)
        self.record(site, dt)

    def backoff_delay(self, site: str, attempt: int) -> float:
        """Deterministic seeded exponential backoff before retry ``attempt``.

        ``min(cap, base·2^(attempt-1))`` jittered to 50–150 % by an rng
        keyed on (global fault seed, site, attempt) — reproducible under a
        pinned ``REPRO_FAULT_SEED``, decorrelated across sites.
        """
        rng = np.random.default_rng(
            faults.global_seed() ^ zlib.crc32(site.encode())
            ^ (int(attempt) << 20))
        base = min(self.backoff_cap, self.backoff_base * 2 ** (attempt - 1))
        return base * (0.5 + float(rng.random()))


# --------------------------------------------------------------------------
# module-level default guard (what audit.guard_exchange and plan.py use)
# --------------------------------------------------------------------------

_GUARD: ExchangeGuard | None = None
_CONFIGURED = False          # the guard was set on purpose, not defaulted
_env_checked = False


def _default_guard() -> ExchangeGuard | None:
    """Build the guard from the environment on first use.

    ``REPRO_DEADLINE=off`` disables deadline enforcement entirely (the
    delay fault site still fires); a float value overrides
    ``startup_deadline``; unset/``auto`` uses the defaults.
    """
    global _GUARD, _CONFIGURED, _env_checked
    if not _env_checked:
        _env_checked = True
        spec = os.environ.get("REPRO_DEADLINE", "auto").strip().lower()
        if spec == "off":
            _GUARD = None
        elif spec in ("", "auto"):
            _GUARD = ExchangeGuard()
        else:
            _GUARD = ExchangeGuard(startup_deadline=float(spec))
            _CONFIGURED = True
    return _GUARD


def active_guard() -> ExchangeGuard | None:
    return _default_guard()


def enabled() -> bool:
    return _default_guard() is not None


def configured() -> bool:
    """Whether the active guard was installed on purpose — by
    :func:`configure` or ``REPRO_DEADLINE=<seconds>`` — rather than
    defaulted. The same on every rank of a grid whose ranks enter the same
    ``configure`` scopes, so it may steer a collective."""
    return _default_guard() is not None and _CONFIGURED


@contextlib.contextmanager
def configure(**kw):
    """Scoped override guard: ``with deadline.configure(floor=0.05): ...``.

    Installs a fresh :class:`ExchangeGuard` built with ``kw`` for the scope
    (tests, chaos runs); the previous guard — and its learned budgets — is
    restored on exit. ``configure(off=True)`` disables enforcement.
    """
    global _GUARD, _CONFIGURED, _env_checked
    _default_guard()
    prev = _GUARD, _CONFIGURED
    _GUARD = None if kw.pop("off", False) else ExchangeGuard(**kw)
    _CONFIGURED = True
    try:
        yield _GUARD
    finally:
        _GUARD, _CONFIGURED = prev


@contextlib.contextmanager
def watch(site: str):
    """Module-level watch using the active guard (no-op timing when off)."""
    g = _default_guard()
    if g is None:
        # enforcement off: still fire any armed straggler fault so chaos
        # specs behave identically with and without the guard
        faults.maybe_delay(DELAY_SITE)
        yield
        return
    with g.watch(site):
        yield


def reset(site: str | None = None):
    g = _default_guard()
    if g is not None:
        g.reset(site)


def stats(site: str) -> dict:
    """Module-level :meth:`ExchangeGuard.stats` on the active guard.

    ``{n: 0, median_s: None, budget_s: None, trips: 0}`` when deadline
    enforcement is off — callers never touch guard internals.
    """
    g = _default_guard()
    if g is None:
        return {"n": 0, "median_s": None, "budget_s": None, "trips": 0}
    return g.stats(site)


def sites() -> list[str]:
    """Sites the active guard has state for (empty when off)."""
    g = _default_guard()
    return g.sites() if g is not None else []


def backoff_sleep(site: str, attempt: int):
    """Warn + sleep the deterministic backoff before retry ``attempt``."""
    g = _default_guard()
    if g is None:
        return
    d = g.backoff_delay(site, attempt)
    _obs.event("deadline.backoff", site=site, attempt=attempt, delay_s=d)
    _obs.counter_add("deadline.backoffs")
    warnings.warn(
        f"robust: exchange deadline at {site} — backing off {d * 1e3:.1f}ms "
        f"before retry {attempt}", RuntimeWarning, stacklevel=3)
    time.sleep(d)


def maybe_device_loss(site: str = "loop.device_loss"):
    """Raise :class:`TopologyError` when a fault fires at ``site``.

    Any fault kind armed at the site triggers the loss — ``crash`` is the
    conventional spec (``loop.device_loss:crash:at=4``). This models the
    runtime noticing a peer is gone at an iteration boundary.
    """
    f = faults.fire(site)
    if f is not None:
        raise TopologyError(
            f"injected device loss at {site} (hit {f.hits})", site)
