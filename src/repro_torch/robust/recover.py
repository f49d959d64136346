"""Graceful degradation + checkpointed iteration for long-running workloads.

The port's copy of ``repro.robust.recover``. Two recovery mechanisms, both
loud (one warning per decision, the decision recorded where the caller can
see it):

**The degradation ladder.** When a planned multiply keeps failing — audit
checksum mismatches that survive plain retries, or overflow flags still
false at the worst-case capacity ceiling — the planner walks a documented
ladder of progressively more conservative pipeline configurations instead
of dying (DESIGN.md §8):

    1. ``serial-schedule``      overlapped / hybrid / compressed exchange
                                schedule -> bulk-synchronous Cannon rotation
                                (overlap off, compression off). The
                                recorded entry names WHICH schedule features
                                were abandoned: ``serial-schedule:overlap+
                                schedule=hybrid+compress=int8``.
    2. ``postfilter``           fused masked multiply  -> unmasked multiply
                                + explicit post-filter
    3. ``sort-merge``           deferred/incremental merge engine -> the
                                seed concat-and-sort merge
    4. ``legacy-dedup``         packed-key dedup -> the seed two-key sort
                                (process-global: ``merge.force_legacy_dedup``)
    5. ``pure-jax-segreduce``   the JAX package's rung: its accelerator
                                segmented-reduce kernel -> its pure-JAX
                                paths. Never offered in the port.

Each rung taken is appended to the plan's ``degraded`` tuple (rungs that
abandon a configuration record it after a ``:``). Rung 4 flips a
process-global switch until :func:`reset_degradation`.

**Why rung 5 is never offered.** The port dispatches its segmented-reduce
kernel by device alone: a CUDA tensor launches the kernel, a CPU tensor
runs the plain version, and there is no switch and no fallback from one to
the other (ROADMAP.md's ground rules). So there is nothing for the rung to
uninstall, and :func:`next_rung` skips it — which is what the JAX package
does on a CPU or GPU once its lazy backend has resolved to none.
``LADDER`` and ``_RUNGS`` keep the name so ``plan.degraded`` speaks one
vocabulary in both packages. Whether the port should have such a rung (a
second kernel route to shed to) is an open design question (ROADMAP.md).

**CheckpointedLoop.** Iterative apps (PageRank / HipMCL / FastSV) wrap
their iteration in this class to get per-iteration checkpoint/resume in
the ``train/checkpoint.py`` atomic-dir format: state is a flat ``{name:
array}`` dict, saved after each iteration, restored (CRC-verified, falling
back past corrupted steps) on restart. Because each app's loop body is a
pure function of its state dict, a crashed-and-resumed run replays the
remaining iterations bitwise-identically to an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from ..obs import recorder as _obs
from . import faults
from .deadline import TopologyError, maybe_device_loss

LADDER = ("serial-schedule", "postfilter", "sort-merge", "legacy-dedup",
          "pure-jax-segreduce")

# Rungs meaningful per planned-op family (SpMSpV has no merge-engine path
# and no overlapped/compressed exchange schedule).
_RUNGS = {"spgemm": LADDER,
          "spmspv": ("postfilter", "pure-jax-segreduce")}


def _fancy_schedule(plan) -> list:
    """Schedule features the 'serial-schedule' rung would abandon."""
    desc = []
    if getattr(plan, "overlap", False):
        desc.append("overlap")
    s = getattr(plan, "schedule", None)
    if s not in (None, "rotate"):
        desc.append("schedule=" + (s if isinstance(s, str) else "hybrid"))
    if getattr(plan, "compress", None) is not None:
        desc.append(f"compress={plan.compress}")
    return desc


def next_rung(plan, mask, kind: str = "spgemm") -> str | None:
    """First untried, applicable ladder rung for ``plan`` (None = exhausted)."""
    # rungs that abandon a configuration record it as 'rung:<what>' — match
    # on the rung name so a taken rung is never offered twice
    taken = {t.split(":", 1)[0] for t in getattr(plan, "degraded", ())}
    for rung in _RUNGS[kind]:
        if rung in taken:
            continue
        if rung == "serial-schedule":
            if _fancy_schedule(plan):
                return rung
        elif rung == "postfilter":
            if mask is not None:
                return rung
        elif rung == "sort-merge":
            if getattr(plan, "merge", "sort") != "sort":
                return rung
        elif rung == "legacy-dedup":
            from ..core import merge
            if not merge.legacy_dedup_forced():
                return rung
        # 'pure-jax-segreduce': the port has no kernel switch to shed
    return None


def apply_rung(rung: str, plan):
    """Take ``rung``: warn once, flip switches, record it on the plan.

    The ``postfilter`` rung only records the decision — the caller owns the
    mask and must drop it (and post-apply it) itself, re-planning capacities
    for the unmasked output.
    """
    if rung == "pure-jax-segreduce":
        raise ValueError(
            "the port has no 'pure-jax-segreduce' rung: segreduce is "
            "dispatched by device, with no fallback from the kernel")
    warnings.warn(
        f"robust: degrading pipeline -> {rung!r} "
        f"(after {getattr(plan, 'attempts', '?')} attempts; "
        f"ladder so far: {getattr(plan, 'degraded', ())})",
        RuntimeWarning, stacklevel=3)
    _obs.event("ladder.rung", rung=rung,
               attempts=getattr(plan, "attempts", None),
               prior=",".join(getattr(plan, "degraded", ())))
    _obs.counter_add("ladder.rungs")
    kw = dict(degraded=tuple(getattr(plan, "degraded", ())) + (rung,))
    if rung == "serial-schedule":
        # record WHICH schedule configuration was abandoned
        what = "+".join(_fancy_schedule(plan)) or "none"
        kw["degraded"] = tuple(getattr(plan, "degraded", ())) \
            + (f"{rung}:{what}",)
        kw.update(overlap=False, schedule="rotate", compress=None,
                  variant="rotation")
    elif rung == "sort-merge" and hasattr(plan, "merge"):
        kw["merge"] = "sort"
    elif rung == "legacy-dedup":
        from ..core import merge
        merge.force_legacy_dedup(True)
        if hasattr(plan, "merge"):
            kw["merge"] = "sort"    # the legacy dedup lives on the sort path
    return dataclasses.replace(plan, **{k: v for k, v in kw.items()
                                        if hasattr(plan, k)})


def reset_degradation():
    """Undo the process-global rungs (tests; a fresh job starts clean)."""
    from ..core import merge
    merge.force_legacy_dedup(False)


# --------------------------------------------------------------------------
# explicit post-filters (the semantics the `postfilter` rung falls back to)
# --------------------------------------------------------------------------

def postfilter_2d(c, mask, sr, *, mesh):
    """Apply MaskSpec semantics to an already-computed unmasked C."""
    from ..core.mask import apply_val_pred, filter_tile, local_mask
    from ..core.matops import mat_apply_local, mat_ewise_local
    if mask.mat is not None:
        def fn(tc, tm):
            lm = local_mask(tm, pred=mask.pred, complement=mask.complement)
            return filter_tile(tc, lm, sr.add.identity)
        c = mat_ewise_local(c, mask.mat, fn, mesh=mesh)
    if mask.val_pred is not None:
        c = mat_apply_local(
            c, lambda t: apply_val_pred(t, mask.val_pred, sr.add.identity),
            mesh=mesh)
    return c


def postfilter_spvec(y, mask):
    """Apply a vector MaskSpec to an already-computed unmasked SpMSpV y."""
    import torch
    from ..core.matops import spvec_mask
    pred = mask.pred
    if mask.complement:
        return spvec_mask(y, mask.vec,
                          lambda xv, vv: ~torch.as_tensor(pred(vv)))
    return spvec_mask(y, mask.vec, lambda xv, vv: torch.as_tensor(pred(vv)))


# --------------------------------------------------------------------------
# checkpointed iteration
# --------------------------------------------------------------------------

_DONE_KEY = "__loop_done__"


def _release_cache():
    """Hand the card's cached blocks back (a retired rank computes no
    more; its peers may share the card)."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class CheckpointedLoop:
    """Per-iteration checkpoint/resume for iterative graph apps.

    ``state`` is a FLAT dict of arrays (so restore needs no shape template —
    iterates like HipMCL's change capacity between iterations) and ``body``
    is ``body(it, state) -> (state, done)``, pure given ``state``. With
    ``ckpt_dir=None`` the loop runs bare (identical iteration sequence, no
    I/O) — the bitwise-resume contract is exactly that a crashed run,
    restarted with the same ``ckpt_dir``, finishes with the same state as
    the bare run. On a grid the state is global host arrays, the same on
    every rank: rank 0 writes each checkpoint, every rank reads
    (``train/checkpoint.py``).

    Fault sites: ``loop.crash`` (InjectedCrash at iteration start, before
    any state mutation), ``loop.delay`` (straggler sleep; flagged through
    the optional ``launch.elastic.StepWatchdog``) and ``loop.device_loss``
    (TopologyError at iteration start).

    **Topology faults.** A :class:`TopologyError` — injected device loss,
    or a planned multiply whose degradation ladder was exhausted under a
    persistent exchange deadline — is caught at the iteration boundary:
    the last completed state is checkpointed, then

      * with an ``on_topology(state, err) -> state`` hook, the hook
        rebuilds what the iteration needs and the SAME iteration re-runs
        (at most ``max_topology_events`` times); the watchdog is reset;
      * without a hook the error propagates — a supervisor restarts the
        process (on another grid if it must: the state dicts are global
        arrays) and ``resume()`` picks up from the checkpoint.

    **On a grid** (``grid``: a callable returning the grid the body runs
    on now, as the app's context holds it) a grid position is a process.
    Every decision above is taken alike on every rank, so the hook runs on
    every rank of the old grid; when it moves the loop onto a smaller grid
    of the same world (world ranks ``0 .. n-1``, ``DistSpMat.regrid``), a
    rank the new grid leaves out retires: ``run`` returns None there (and
    the card's cached memory is released). Checkpoints are written and
    waited for over the current grid. The app ends in :meth:`finish`:
    after a topology event every rank of the loop's first grid returns
    rank 0's answer, by one broadcast over that grid.

    Persistent stragglers get the same treatment one tier down: after
    ``straggler_patience`` consecutive over-budget iterations, the optional
    ``on_straggler(it, elapsed)`` hook fires and the watchdog is reset to
    learn the re-planned timing.
    """

    def __init__(self, ckpt_dir: str | None = None, *, every: int = 1,
                 keep: int = 3, watchdog=None, on_topology=None,
                 max_topology_events: int = 2, on_straggler=None,
                 straggler_patience: int = 3, grid=None,
                 name: str = "loop"):
        # ``name`` labels this loop's span site (``<name>.iter``)
        self.name = name
        self.grid = grid
        self._first = None              # the grid the last run started on
        self._topo = 0                  # its topology events
        self.ckpt_dir = ckpt_dir
        self.every = max(int(every), 1)
        self.keep = keep
        self.watchdog = watchdog
        self.on_topology = on_topology
        self.max_topology_events = max_topology_events
        self.on_straggler = on_straggler
        self.straggler_patience = max(int(straggler_patience), 1)

    def resume(self, state: dict):
        """(start_iteration, state): restored when a checkpoint exists."""
        if not self.ckpt_dir:
            return 0, state
        from ..train.checkpoint import restore_flat
        try:
            restored, step = restore_flat(self.ckpt_dir)
        except FileNotFoundError:
            return 0, state
        done = bool(np.asarray(restored.pop(_DONE_KEY, False)))
        return (-1 if done else step + 1), restored

    def _current(self):
        return None if self.grid is None else tuple(self.grid())

    def _save(self, it: int, state: dict, done: bool):
        from ..train.checkpoint import save_checkpoint
        tree = dict(state)
        tree[_DONE_KEY] = np.asarray(done)
        save_checkpoint(self.ckpt_dir, it, tree, keep=self.keep,
                        grid=self._current())

    def _retired(self) -> bool:
        """Whether the hook moved the loop onto a grid that leaves this
        rank out (the 1x1 grid a loop starts on is its own process's)."""
        from ..core import comm
        first = self._first
        return first is not None and comm.positions(first) > 1 \
            and not comm.holds(self._current())

    def finish(self, result):
        """``result`` as rank 0 has it, on every rank of the grid the last
        ``run`` started on: after a topology event, by one broadcast over
        that grid (a retired rank passes None); else ``result`` itself."""
        from ..core import comm
        if not self._topo or self._first is None \
                or comm.positions(self._first) == 1:
            return result
        return comm.broadcast_object(result, self._first)

    def run(self, state: dict, body, max_iters: int) -> dict | None:
        self._first, self._topo = self._current(), 0
        start, state = self.resume(state)
        if start < 0:                       # checkpointed run already done
            return state
        wd = self.watchdog
        topo_events = 0
        straggles = 0
        it = start
        while it < max_iters:
            faults.maybe_crash("loop.crash")
            try:
                maybe_device_loss("loop.device_loss")
                if wd is not None:
                    wd.start()
                faults.maybe_delay("loop.delay")
                with _obs.span(self.name + ".iter", it=it):
                    state, done = body(it, state)
            except TopologyError as err:
                # `state` is the last COMPLETED iteration's output — save
                # it (step it-1) so a restarted process resumes by redoing
                # exactly the interrupted iteration, never skipping it
                if self.ckpt_dir and it > 0:
                    self._save(it - 1, state, False)
                topo_events += 1
                if self.on_topology is None \
                        or topo_events > self.max_topology_events:
                    raise
                warnings.warn(
                    f"robust: topology fault at iteration {it} ({err}) — "
                    f"checkpointed, regridding via on_topology "
                    f"({topo_events}/{self.max_topology_events})",
                    RuntimeWarning, stacklevel=2)
                _obs.event("loop.topology", loop=self.name, it=it,
                           error=str(err), n=topo_events)
                _obs.counter_add("loop.topology_events")
                self._topo = topo_events
                state = self.on_topology(state, err)
                if self._retired():
                    _release_cache()
                    return None
                if wd is not None:
                    wd.reset()              # old-grid step times are stale
                continue                    # re-run the SAME iteration
            if wd is not None:
                dt = wd.stop()
                if wd.is_straggling(dt):
                    warnings.warn(
                        f"robust: iteration {it} straggling "
                        f"({dt:.3f}s > budget {wd.budget():.3f}s)",
                        RuntimeWarning, stacklevel=2)
                    _obs.event("loop.straggler", loop=self.name, it=it,
                               elapsed_s=dt, budget_s=wd.budget())
                    _obs.counter_add("loop.stragglers")
                    straggles += 1
                    if self.on_straggler is not None \
                            and straggles >= self.straggler_patience:
                        warnings.warn(
                            f"robust: {straggles} consecutive straggling "
                            "iterations — invoking on_straggler to re-plan "
                            "around the slow stage", RuntimeWarning,
                            stacklevel=2)
                        self.on_straggler(it, dt)
                        wd.reset()          # learn the re-planned timing
                        straggles = 0
                else:
                    straggles = 0
            if self.ckpt_dir and (done or (it + 1) % self.every == 0
                                  or it + 1 == max_iters):
                self._save(it, state, bool(done))
            if done:
                break
            it += 1
        return state
