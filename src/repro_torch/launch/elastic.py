"""Failure handling of long runs: restore onto another mesh, and the
straggler watchdog (port of ``repro/launch/elastic.py``).

``reshard_restore`` restores a checkpoint onto a mesh of any shape, each
leaf placed by its spec (``train/checkpoint.restore_checkpoint`` with
``mesh`` and ``specs``): the LM stack's elastic restart. A sparse matrix
restores onto any grid through ``core.dist.restore_spmat``.

``StepWatchdog`` is ``repro.launch.elastic.StepWatchdog``: a wall-time
budget per step, from the trailing median; ``is_straggling(elapsed)`` is
True once a step exceeds ``grace`` multiples of it. The caller decides the
response (``robust/recover.CheckpointedLoop`` warns, counts, and calls its
``on_straggler`` hook after ``straggler_patience`` straggling steps in a
row).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

from ..train.checkpoint import restore_checkpoint


def reshard_restore(ckpt_dir: str, like, *, mesh=None, specs=None,
                    step: Optional[int] = None):
    """Restore a checkpoint onto a (possibly different) mesh/plan."""
    return restore_checkpoint(ckpt_dir, like, step=step, mesh=mesh,
                              specs=specs)


class StepWatchdog:
    """Detects straggling steps by trailing-median wall time."""

    def __init__(self, grace: float = 3.0, window: int = 20,
                 min_samples: int = 5):
        self.grace = grace
        self.times: deque = deque(maxlen=window)
        self.min_samples = min_samples
        self._t0 = None

    def start(self):
        self._t0 = time.monotonic()

    def reset(self):
        """Forget trailing step times (back into warmup).

        Call on any topology or plan change — a new grid or a re-planned
        exchange schedule changes per-step wall time, so a budget computed
        from the old configuration's trailing median would either flag
        every post-change step or mask a real straggler.
        ``robust/recover.CheckpointedLoop`` calls this after its
        ``on_topology``/``on_straggler`` hooks run.
        """
        self.times.clear()
        self._t0 = None

    def stop(self) -> float:
        dt = time.monotonic() - self._t0
        self.times.append(dt)
        return dt

    def budget(self) -> Optional[float]:
        if len(self.times) < self.min_samples:
            return None
        med = sorted(self.times)[len(self.times) // 2]
        return med * self.grace

    def is_straggling(self, elapsed: float) -> bool:
        b = self.budget()
        return b is not None and elapsed > b
