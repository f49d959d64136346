"""Checkpointed iteration for the iterative graph apps: the bare run.

``CheckpointedLoop`` is the JAX package's iteration loop
(``repro.robust.recover``) in its bare form: no checkpoint directory, no
watchdog, no topology or straggler hooks. The iteration sequence, the
``done`` handling and the ``<name>.iter`` span are those of the JAX loop,
so an app's body runs the same iterations in both packages. Checkpoints
and elastic recovery (ROADMAP.md queue 1, "checkpoints and elastic
state"), the fault sites ("robust/'s detection layer") and the degradation
ladder ("the degradation ladder") are not ported: asking for any of them
raises.
"""
from __future__ import annotations

from ..obs import recorder as _obs


class CheckpointedLoop:
    """The iteration loop of the iterative graph apps.

    ``state`` is a flat dict of arrays and ``body`` is
    ``body(it, state) -> (state, done)``, pure given ``state``; the loop
    runs iterations 0, 1, ... until ``done`` or ``max_iters``.
    """

    def __init__(self, ckpt_dir: str | None = None, *, watchdog=None,
                 on_topology=None, on_straggler=None, name: str = "loop"):
        asked = [k for k, v in (("ckpt_dir", ckpt_dir),
                                ("watchdog", watchdog),
                                ("on_topology", on_topology),
                                ("on_straggler", on_straggler))
                 if v is not None]
        if asked:
            raise NotImplementedError(
                f"CheckpointedLoop({', '.join(asked)}=...): checkpoints and "
                "elastic recovery are not ported yet (ROADMAP.md queue 1, "
                "'checkpoints and elastic state'); this port runs the bare "
                "loop only")
        # ``name`` labels this loop's span site (``<name>.iter``)
        self.name = name

    def run(self, state: dict, body, max_iters: int) -> dict:
        it = 0
        while it < max_iters:
            with _obs.span(self.name + ".iter", it=it):
                state, done = body(it, state)
            if done:
                break
            it += 1
        return state
