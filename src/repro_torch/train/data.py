"""Data pipeline: a deterministic synthetic LM stream, background prefetch
and batch specs (port of ``repro/train/data.py``).

Determinism contract: ``batch_at(step)`` is a pure function of (seed, step,
shape), so a run resumed from a checkpointed step sees bitwise the data of
an uninterrupted one, with no pipeline state to save beyond the step. The
draws are the reference's: ``numpy.random.default_rng`` gives the same
numbers in both packages; batches are int32 tensors on the host (the
caller moves them to its device), and ``synthetic_batch`` rounds its
float64 draws to bfloat16 by torch's cast, which rounds as
``jnp.asarray(x, bfloat16)`` does.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Iterator

import numpy as np
import torch

from ..core.coo import resolve_device


class SyntheticLM:
    """Markov-ish synthetic token stream (a repeating motif and noise, so
    the loss visibly drops), deterministic in (seed, step)."""

    def __init__(self, vocab: int, seq: int, batch: int, seed: int = 0):
        self.vocab, self.seq, self.batch, self.seed = vocab, seq, batch, seed

    def batch_at(self, step: int) -> dict:
        """``tokens`` and ``labels`` (batch, seq) int32 on the host, labels
        the tokens shifted by one."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        base = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        motif = (np.arange(self.seq + 1) * 7 + step % 13) % self.vocab
        use = rng.random((self.batch, self.seq + 1)) < 0.7
        toks = torch.from_numpy(np.where(use, motif[None, :], base)
                                .astype(np.int32))
        return dict(tokens=toks[:, :-1].contiguous(),
                    labels=toks[:, 1:].contiguous())

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of ``source.batch_at`` from
    ``start_step`` on, ``depth`` batches ahead.

    Failure contract: an exception in ``source.batch_at`` is captured on the
    worker thread and re-raised in ``next()`` (after the batches queued
    before it are consumed), never a silently dead worker with ``next()``
    blocking forever. ``close()`` stops and joins the worker.
    """

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self.source = source
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            try:
                batch = self.source.batch_at(s)
            except BaseException as err:      # noqa: BLE001 — relayed, not
                self._exc = err               # swallowed: next() re-raises
                return
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=1.0)
                    s += 1
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        # poll so a worker's death surfaces instead of blocking forever;
        # batches queued before the failure are still delivered in order
        while True:
            try:
                return self.q.get(timeout=0.1)
            except queue.Empty:
                if self._exc is not None:
                    raise self._exc
                if not self.t.is_alive():
                    raise RuntimeError(
                        "Prefetcher worker thread died without queuing a "
                        "batch or recording an exception")

    def close(self, timeout: float = 5.0) -> bool:
        """Stop and join the worker; True when it exited.

        The queue is drained while joining, not once before: the worker can
        refill it between a single drain and its next ``put``, and would
        then block there. A worker still alive at the deadline is stuck
        inside ``source.batch_at``: a ``RuntimeWarning`` says so and
        ``close`` returns False (the thread is a daemon and does not block
        the interpreter's exit)."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self.t.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self.t.join(timeout=0.05)
        if self.t.is_alive():
            warnings.warn(
                f"Prefetcher.close(): worker thread still alive after "
                f"{timeout:.1f}s — it is likely blocked inside "
                "source.batch_at. The daemon thread will not block exit, "
                "but it may keep consuming the source.",
                RuntimeWarning, stacklevel=2)
            return False
        return True


def make_batch_specs(cfg, shape: dict) -> dict:
    """A training batch of ``shape`` (``batch``, ``seq``) for ``cfg`` as
    tensors on the ``meta`` device: shapes and types without storage (the
    reference's ``ShapeDtypeStruct``s). An encoder's is ``features`` (B, S,
    D) bfloat16, ``mask`` bool and ``targets`` int32; a decoder's ``tokens``
    and ``labels`` int32, with the vision frontend also ``vision_embeds``
    (B, max(S // 4, 1), D) bfloat16, ``vision_mask`` bool and ``pos3`` (3,
    B, S) int32."""
    B, S = shape["batch"], shape["seq"]
    D = cfg.d_model

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.kind == "encoder":
        return dict(features=spec((B, S, D), torch.bfloat16),
                    mask=spec((B, S), torch.bool),
                    targets=spec((B, S), torch.int32))
    batch = dict(tokens=spec((B, S), torch.int32),
                 labels=spec((B, S), torch.int32))
    if cfg.frontend == "vision_patches":
        batch["vision_embeds"] = spec((B, max(S // 4, 1), D), torch.bfloat16)
        batch["vision_mask"] = spec((B, S), torch.bool)
        batch["pos3"] = spec((3, B, S), torch.int32)
    return batch


def synthetic_batch(cfg, shape: dict, seed: int = 0, device=None) -> dict:
    """A random batch of ``shape`` (``batch``, ``seq``) for ``cfg``, on
    ``device`` (None: the GPU). An encoder's is ``features`` (B, S, D)
    bfloat16, ``mask`` (B, S) bool and ``targets`` (B, S) int32; a
    decoder's is ``tokens`` and ``labels`` (B, S) int32, and with the vision
    frontend also ``vision_embeds`` (B, T, D) bfloat16 with T = max(S // 4,
    1), ``vision_mask`` (B, S) bool, True at the first T positions, and
    ``pos3`` (3, B, S) int32, each axis 0 .. S - 1."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B, S = shape["batch"], shape["seq"]
    D = cfg.d_model

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    if cfg.kind == "encoder":
        return dict(
            features=t(rng.standard_normal((B, S, D)), torch.bfloat16),
            mask=t(rng.random((B, S)) < cfg.mask_prob, torch.bool),
            targets=t(rng.integers(0, cfg.vocab, (B, S)), torch.int32))
    batch = dict(
        tokens=t(rng.integers(0, cfg.vocab, (B, S)), torch.int32),
        labels=t(rng.integers(0, cfg.vocab, (B, S)), torch.int32))
    if cfg.frontend == "vision_patches":
        T = max(S // 4, 1)
        vmask = np.zeros((B, S), bool)
        vmask[:, :T] = True
        batch["vision_embeds"] = t(rng.standard_normal((B, T, D)),
                                   torch.bfloat16)
        batch["vision_mask"] = t(vmask, torch.bool)
        batch["pos3"] = t(np.broadcast_to(np.arange(S), (3, B, S)),
                          torch.int32)
    return batch
