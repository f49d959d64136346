"""Grid-independent checkpoints: the JAX package's format, in numpy.

Format: one directory per step —
    step_000123.tmp/…  →  atomic rename →  step_000123/
      manifest.json    tree structure, shapes, dtypes, per-leaf CRC32, step
      NNN.npy          one file per leaf, the whole (global) array

The format, the leaf order and the path strings (``"a/b/0"``: dict keys
sorted, sequence indices) are those of ``repro.train.checkpoint``, so a
checkpoint written by either package restores in the other. Leaves are
numpy arrays, numpy or Python scalars, or tensors (copied to the host);
a DTensor leaf (a rank's block of a leaf placed on a mesh,
``dist/shardings.py``) is gathered and stored whole, so a checkpoint holds
logical arrays and restores onto any mesh.

Durability: writes go to a ``.tmp`` directory, fsync'd, then renamed —
a crash mid-save never corrupts the latest complete checkpoint. ``keep``
old checkpoints are retained (default 3).

Integrity: every leaf's bytes are CRC32-summed into the manifest at save
time and verified on restore. A corrupted, truncated, or missing leaf
raises :class:`CheckpointError` naming the leaf — and when the caller
asked for the *latest* step (``step=None``), restore falls back to the
previous retained checkpoint with a loud warning (the ``checkpoint.leaf``
fault site exercises this).

On a grid of several ranks the state is global arrays, the same on every
rank, or sharded leaves that every rank gathers in turn: rank 0 writes
(the others count each leaf's ``checkpoint.leaf`` activation, so armed
faults stay in step), a barrier over the grid's ranks follows, and every
rank reads. The barrier spans the grid the caller names (``grid``), not
the torch world: after an elastic shrink to 1x1 in a world of four, rank 0
writes and waits for no retired rank. ``restore_checkpoint`` with a
``mesh`` and ``specs`` places each leaf on the mesh (the elastic path:
each rank reads each leaf and keeps its block under the spec, on any mesh
shape).
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..core import comm
from ..dist import shardings as _sh
from ..obs import recorder as _obs
from ..robust import faults as _faults

LEAF_SITE = "checkpoint.leaf"


class CheckpointError(ValueError):
    """A checkpoint leaf failed integrity verification on restore."""


def _flatten_with_paths(tree):
    """(paths, leaves) in the JAX package's order: dict keys sorted,
    sequences by index, ``None`` no leaf; a path joins the keys and
    indices with ``/``."""
    paths, leaves = [], []

    def walk(x, prefix):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], prefix + (str(k),))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, prefix + (str(i),))
        elif x is not None:
            paths.append("/".join(prefix))
            leaves.append(x)

    walk(tree, ())
    return paths, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return None if x is None else next(it)

    return build(like)


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):                  # a tensor
        return _sh.gather(leaf).detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


@_obs.timed("ckpt.save")
def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
                    grid=None):
    """Write ``tree`` as step ``step`` of ``ckpt_dir``; returns the step's
    directory. Rank 0 writes and the ranks of ``grid`` (a ``(pr, pc)`` or
    ``(L, pr, pc)`` grid; the whole world by default) wait for it; on a
    grid of one position no rank waits. A DTensor leaf is gathered, each
    in turn, by every rank of its mesh."""
    rank, _ = comm.world()
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    paths, leaves = _flatten_with_paths(tree)
    if rank != 0:
        for leaf in leaves:
            _sh.gather(leaf)             # a sharded leaf's gather is
            _faults.fire(LEAF_SITE)      # collective: rank 0 writes it
        comm.barrier(grid)
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = dict(step=step, leaves=[])
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        arr = _host(leaf)
        fname = f"{i:05d}.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        _faults.corrupt_file(LEAF_SITE, fpath)
        manifest["leaves"].append(dict(path=p, file=fname,
                                       shape=list(arr.shape),
                                       dtype=str(arr.dtype),
                                       crc32=_leaf_crc(arr)))
        _obs.counter_add("ckpt.bytes_saved", arr.nbytes)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # retention
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    comm.barrier(grid)
    return final


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(d[5:]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _load_leaf(step_dir: str, entry: dict) -> np.ndarray:
    """Read + verify one manifest leaf; CheckpointError names the leaf."""
    fpath = os.path.join(step_dir, entry["file"])
    where = f"{fpath} (leaf {entry['path']!r})"
    if not os.path.exists(fpath):
        raise CheckpointError(f"missing checkpoint leaf {where}")
    try:
        arr = np.load(fpath)
    except Exception as err:
        raise CheckpointError(
            f"unreadable checkpoint leaf {where}: {err}") from err
    if tuple(arr.shape) != tuple(entry["shape"]) \
            or str(arr.dtype) != entry["dtype"]:
        raise CheckpointError(
            f"checkpoint leaf {where} shape/dtype drifted from manifest: "
            f"{arr.shape}/{arr.dtype} vs {entry['shape']}/{entry['dtype']}")
    if "crc32" in entry and _leaf_crc(arr) != entry["crc32"]:
        raise CheckpointError(
            f"checkpoint leaf {where} CRC32 mismatch "
            f"({_leaf_crc(arr):#010x} != manifest {entry['crc32']:#010x})")
    _obs.counter_add("ckpt.bytes_restored", arr.nbytes)
    return arr


def _candidate_steps(ckpt_dir: str, step: int | None):
    """Requested step only, or all retained steps newest-first."""
    if step is not None:
        return [step]
    steps = sorted(all_steps(ckpt_dir), reverse=True)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return steps


def _fallback(ckpt_dir: str, step: int | None, read):
    """``(read(s), s)`` for the requested step, or for the newest retained
    step that verifies, warning at each one that does not."""
    last_err: Exception | None = None
    for s in _candidate_steps(ckpt_dir, step):
        try:
            return read(os.path.join(ckpt_dir, f"step_{s:08d}")), s
        except CheckpointError as err:
            if step is not None:
                raise
            warnings.warn(
                f"checkpoint step {s} failed verification ({err}); "
                "falling back to the previous retained checkpoint",
                RuntimeWarning, stacklevel=3)
            last_err = err
    raise last_err


def _manifest(step_dir: str) -> dict:
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


def _spec_at(specs, path: str):
    """The spec at ``path`` of a spec tree shaped like the state tree."""
    for k in path.split("/") if path else ():
        specs = specs[int(k) if isinstance(specs, (list, tuple)) and
                      not isinstance(specs, _sh.PartitionSpec) else k]
    return specs


@_obs.timed("ckpt.restore")
def restore_checkpoint(ckpt_dir: str, like: Any, *, step: int | None = None,
                       mesh=None, specs: Any = None):
    """Restore into the structure of ``like`` (a tree of arrays, or of
    anything with a ``shape``); returns ``(tree, step)`` with numpy leaves,
    or, with ``mesh`` (a ``DeviceMesh``) and ``specs`` (a tree of specs
    shaped like ``like``), each leaf placed on the mesh by its spec: a
    DTensor holding this rank's block, on the mesh's device, for a mesh of
    any shape (every rank reads each leaf and keeps its block).

    Every leaf is CRC32-verified against the manifest; a failed leaf raises
    :class:`CheckpointError` — unless ``step=None``, where restore falls
    back to the previous retained checkpoint (loudly)."""
    paths, like_leaves = _flatten_with_paths(like)
    placed = mesh is not None and specs is not None

    def read(d):
        by_path = {e["path"]: e for e in _manifest(d)["leaves"]}
        out = []
        for p, leaf in zip(paths, like_leaves):
            arr = _load_leaf(d, by_path[p])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {p}: {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            if placed:
                arr = _sh.shard(torch.from_numpy(arr), _spec_at(specs, p),
                                mesh)
            out.append(arr)
        return _unflatten(like, out)

    return _fallback(ckpt_dir, step, read)


@_obs.timed("ckpt.restore_flat")
def restore_flat(ckpt_dir: str, step: int | None = None):
    """Manifest-driven restore: ``({leaf_path: np.ndarray}, step)``.

    No ``like`` template — shapes come from the manifest, so callers whose
    state shapes change between steps (HipMCL's iterate) can still resume.
    Same CRC verification and latest-step fallback as
    :func:`restore_checkpoint`."""
    return _fallback(ckpt_dir, step, lambda d: {
        e["path"]: _load_leaf(d, e) for e in _manifest(d)["leaves"]})
