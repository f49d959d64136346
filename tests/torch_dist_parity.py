"""Harness of the port's grid tests: gloo CPU ranks and the JAX reference.

``run_ranks(fn, world, *args)`` spawns ``world`` processes, joins them
into one gloo process group (``tcp://localhost`` on a free port), runs
``fn(rank, *args)`` on each and returns the results in rank order. ``fn``
must be a module-level function (spawn imports its module in every rank)
and should return numpy arrays or plain Python values. A rank that raises
fails the call with that rank's traceback; a rank that does not finish
within ``timeout`` seconds fails it too, and every rank is stopped.

``JaxReference(module, func, grids)`` runs ``module.func(F)`` for each
grid, ``F`` a ``Frame`` over the JAX package, in a subprocess with 4
forced XLA host devices (so its 2x2 and 1x2/2x1 meshes exist; ``devices=8``
for a 2x2x2 mesh), and returns the pickled results by grid. A grid is
``(pr, pc)``, or ``(L, q, q)`` for a mesh of ``L`` layers. The subprocess starts at once; ``result()``
waits for it, so the port's ranks and the reference run side by side. The
test modules import no JAX, so a spawned rank never pays for it; the same
``func(F)`` over the port runs on the ranks (``port_cases``).

Each rank's fields are its own shard; ``stack_shards`` lays a list of
per-rank (1, 1, ...) arrays out as the JAX package's global (pr, pc, ...)
array (per-rank (1, 1, 1, ...) as (L, q, q, ...)), so both compare as
whole arrays.
"""
from __future__ import annotations

import os
import pickle
import queue
import socket
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, out):
    import torch
    from repro_torch.core import comm
    torch.set_num_threads(1)
    try:
        comm.init_world(rank, world, port, "gloo")
        try:
            res = fn(rank, *args)
        finally:
            comm.close_world()
        out.put((rank, True, pickle.dumps(res)))
    except BaseException:                              # noqa: BLE001
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout: float = 240.0):
    """``[fn(0, *args), ..., fn(world-1, *args)]``, each on its own gloo
    rank."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, fn, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, good, payload = out.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(
                    f"{fn.__name__}: ranks {sorted(set(range(world)) - set(results))} "
                    f"did not finish within {timeout} s") from None
            if good:
                results[rank] = pickle.loads(payload)
            else:
                errors.append(f"rank {rank}:\n{payload}")
                break                      # the others may wait on it
        if errors:
            raise RuntimeError(f"{fn.__name__} failed on a rank\n"
                               + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    bad = [p.exitcode for p in procs if p.exitcode not in (0, None)]
    if bad:
        raise RuntimeError(f"{fn.__name__}: a rank exited with {bad}")
    return [results[r] for r in range(world)]


def stack_shards(shards, grid):
    """Per-rank (1, 1, ...) arrays in rank order -> the global (pr, pc, ...)
    array; on a grid of layers, (1, 1, 1, ...) -> (L, q, q, ...)."""
    arr = [np.asarray(s) for s in shards]
    return np.concatenate(arr, axis=0).reshape(
        tuple(grid) + arr[0].shape[len(grid):])


class JaxReference:
    """``module.func(F)`` over the JAX package, a subprocess with
    ``devices`` XLA host devices."""

    def __init__(self, module: str, func: str, grids, timeout: float = 600.0,
                 devices: int = 4):
        self.timeout = timeout
        fd, self.path = tempfile.mkstemp(suffix=".pkl")
        os.close(fd)
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count="
                            f"{devices}")
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src"), str(ROOT / "tests")]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        grids = [tuple(g) for g in grids]
        code = ("import pickle, torch_dist_parity as h\n"
                f"res = h.jax_cases({module!r}, {func!r}, {grids!r})\n"
                f"pickle.dump(res, open({self.path!r}, 'wb'))\n")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self):
        try:
            _, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise RuntimeError("the JAX reference did not finish within "
                               f"{self.timeout} s") from None
        try:
            if self.proc.returncode != 0:
                raise RuntimeError("the JAX reference failed:\n" + err[-6000:])
            with open(self.path, "rb") as f:
                return pickle.load(f)
        finally:
            os.unlink(self.path)


def jax_patched():
    """The JAX package's shard_map paths under jax >= 0.9, in the JAX
    subprocess: ``tests/torch_parity.py::jax_reference`` turns off the
    varying-axes check (``check_vma=False``, the successor of the
    ``check_rep=False`` that ``repro.core.compat`` sets on jax 0.4.x) and
    jits the 2D SpGEMM; ``jax_apps_jitted`` and ``jax_graph_apps_jitted``
    jit the apps' primitives. The computation is unchanged."""
    import contextlib
    import torch_parity as tp
    stack = contextlib.ExitStack()
    stack.enter_context(tp.jax_reference())
    stack.enter_context(tp.jax_apps_jitted())
    stack.enter_context(tp.jax_graph_apps_jitted())
    return stack


def np_tree(x):
    """JAX arrays (and containers of them) as numpy."""
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(np_tree(v) for v in x)
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return np.asarray(x)
    return x


# --------------------------------------------------------------------------
# one case body for both packages
# --------------------------------------------------------------------------

_MODULES = ("dist", "matops", "spmv", "assign", "spmm", "semiring", "mask",
            "plan", "spgemm", "coo")
_PACKAGE_MODULES = ("dist.compression",)
_APPS = ("tricount", "bfs", "pagerank", "fastsv", "matching", "hipmcl")


class Frame:
    """One package's view of a case: its modules (``F.dist``, ``F.spmv``,
    ``F.tricount``, ...), its mesh, how a global numpy ``(pr, pc, ...)``
    array becomes an operand there (``F.shard``: the whole array for JAX,
    this rank's shard for the port) and how a result becomes numpy
    (``F.out``: the global array for JAX, this rank's shard for the port).
    A case body written against ``F`` runs unchanged in both."""

    def __init__(self, package: str, grid):
        import importlib
        self.package, self.grid = package, tuple(grid)
        for m in _MODULES:
            setattr(self, m, importlib.import_module(f"{package}.core.{m}"))
        for m in _APPS:
            setattr(self, m, importlib.import_module(f"{package}.apps.{m}"))
        for m in _PACKAGE_MODULES:
            setattr(self, m.split(".")[-1],
                    importlib.import_module(f"{package}.{m}"))
        # (pr, pc) or (L, q, q): the mesh of L layers
        pr, pc = self.grid[-2:]
        layers = self.grid[0] if len(self.grid) == 3 else 1
        if package == "repro":
            import jax.numpy as jnp
            self.mesh = self.dist.make_grid(pr, pc, layers)
            self.l = self.i = self.j = None
            self.shard = jnp.asarray
        else:
            import torch
            self.mesh = self.dist.make_grid(pr, pc, layers, device="cpu")
            g = self.dist.comm.of(grid)
            self.l, self.i, self.j = g.l, g.i, g.j
            pos = (g.l, g.i, g.j)[3 - len(self.grid):]
            self.shard = lambda x: torch.from_numpy(np.ascontiguousarray(
                np.asarray(x)[tuple(slice(k, k + 1) for k in pos)]))

    def call(self, fn, *args, **static):
        """``fn(*args, **static)``; in JAX under one jit per (fn, static):
        eagerly, a ``shard_map`` body runs op by op and compiles every
        primitive (an eager 2x2 ``assign`` took some 20 s)."""
        if self.package == "repro":
            import torch_parity as tp
            return tp.jit_ref(fn, static, *args)
        return fn(*args, **static)

    @staticmethod
    def out(x):
        if hasattr(x, "detach"):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def fields(self, m):
        """The fields of a DistSpMat/DistVec/DistSpVec as numpy."""
        names = [f for f in ("row", "col", "val", "nnz", "data", "idx")
                 if hasattr(m, f)]
        return {f: self.out(getattr(m, f)) for f in names}


def port_cases(rank, grid, module, func):
    """A rank's side: ``module.func(Frame('repro_torch', grid))``."""
    import importlib
    return getattr(importlib.import_module(module), func)(
        Frame("repro_torch", grid))


def jax_cases(module, func, grids):
    """The JAX subprocess's side: ``module.func(Frame('repro', grid))`` for
    each grid, under ``jax_patched``."""
    import importlib
    fn = getattr(importlib.import_module(module), func)
    with jax_patched():
        return {tuple(g): np_tree(fn(Frame("repro", g))) for g in grids}


SUM_RTOL = 1e-6          # as tests/torch_parity.py


def assert_same(got, want, exact=False, what=""):
    """Bitwise for integers, bools and ``exact``; float sums within
    ``SUM_RTOL`` (gloo ranks and XLA add in other orders)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if exact or not np.issubdtype(got.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0,
                                   err_msg=what)


def compare(port_ranks, want, grid, exact=False, what=""):
    """A case's port results (one dict a rank) against JAX's. Keys that
    start with ``g:`` are replicated host values (every rank must hold
    JAX's); the others are shards, stacked into the global array."""
    for key, w in want.items():
        got = [r[key] for r in port_ranks]
        if isinstance(w, dict):
            compare([{k: g[k] for k in w} for g in got], w, grid, exact,
                    f"{what}/{key}")
            continue
        if key.startswith("g:"):
            for rk, g_ in enumerate(got):
                _same_tree(g_, w, exact, f"{what}/{key} rank {rk}")
        else:
            assert_same(stack_shards(got, grid), w, exact, f"{what}/{key}")


def _same_tree(got, want, exact, what):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for g_, w in zip(got, want):
            _same_tree(g_, w, exact, what)
    elif isinstance(want, np.ndarray):
        assert_same(got, want, exact, what)
    else:
        assert got == want, (what, got, want)
