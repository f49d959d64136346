"""Helpers for the parity tests of ``repro_torch`` against ``repro``.

Both packages get the same numpy inputs; results are compared as numpy
arrays. Index structure (row, col, nnz, ok flags, order tag) and every
non-sum value must match bitwise. Float sums are compared with
``SUM_RTOL``: the two packages may add a segment's values in another order,
and for the few values per segment these tests use, reordering moves a
float32 sum by a few ulps at most.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

import sys

import repro.apps.pagerank  # noqa: F401  (the module, for jax_apps_jitted)
import repro.apps.fastsv  # noqa: F401  (the modules, for jax_graph_apps_jitted)
import repro.apps.hipmcl  # noqa: F401
import repro.apps.matching  # noqa: F401
import repro.core.assign  # noqa: F401
import repro.core.plan as _jplan
import repro.core.spgemm as _jspgemm
from repro.core.coo import COO as JCOO
from repro_torch.core.coo import COO as TCOO

SUM_RTOL = 1e-6
CPU = torch.device("cpu")


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def coo_pair(shape, r, c, v, cap, fill=0.0, order="none"):
    """The same tile in both packages (canonical padding to ``cap``)."""
    j = JCOO.from_entries(shape, r, c, v, cap=cap, fill=fill, order=order)
    t = TCOO.from_entries(shape, r, c, v, cap=cap, fill=fill, order=order,
                          device=CPU)
    return j, t


def coo_from_jax(j: JCOO) -> TCOO:
    """The port's copy of a JAX tile, its arrays taken verbatim."""
    return TCOO.from_numpy(np_of(j.row), np_of(j.col), np_of(j.val),
                           np_of(j.nnz), j.shape, j.order, CPU)


def rand_entries(n=24, k=60, seed=0, dtype=np.float32, vdims=()):
    """Random coordinates with duplicates and positive values."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, k)
    c = rng.integers(0, n, k)
    v = (rng.random((k,) + vdims) + 0.25).astype(dtype)
    return r, c, v


def assert_values(got, want, exact=False):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if exact or not np.issubdtype(got.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0)


def assert_coo_equal(got: TCOO, want: JCOO, exact=False):
    """Whole tiles, padding included: coordinates, nnz and tag bitwise."""
    assert got.shape == tuple(want.shape)
    assert got.order == want.order, (got.order, want.order)
    assert int(got.nnz) == int(want.nnz)
    np.testing.assert_array_equal(np_of(got.row), np_of(want.row))
    np.testing.assert_array_equal(np_of(got.col), np_of(want.col))
    assert_values(got.val, want.val, exact)


def assert_dist_equal(got, want, exact=False):
    """A repro_torch DistSpMat against a repro DistSpMat, field by field."""
    assert got.shape == tuple(want.shape) and got.grid == tuple(want.grid)
    assert got.order == want.order, (got.order, want.order)
    for f in ("row", "col", "nnz"):
        np.testing.assert_array_equal(np_of(getattr(got, f)),
                                      np_of(getattr(want, f)))
    assert_values(got.val, want.val, exact)


_JITTED = {}


def jit_ref(fn, static, *args, **kwargs):
    """``fn(*args, **static, **kwargs)`` of the JAX package under one jit
    per (fn, static): op-by-op dispatch compiles every primitive (and
    retraces every ``lax.cond``) and takes several times longer for these
    small inputs."""
    key = (fn, tuple(sorted(static.items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(functools.partial(fn, **static))
    return _JITTED[key](*args, **kwargs)


_JSPGEMM = {}


def jax_spgemm_2d(a, b, sr, *, mesh, prod_cap, out_cap, variant="rotation",
                  merge="deferred", mask=None, schedule=None, overlap=True,
                  compress=None, ef_resid=None):
    """``repro.core.spgemm.spgemm_2d`` under one jit per configuration (the
    eager shard_map dispatch takes several times longer to compile)."""
    key = (sr, mesh, prod_cap, out_cap, variant, merge, schedule, overlap,
           compress, mask is None, ef_resid is None,
           None if mask is None else (mask.complement, mask.pred,
                                      mask.val_pred))
    if key not in _JSPGEMM:
        def run(a, b, mat, resid):
            m = None if mask is None else dataclasses.replace(mask, mat=mat)
            return _jspgemm.spgemm_2d(
                a, b, sr, mesh=mesh, prod_cap=prod_cap, out_cap=out_cap,
                variant=variant, merge=merge, mask=m, schedule=schedule,
                overlap=overlap, compress=compress, ef_resid=resid)
        _JSPGEMM[key] = jax.jit(run)
    return _JSPGEMM[key](a, b, None if mask is None else mask.mat, ef_resid)


def jax_spgemm_3d(a3, b3, sr, *, mesh, prod_cap, out_cap, merge="deferred",
                  variant="rotation", mask=None, schedule=None,
                  overlap=True):
    """``repro.core.spgemm.spgemm_3d`` under one jit per configuration, its
    mask's ``mat3`` passed as an argument."""
    key = ("3d", sr, mesh, prod_cap, out_cap, merge, variant, schedule,
           overlap, mask is None,
           None if mask is None else (mask.mat3 is None, mask.complement,
                                      mask.pred, mask.val_pred))
    if key not in _JSPGEMM:
        def run(a3, b3, mat3):
            m = None if mask is None else dataclasses.replace(mask,
                                                              mat3=mat3)
            return _jspgemm.spgemm_3d(
                a3, b3, sr, mesh=mesh, prod_cap=prod_cap, out_cap=out_cap,
                merge=merge, variant=variant, mask=m, schedule=schedule,
                overlap=overlap)
        _JSPGEMM[key] = jax.jit(run)
    return _JSPGEMM[key](a3, b3, None if mask is None else mask.mat3)


@contextlib.contextmanager
def jax_reference():
    """Run the JAX package's 2D SpGEMM as the reference on jax >= 0.9.

    Its ``compat.shard_map`` is ``jax.shard_map`` with the varying-axes
    check on, which rejects the merge engine's ``lax.cond`` inside the
    stage body; the check is the successor of the ``check_rep`` that compat
    turns off on jax 0.4.x, so it is turned off here too (the computation is
    unchanged). The planner's multiply goes through ``jax_spgemm_2d``.
    """
    mp = pytest.MonkeyPatch()
    mp.setattr(_jspgemm, "shard_map",
               functools.partial(jax.shard_map, check_vma=False))
    mp.setattr(_jplan, "_spgemm_2d", jax_spgemm_2d)
    try:
        yield
    finally:
        mp.undo()


_JSPMSPV = {}
_JSPMV_ITER = {}


def jax_spmspv(a, x, sr, *, mesh, variant, merge, prod_cap, out_cap,
               mask=None):
    """``repro.core.spmv.spmspv`` under one jit per configuration. The
    vector mask's ``pred`` is keyed by its code object: BFS builds a new
    ``lambda lv: lv >= 0`` (no free variables) every level."""
    key = (sr, mesh, variant, merge, prod_cap, out_cap,
           None if mask is None else (mask.complement, mask.pred.__code__))
    if key not in _JSPMSPV:
        def run(a, x, vec):
            m = None if mask is None else dataclasses.replace(mask, vec=vec)
            return _ORIG_SPMSPV(a, x, sr, mesh=mesh, variant=variant,
                                merge=merge, prod_cap=prod_cap,
                                out_cap=out_cap, mask=m)
        _JSPMSPV[key] = jax.jit(run)
    return _JSPMSPV[key](a, x, None if mask is None else mask.vec)


def jax_spmv_iter(a, x, sr, *, mesh, variant="row"):
    """``repro.core.spmv.spmv_iter`` under one jit per configuration."""
    key = (sr, mesh, variant)
    if key not in _JSPMV_ITER:
        _JSPMV_ITER[key] = jax.jit(functools.partial(
            _ORIG_SPMV_ITER, sr=sr, mesh=mesh, variant=variant))
    return _JSPMV_ITER[key](a, x)


_ORIG_SPMSPV = _jplan._spmspv_2d
_JPAGERANK = sys.modules["repro.apps.pagerank"]
_ORIG_SPMV_ITER = _JPAGERANK.spmv_iter


@contextlib.contextmanager
def jax_apps_jitted():
    """Run the JAX package's planned SpMSpV (so BFS) and PageRank's
    ``spmv_iter`` under jit. Eagerly, its ``shard_map`` bodies are traced
    and compiled again on every call (a new closure each time), which takes
    a 48-vertex BFS from seconds to over a minute. The computation is
    unchanged."""
    mp = pytest.MonkeyPatch()
    mp.setattr(_jplan, "_spmspv_2d", jax_spmspv)
    mp.setattr(_JPAGERANK, "spmv_iter", jax_spmv_iter)
    try:
        yield
    finally:
        mp.undo()


# --------------------------------------------------------------------------
# FastSV, matching and HipMCL: their primitives under jit
# --------------------------------------------------------------------------

_JFASTSV = sys.modules["repro.apps.fastsv"]
_JMATCHING = sys.modules["repro.apps.matching"]
_JHIPMCL = sys.modules["repro.apps.hipmcl"]
_JASSIGN = sys.modules["repro.core.assign"]
_ORIG_GRAPH = {name: getattr(_JASSIGN, name) for name in ("assign", "extract")}
_ORIG_GRAPH.update((name, getattr(_JHIPMCL, name)) for name in (
    "mat_reduce", "mat_scale_cols", "mat_apply_local", "mat_ewise_local",
    "mat_transpose"))
_JGRAPH = {}


def _fn_key(fn):
    """A tile function by its code and the values it closes over (HipMCL
    builds new lambdas over ``inflation`` and ``prune_threshold`` every
    iteration)."""
    return fn.__code__, tuple(c.cell_contents for c in fn.__closure__ or ())


def _jitted(name, key, make):
    key = (name,) + key
    if key not in _JGRAPH:
        _JGRAPH[key] = jax.jit(make())
    return _JGRAPH[key]


def jax_extract(v, gidx, *, mesh, route_cap=None):
    return _jitted("extract", (mesh, route_cap), lambda: functools.partial(
        _ORIG_GRAPH["extract"], mesh=mesh, route_cap=route_cap))(v, gidx)


def jax_assign(v, gidx, val, *, mesh, **kw):
    return _jitted("assign", (mesh, tuple(sorted(kw.items()))),
                   lambda: functools.partial(_ORIG_GRAPH["assign"], mesh=mesh,
                                             **kw))(v, gidx, val)


def jax_mat_reduce(a, axis, add, *, mesh):
    return _jitted("mat_reduce", (axis, add, mesh), lambda: functools.partial(
        _ORIG_GRAPH["mat_reduce"], axis=axis, add=add, mesh=mesh))(a)


def jax_mat_scale_cols(a, v, *args, mesh, **kw):
    return _jitted("mat_scale_cols", (args, tuple(sorted(kw.items())), mesh),
                   lambda: lambda a, v: _ORIG_GRAPH["mat_scale_cols"](
                       a, v, *args, mesh=mesh, **kw))(a, v)


def jax_mat_apply_local(a, fn, *, mesh):
    return _jitted("mat_apply_local", (_fn_key(fn), mesh),
                   lambda: lambda a: _ORIG_GRAPH["mat_apply_local"](
                       a, fn, mesh=mesh))(a)


def jax_mat_ewise_local(a, b, fn, *, mesh):
    return _jitted("mat_ewise_local", (_fn_key(fn), mesh),
                   lambda: lambda a, b: _ORIG_GRAPH["mat_ewise_local"](
                       a, b, fn, mesh=mesh))(a, b)


def jax_mat_transpose(a, *, mesh):
    return _jitted("mat_transpose", (mesh,), lambda: functools.partial(
        _ORIG_GRAPH["mat_transpose"], mesh=mesh))(a)


@contextlib.contextmanager
def jax_graph_apps_jitted():
    """Run the JAX package's FastSV, maximal matching and HipMCL with their
    primitives under jit: ``extract``, ``assign`` and ``spmv_iter`` where
    FastSV calls them, ``spmv_iter`` and ``assign`` in matching, ``extract``
    on ``repro.core.assign`` (matching imports it inside the function), and
    HipMCL's tile ops, keyed by the tile function's code. Eagerly every
    call traces and compiles its ``shard_map`` body again (FastSV on 60
    vertices took over 110 s). The computation is unchanged. The modules
    are reached through ``sys.modules``: each package's ``__init__``
    shadows them with same-named functions."""
    mp = pytest.MonkeyPatch()
    for mod in (_JFASTSV, _JMATCHING):
        mp.setattr(mod, "spmv_iter", jax_spmv_iter)
        mp.setattr(mod, "assign", jax_assign)
    mp.setattr(_JFASTSV, "extract", jax_extract)
    mp.setattr(_JASSIGN, "extract", jax_extract)
    for name in ("mat_reduce", "mat_scale_cols", "mat_apply_local",
                 "mat_ewise_local", "mat_transpose"):
        mp.setattr(_JHIPMCL, name, globals()["jax_" + name])
    try:
        yield
    finally:
        mp.undo()
