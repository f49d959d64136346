"""Parity of the port's vectors, vector/matrix ops, distributed SpMV/SpMSpV
and SpMSpV planner with the JAX package on the 1x1 grid.

One symmetric 48-vertex graph with small integer weights (every f32 sum is
exact) is assembled by ``repro`` and handed to ``repro_torch`` through
``DistSpMat.from_numpy``. The JAX ``spmspv`` reference runs once per
(semiring, mask) from a module-scoped fixture, jitted; every variant ×
merge of the port is held against that one result, since all of them
compute the same y. Index structure, ``nnz``, ``ok``, layouts, plans and
caps bitwise; bool and min/max values bitwise; f32 sums within
``SUM_RTOL``.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import matops as JO
from repro.core import plan as JP
from repro.core import semiring as jsr
from repro.core.dist import (DistSpMat as JDist, DistSpVec as JSpVec,
                             DistVec as JVec, make_grid as j_make_grid)
from repro.core.mask import vector_mask as j_vector_mask
from repro_torch.core import coo as TC
from repro_torch.core import matops as TO
from repro_torch.core import plan as TP
from repro_torch.core import semiring as tsr
from repro_torch.core.dist import (DistSpMat as TDist, DistSpVec as TSpVec,
                                   DistVec as TVec, make_grid as t_make_grid)
from repro_torch.core.mask import vector_mask as t_vector_mask
from repro_torch.obs import recorder

from torch_parity import (CPU, assert_dist_equal, assert_values,
                          jax_apps_jitted, jax_spmspv, np_of)

# the packages' ``core`` exports the function ``spmv`` under the module name
JS = importlib.import_module("repro.core.spmv")
TS = importlib.import_module("repro_torch.core.spmv")

N = 48
SEMIRINGS = {"arith": (jsr.ARITHMETIC, tsr.ARITHMETIC),
             "bool": (jsr.BOOLEAN, tsr.BOOLEAN)}
VARIANTS = ("sort", "bucket", "spa")


def _dense(seed, n=N, density=0.1, symmetric=True, vmax=5):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < density).astype(np.float32)
    d *= rng.integers(1, vmax, (n, n)).astype(np.float32)
    np.fill_diagonal(d, 0)
    return np.maximum(d, d.T) if symmetric else d


def _pair(dense, order="row"):
    r, c = np.nonzero(dense)
    j = JDist.from_global_coo(dense.shape, r, c, dense[r, c], (1, 1),
                              cap=1024, order=order)
    t = TDist.from_numpy(np_of(j.row), np_of(j.col), np_of(j.val),
                         np_of(j.nnz), j.shape, j.grid, j.order, CPU)
    return j, t


@pytest.fixture(scope="module")
def meshes():
    return j_make_grid(1, 1), t_make_grid(1, 1, device="cpu")


@pytest.fixture(scope="module")
def graph():
    dense = _dense(0)
    return (dense,) + _pair(dense)


def _frontier(n=N, f=12, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, f, replace=False)).astype(np.int64)
    val = rng.integers(1, 4, f).astype(np.float32)
    return idx, (val > 0) if dtype == np.bool_ else val


def _levels(n=N, seed=2):
    """A BFS-like levels vector: -1 (unvisited) on about half the rows."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < 0.5, -1, rng.integers(0, 4, n)) \
        .astype(np.int32)


def _vec_pair(x, layout="col"):
    return (JVec.from_global(x, (1, 1), layout=layout),
            TVec.from_global(x, (1, 1), layout=layout, device="cpu"))


def _spvec_pair(idx, val, cap=64, layout="col"):
    return (JSpVec.from_global(idx, val, N, (1, 1), cap=cap, layout=layout),
            TSpVec.from_global(idx, val, N, (1, 1), cap=cap, layout=layout,
                               device="cpu"))


def assert_spvec_equal(got: TSpVec, want: JSpVec, exact=False):
    assert (got.n, got.grid, got.layout, got.cap) == \
        (want.n, tuple(want.grid), want.layout, want.cap)
    np.testing.assert_array_equal(np_of(got.idx), np_of(want.idx))
    np.testing.assert_array_equal(np_of(got.nnz), np_of(want.nnz))
    assert_values(got.val, want.val, exact)


def assert_vec_equal(got: TVec, want: JVec, exact=False):
    assert (got.n, got.grid, got.layout) == \
        (want.n, tuple(want.grid), want.layout)
    assert_values(got.data, want.data, exact)


# --------------------------------------------------------------------------
# vectors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("kind", ["f32", "i32", "bool", "f32x3"])
def test_distvec_round_trip(layout, kind):
    rng = np.random.default_rng(3)
    x = {"f32": rng.random(37).astype(np.float32),
         "i32": rng.integers(-5, 5, 37).astype(np.int32),
         "bool": rng.random(37) < 0.5,
         "f32x3": rng.random((37, 3)).astype(np.float32)}[kind]
    jv, tv = _vec_pair(x, layout)
    assert tv.vb == jv.vb and tv.piece_id(0, 0) == jv.piece_id(0, 0)
    assert_vec_equal(tv, jv, exact=True)
    np.testing.assert_array_equal(tv.to_global(), x)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("cap", [None, 40])
@pytest.mark.parametrize("f", [0, 1, 20])
def test_distspvec_round_trip(layout, cap, f):
    """The ``pad=1.5`` cap rule, rounded up to 8, and the round trips."""
    idx, val = _frontier(f=f, seed=4)
    idx = idx[::-1].copy()                  # from_global sorts the pieces
    val = val[::-1].copy()
    j = JSpVec.from_global(idx, val, N, (1, 1), cap=cap, layout=layout)
    t = TSpVec.from_global(idx, val, N, (1, 1), cap=cap, layout=layout,
                           device="cpu")
    assert t.vb == j.vb
    assert_spvec_equal(t, j, exact=True)
    for got, want in zip(t.to_global(), j.to_global()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.to_global_dense(), j.to_global_dense())


def test_distspvec_piece_overflow():
    idx, val = _frontier(f=20, seed=5)
    for make in (lambda: JSpVec.from_global(idx, val, N, (1, 1), cap=16),
                 lambda: TSpVec.from_global(idx, val, N, (1, 1), cap=16,
                                            device="cpu")):
        with pytest.raises(ValueError, match="piece overflow"):
            make()


def test_vectors_refuse_a_larger_grid():
    """Vectors on a grid of several positions need an initialized world
    of that many ranks: without one they raise a clear RuntimeError."""
    with pytest.raises(RuntimeError, match="4 ranks"):
        TVec.from_global(np.zeros(8, np.float32), (2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="2 ranks"):
        TSpVec.from_global(np.arange(3), np.ones(3), 8, (1, 2), device="cpu")


def test_vector_ops():
    rng = np.random.default_rng(6)
    u = rng.random(N).astype(np.float32)
    v = rng.random(N).astype(np.float32)
    (ju, tu), (jv, tv) = _vec_pair(u), _vec_pair(v)
    assert_vec_equal(TO.vec_ewise(tu, tv, torch.maximum),
                     JO.vec_ewise(ju, jv, jnp.maximum), exact=True)
    assert_vec_equal(TO.vec_apply(tu, lambda d: 2 * d + 1),
                     JO.vec_apply(ju, lambda d: 2 * d + 1), exact=True)
    assert_values(TO.vec_sum(tu), JO.vec_sum(ju))
    idx, val = _frontier(seed=7)
    jx, tx = _spvec_pair(idx, val)
    assert int(TO.spvec_nnz(tx)) == int(JO.spvec_nnz(jx)) == len(idx)
    keep = lambda xv, vv: vv > 0.5
    assert_spvec_equal(TO.spvec_mask(tx, tv, keep),
                       JO.spvec_mask(jx, jv, keep), exact=True)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_vec_scatter_spvec(dtype):
    """SENTINEL slots of the sparse vector write nothing (no slot vb-1
    write: the last entry of v keeps its value)."""
    lv = np.arange(N).astype(dtype) - 3
    jl, tl = _vec_pair(lv, "row")
    idx, val = _frontier(seed=8, dtype=np.bool_)
    assert N - 1 not in idx
    jx, tx = _spvec_pair(idx, val, layout="row")
    for fn_j, fn_t in ((lambda c, x: jnp.zeros_like(c),
                        lambda c, x: torch.zeros_like(c)),
                       (lambda c, x: c * 2 + x, lambda c, x: c * 2 + x)):
        got = TO.vec_scatter_spvec(tl, tx, fn_t)
        assert_vec_equal(got, JO.vec_scatter_spvec(jl, jx, fn_j), exact=True)
        assert got.to_global()[N - 1] == lv[N - 1]


# --------------------------------------------------------------------------
# matrix ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("monoid", ["PLUS", "MIN", "MAX"])
def test_mat_reduce(meshes, graph, axis, monoid):
    jmesh, tmesh = meshes
    _, ja, ta = graph
    want = JO.mat_reduce(ja, axis, getattr(jsr, monoid), mesh=jmesh)
    got = TO.mat_reduce(ta, axis, getattr(tsr, monoid), mesh=tmesh)
    assert_vec_equal(got, want, exact=True)        # small integer sums


def test_mat_scale_and_transpose(meshes):
    jmesh, tmesh = meshes
    dense = _dense(9, symmetric=False)
    ja, ta = _pair(dense)
    d = (np.random.default_rng(10).random(N) + 0.5).astype(np.float32)
    for layout, name in (("col", "mat_scale_cols"), ("row", "mat_scale_rows")):
        jv, tv = _vec_pair(d, layout)
        assert_dist_equal(getattr(TO, name)(ta, tv, mesh=tmesh),
                          getattr(JO, name)(ja, jv, mesh=jmesh), exact=True)
    for order in ("row", "col"):
        ja, ta = _pair(dense, order)
        got = TO.mat_transpose(ta, mesh=tmesh)
        assert got.order == {"row": "col", "col": "row"}[order]
        assert_dist_equal(got, JO.mat_transpose(ja, mesh=jmesh), exact=True)
        np.testing.assert_array_equal(got.to_dense(), dense.T)


def test_mat_ewise_local(meshes):
    jmesh, tmesh = meshes
    (ja, ta), (jb, tb) = _pair(_dense(11)), _pair(_dense(12))
    from repro.core.coo import ewise_union as j_union
    want = JO.mat_ewise_local(ja, jb, lambda x, y: j_union(x, y, jsr.PLUS,
                                                           cap=1024),
                              mesh=jmesh)
    got = TO.mat_ewise_local(ta, tb, lambda x, y: TC.ewise_union(
        x, y, tsr.PLUS, 1024), mesh=tmesh)
    assert_dist_equal(got, want, exact=True)


# --------------------------------------------------------------------------
# distributed SpMV
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["row", "col"])
@pytest.mark.parametrize("sr", ["ARITHMETIC", "MIN_PLUS"])
def test_spmv(meshes, graph, variant, sr):
    jmesh, tmesh = meshes
    dense, ja, ta = graph
    x = np.random.default_rng(13).integers(1, 9, N).astype(np.float32)
    jx, tx = _vec_pair(x)
    want = JS.spmv(ja, jx, getattr(jsr, sr), mesh=jmesh, variant=variant)
    with recorder.capture() as rec:
        got = TS.spmv(ta, tx, getattr(tsr, sr), mesh=tmesh, variant=variant)
        assert "spmv" in rec.snapshot()["spans"]
    assert_vec_equal(got, want, exact=True)
    if sr == "ARITHMETIC":
        np.testing.assert_array_equal(got.to_global(), dense @ x)
    it = TS.spmv_iter(ta, tx, getattr(tsr, sr), mesh=tmesh, variant=variant)
    assert it.layout == "col"
    assert_vec_equal(it, JS.transpose_layout(want, mesh=jmesh), exact=True)
    assert TS.transpose_layout(it, mesh=tmesh).layout == "row"


def test_spmv_variant(graph):
    dense, ja, ta = graph
    jc, tc = _pair(dense, "col")
    assert TP.spmv_variant(ta) == JP.spmv_variant(ja) == "row"
    assert TP.spmv_variant(tc) == JP.spmv_variant(jc) == "col"


# --------------------------------------------------------------------------
# distributed SpMSpV
# --------------------------------------------------------------------------

CAPS = dict(prod_cap=256, out_cap=64)


@pytest.fixture(scope="module")
def spmspv_refs(meshes, graph):
    """The JAX ``spmspv`` once per (semiring, masked) at caps that fit, and
    once at an out_cap that overflows (its ``ok``), all jitted."""
    jmesh, _ = meshes
    _, ja, _ = graph
    refs = {}
    for name, (jsr_, _) in SEMIRINGS.items():
        idx, val = _frontier(dtype=np.bool_ if name == "bool" else
                             np.float32)
        jx = JSpVec.from_global(idx, val, N, (1, 1), cap=64)
        for masked in (False, True):
            jm = None
            if masked:
                jl = JVec.from_global(_levels(), (1, 1), layout="row")
                jm = j_vector_mask(jl, lambda lv: lv >= 0, complement=True)
            refs[name, masked] = jax_spmspv(ja, jx, jsr_, mesh=jmesh,
                                            variant="sort", merge="sparse",
                                            mask=jm, **CAPS)
        refs[name, "overflow"] = jax_spmspv(
            ja, jx, jsr_, mesh=jmesh, variant="sort", merge="sparse",
            prod_cap=256, out_cap=8)
    return refs


@pytest.mark.parametrize("name", sorted(SEMIRINGS))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("merge", ["sparse", "dense"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_spmspv(meshes, graph, spmspv_refs, name, masked, merge, variant):
    _, tmesh = meshes
    dense, _, ta = graph
    tsr_ = SEMIRINGS[name][1]
    idx, val = _frontier(dtype=np.bool_ if name == "bool" else np.float32)
    tx = TSpVec.from_global(idx, val, N, (1, 1), cap=64, device="cpu")
    tm = None
    if masked:
        tl = TVec.from_global(_levels(), (1, 1), layout="row", device="cpu")
        tm = t_vector_mask(tl, lambda lv: lv >= 0, complement=True)
    with recorder.capture() as rec:
        y, ok = TS.spmspv(ta, tx, tsr_, mesh=tmesh, variant=variant,
                          merge=merge, mask=tm, **CAPS)
        spans = rec.snapshot()["spans"]
    assert {"spmspv", "spmspv.execute"} <= set(spans)
    jy, jok = spmspv_refs[name, masked]
    np.testing.assert_array_equal(np_of(ok), np_of(jok))
    assert bool(ok.all())
    assert_spvec_equal(y, jy, exact=name == "bool")
    # and against the dense product, masked rows dropped
    xd = np.zeros(N, np.float32)
    xd[idx] = val
    want = dense @ xd
    if masked:
        want[_levels() >= 0] = 0
    if name == "bool":
        want = want > 0
    np.testing.assert_array_equal(y.to_global_dense(zero=want.dtype.type(0)),
                                  want)
    _, ok = TS.spmspv(ta, tx, tsr_, mesh=tmesh, variant=variant, merge=merge,
                      prod_cap=256, out_cap=8)
    np.testing.assert_array_equal(np_of(ok),
                                  np_of(spmspv_refs[name, "overflow"][1]))


def test_spmspv_refuses_a_pattern_mask(meshes, graph):
    from repro_torch.core.mask import structural
    _, tmesh = meshes
    _, _, ta = graph
    idx, val = _frontier()
    tx = TSpVec.from_global(idx, val, N, (1, 1), cap=64, device="cpu")
    with pytest.raises(ValueError, match="dense-vector masks"):
        TS.spmspv(ta, tx, tsr.ARITHMETIC, mesh=tmesh, mask=structural(ta),
                  **CAPS)


def test_transpose_spvec_layout(meshes):
    jmesh, tmesh = meshes
    jx, tx = _spvec_pair(*_frontier(seed=14), layout="row")
    got = TS.transpose_spvec_layout(tx, mesh=tmesh)
    assert_spvec_equal(got, JS.transpose_spvec_layout(jx, mesh=jmesh),
                       exact=True)
    assert got.layout == "col"


# --------------------------------------------------------------------------
# the SpMSpV planner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f", [1, 5, 30, 48])
@pytest.mark.parametrize("add_tag", [None, "sum", "max"])
@pytest.mark.parametrize("allowed", [None, 0, 7])
def test_plan_spmspv(graph, f, add_tag, allowed):
    _, ja, ta = graph
    kw = dict(add_tag=add_tag, mask_allowed=allowed)
    assert dataclasses.asdict(TP.plan_spmspv(ta, f, **kw)) == \
        dataclasses.asdict(JP.plan_spmspv(ja, f, **kw))
    kw.update(prod_cap=100, out_cap=3000, variant="spa")
    assert dataclasses.asdict(TP.plan_spmspv(ta, f, **kw)) == \
        dataclasses.asdict(JP.plan_spmspv(ja, f, **kw))


@pytest.mark.parametrize("masked", [False, True])
def test_planned_spmspv_overflow_retry(meshes, graph, masked):
    """prod_cap forced below the products: both planners retry with caps
    grown x4 (64 -> 256 -> 512, the ceiling), in the same attempts, caps
    and result."""
    jmesh, tmesh = meshes
    _, ja, ta = graph
    idx, val = _frontier(f=30, seed=15, dtype=np.bool_)
    jx = JSpVec.from_global(idx, val, N, (1, 1), cap=64)
    tx = TSpVec.from_global(idx, val, N, (1, 1), cap=64, device="cpu")
    jm = tm = None
    if masked:
        jl, tl = _vec_pair(_levels(seed=16), "row")
        jm = j_vector_mask(jl, lambda lv: lv >= 0, complement=True)
        tm = t_vector_mask(tl, lambda lv: lv >= 0, complement=True)
    with jax_apps_jitted():
        jy, jp = JP.spmspv(ja, jx, jsr.BOOLEAN, mesh=jmesh, prod_cap=64,
                           mask=jm)
    with recorder.capture() as rec:
        ty, tp = TP.spmspv(ta, tx, tsr.BOOLEAN, mesh=tmesh, prod_cap=64,
                           mask=tm)
        events = [e["name"] for e in rec.events()]
    assert tp.attempts == jp.attempts == 3
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert events == ["plan.spmspv"] + ["plan.overflow_retry"] * 2 + \
        ["plan.spmspv.done"]
    assert_spvec_equal(ty, jy, exact=True)


def test_planned_spmspv_raises_where_jax_takes_a_rung(meshes, graph):
    _, tmesh = meshes
    _, _, ta = graph
    idx, val = _frontier(f=30, seed=15, dtype=np.bool_)
    tx = TSpVec.from_global(idx, val, N, (1, 1), cap=64, device="cpu")
    with pytest.raises(RuntimeError, match="still overflowing"):
        TP.spmspv(ta, tx, tsr.BOOLEAN, mesh=tmesh, prod_cap=64,
                  max_attempts=1)
