"""Parity of the port's 2D SpGEMM, local SpGEMM and planner on the 1x1 grid.

Both packages multiply the same tiles: the JAX ``DistSpMat`` is assembled
from numpy and its arrays are handed to ``repro_torch`` through
``DistSpMat.from_numpy``. Every schedule/merge pair the planner can pick at
q = 1 runs with and without a structural mask; products are small integers,
so every sum is exact and C must match bitwise.
"""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from repro.core import local_spgemm as JL
from repro.core import plan as JP
from repro.core import semiring as jsr
from repro.core.dist import DistSpMat as JDist, make_grid as j_make_grid
from repro.core.mask import local_mask as j_local_mask
from repro.core.mask import structural as j_structural
from repro_torch.core import local_spgemm as TL
from repro_torch.core import plan as TP
from repro_torch.core import semiring as tsr
from repro_torch.core.dist import DistSpMat as TDist, make_grid as t_make_grid
from repro_torch.core.mask import local_mask as t_local_mask
from repro_torch.core.mask import structural as t_structural
from repro_torch.core.spgemm import spgemm_2d as t_spgemm_2d
from repro_torch.obs import recorder

from torch_parity import (CPU, assert_coo_equal, assert_dist_equal, coo_pair,
                          jax_reference, jax_spgemm_2d, jit_ref, np_of)


@pytest.fixture(scope="module")
def meshes():
    with jax_reference():
        yield j_make_grid(1, 1), t_make_grid(1, 1, device="cpu")


def graph_pair(n=40, density=0.12, seed=0, vmax=4):
    """A symmetric random graph with small integer weights, both packages."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density).astype(np.float32)
    dense *= rng.integers(1, vmax, (n, n)).astype(np.float32)
    np.fill_diagonal(dense, 0)
    dense = np.maximum(dense, dense.T)
    r, c = np.nonzero(dense)
    j = JDist.from_global_coo((n, n), r.astype(np.int64), c.astype(np.int64),
                              dense[r, c], (1, 1))
    t = TDist.from_numpy(np_of(j.row), np_of(j.col), np_of(j.val),
                         np_of(j.nnz), j.shape, j.grid, j.order, CPU)
    return j, t


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("merge", ["sort", "deferred", "incremental"])
def test_spgemm_2d(meshes, merge, masked):
    """Each merge mode against JAX's rotate schedule. At q = 1 the
    schedules differ only in which port code merges the one stage; with
    exact sums both give JAX's C bitwise, so both run against it."""
    jmesh, tmesh = meshes
    ja, ta = graph_pair(seed=1)
    # masked: out_cap 512 of prod_cap 4096 splits the stage buffer into
    # MAX_WINDOWS compaction windows; unmasked: two windows of 2048
    out_cap = 512 if masked else 2048
    jm = j_structural(ja) if masked else None
    tm = t_structural(ta) if masked else None
    jc, jok = jax_spgemm_2d(ja, ja, jsr.ARITHMETIC, mesh=jmesh,
                            prod_cap=4096, out_cap=out_cap,
                            variant="rotation", merge=merge, mask=jm)
    assert bool(jok.all())
    for variant in ("rotation", "allgather", "hybrid"):
        tc, tok = t_spgemm_2d(ta, ta, tsr.ARITHMETIC, mesh=tmesh,
                              prod_cap=4096, out_cap=out_cap,
                              variant=variant, merge=merge, mask=tm)
        np.testing.assert_array_equal(np_of(tok), np_of(jok))
        assert_dist_equal(tc, jc, exact=True)


@pytest.mark.parametrize("merge", ["sort", "deferred", "incremental"])
def test_spgemm_2d_overflow_flags(meshes, merge):
    # prod_cap and out_cap far below the need: ok false on both sides, and
    # the truncated tiles agree slot for slot
    jmesh, tmesh = meshes
    ja, ta = graph_pair(seed=2)
    jc, jok = jax_spgemm_2d(ja, ja, jsr.ARITHMETIC, mesh=jmesh,
                            prod_cap=1024, out_cap=128, variant="rotation",
                            merge=merge)
    tc, tok = t_spgemm_2d(ta, ta, tsr.ARITHMETIC, mesh=tmesh, prod_cap=1024,
                          out_cap=128, variant="rotation", merge=merge)
    assert not bool(jok.all())
    np.testing.assert_array_equal(np_of(tok), np_of(jok))
    assert_dist_equal(tc, jc, exact=True)


@pytest.mark.parametrize("masked", [False, True])
def test_planned_retry(meshes, masked):
    """A lowballed plan overflows, retries with grown caps, and both
    packages end on the same plan and the same C."""
    jmesh, tmesh = meshes
    ja, ta = graph_pair(n=32, density=0.3, seed=3)
    jmask = j_structural(ja) if masked else None
    tmask = t_structural(ta) if masked else None
    honest = JP.plan_spgemm(ja, ja, mask=jmask)
    low = dict(prod_cap=honest.prod_cap // 16, out_cap=honest.out_cap // 16,
               variant=honest.variant,
               merge=honest.merge, prod_ceiling=honest.prod_ceiling,
               out_ceiling=honest.out_ceiling, est_flops=0, est_out=0)
    jc, jp = JP.spgemm(ja, ja, jsr.ARITHMETIC, mesh=jmesh,
                       plan=JP.SpGEMMPlan(**low), mask=jmask)
    with recorder.capture() as rec:
        tc, tp = TP.spgemm(ta, ta, tsr.ARITHMETIC, mesh=tmesh,
                           plan=TP.SpGEMMPlan(**low), mask=tmask)
        retries = rec.events("plan.overflow_retry")
        spans = rec.snapshot()["spans"]
    assert tp.attempts == jp.attempts > 1
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert len(retries) == tp.attempts - 1
    assert {"spgemm2d", "spgemm2d.execute"} <= set(spans)
    assert_dist_equal(tc, jc, exact=True)


def test_planner_raises_when_retries_run_out(meshes):
    """Caps that can never grow: each failed attempt takes a ladder rung
    (loudly), and the planner raises once the ladder is exhausted."""
    from repro_torch.robust import recover
    _, tmesh = meshes
    _, ta = graph_pair(seed=4)
    honest = TP.plan_spgemm(ta, ta)
    low = dataclasses.replace(honest, prod_cap=64, out_cap=64)
    try:
        with pytest.raises(RuntimeError, match="still overflowing"), \
                pytest.warns(RuntimeWarning, match="degrading pipeline"):
            TP.spgemm(ta, ta, tsr.ARITHMETIC, mesh=tmesh, plan=low,
                      max_attempts=1)
    finally:
        recover.reset_degradation()     # the 'legacy-dedup' rung's switch


@pytest.mark.parametrize("kw", [
    {}, {"safety": 1.0}, {"prod_cap": 1 << 15, "out_cap": 1 << 12},
    {"merge": "sort", "variant": "rotation"}, {"mem_budget": 256},
    {"schedule": "alltoall"}, {"mask": True},
    {"mask": True, "complement": True}])
@pytest.mark.parametrize("density", [0.05, 0.3])
def test_plan_fields_match_jax(kw, density):
    ja, ta = graph_pair(n=48, density=density, seed=5)
    kw = dict(kw)
    if kw.pop("mask", False):
        comp = kw.pop("complement", False)
        kw_j = dict(kw, mask=j_structural(ja, complement=comp))
        kw_t = dict(kw, mask=t_structural(ta, complement=comp))
    else:
        kw_j = kw_t = kw
    want = JP.plan_spgemm(ja, ja, **kw_j)
    got = TP.plan_spgemm(ta, ta, **kw_t)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


class TestLocal:
    @pytest.mark.parametrize("b_order", ["row", "none"])
    @pytest.mark.parametrize("masked", [False, True])
    def test_spgemm_esc(self, b_order, masked):
        # B row-sorted takes the sort-free expansion; untagged B the
        # col-sorted-A formulation
        rng = np.random.default_rng(6)
        r, c = rng.integers(0, 30, 120), rng.integers(0, 30, 120)
        v = rng.integers(1, 4, 120).astype(np.float32)
        ja, ta = coo_pair((30, 30), r, c, v, cap=128)
        ja = jit_ref(lambda x: x.dedup(jsr.PLUS), {}, ja)
        ta = ta.dedup(tsr.PLUS)
        jb, tb = ja, ta
        if b_order == "none":
            jb = dataclasses.replace(ja, order="none")
            tb = dataclasses.replace(ta, order="none")
        jm = j_local_mask(ja) if masked else None
        tm = t_local_mask(ta) if masked else None
        want, jok = jit_ref(JL.spgemm_esc, dict(sr=jsr.ARITHMETIC,
                                                prod_cap=2048, out_cap=512),
                            ja, jb, mask=jm)
        got, tok = TL.spgemm_esc(ta, tb, tsr.ARITHMETIC, prod_cap=2048,
                                 out_cap=512, mask=tm)
        assert bool(tok) == bool(jok)
        assert_coo_equal(got, want, exact=True)
        assert int(TL.spgemm_flops(ta, tb)) == int(JL.spgemm_flops(ja, jb))
        assert float(TL.compression_ratio(ta, tb)) == \
            float(JL.compression_ratio(ja, jb))


def test_one_by_one_grid_only():
    """Without an initialized world of 4 ranks (one process a grid
    position), a 2x2 grid and a matrix on it raise a clear RuntimeError;
    the 1x1 grid needs no process group."""
    with pytest.raises(RuntimeError, match="torch.distributed initialized "
                                           "with 4 ranks"):
        t_make_grid(2, 2, device="cpu")
    r = np.asarray([0, 1], np.int64)
    with pytest.raises(RuntimeError, match="4 ranks"):
        TDist.from_global_coo((4, 4), r, r, np.ones(2, np.float32), (2, 2),
                              device="cpu")
    assert t_make_grid(1, 1, device="cpu").pr == 1


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make_grid(1, 1)
    r = np.asarray([0, 1], np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDist.from_global_coo((4, 4), r, r, np.ones(2, np.float32), (1, 1))


def test_compress_waits_for_distributed_slice(meshes):
    """``compress='int8'`` no longer waits for the distributed slice: on
    the 1x1 grid it runs, held against JAX's (jitted) ``spgemm_2d``. C's
    index structure and ``ok`` are bitwise; its values (sums of dequantized
    products) within 1e-5 of the largest |C|; the residual bitwise against
    JAX's ``quantize_payload`` run op by op, as the JAX package runs it at
    the wire boundary (under ``jit`` XLA contracts the residual's multiply
    and subtract into one FMA)."""
    from repro.dist.compression import quantize_payload
    jmesh, tmesh = meshes
    ja, ta = graph_pair(seed=7)
    kw = dict(prod_cap=4096, out_cap=2048, compress="int8")
    jc, jok, jres = jax_spgemm_2d(ja, ja, jsr.ARITHMETIC, mesh=jmesh,
                                  ef_resid=jax.numpy.zeros_like(ja.val), **kw)
    tc, tok, tres = t_spgemm_2d(ta, ta, tsr.ARITHMETIC, mesh=tmesh,
                                ef_resid=torch.zeros_like(ta.val), **kw)
    assert bool(tok.all()) and bool(jok.all())
    for f in ("row", "col", "nnz"):
        np.testing.assert_array_equal(np_of(getattr(tc, f)),
                                      np_of(getattr(jc, f)))
    want = np_of(jc.val)
    np.testing.assert_allclose(np_of(tc.val), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(np_of(tres),
                                  np_of(quantize_payload(ja.val, ja.nnz)[2]))
    exact, _ = t_spgemm_2d(ta, ta, tsr.ARITHMETIC, mesh=tmesh,
                           prod_cap=4096, out_cap=2048)
    assert np.abs(np_of(tc.val) - np_of(exact.val)).max() > 0
