"""The planner's audit retries, deadline trips and degradation ladder on the
1x1 grid, held against the JAX package's planner on the same inputs.

Every case arms the same fault in both packages (``faults.inject``) and
compares the plan's ``attempts`` and ``degraded`` bitwise, and C (or y):
index structure and nnz bitwise, f32 sums within ``SUM_RTOL``. With the
audit off, a fault passes through both packages, and the port's corrupted
C equals JAX's corrupted C: the same entries were hit. The JAX side runs
its guards eagerly and its multiplies jitted
(``tests/torch_robust_parity.py``).
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch

from repro.core import ARITHMETIC as JAR, make_grid as j_make_grid
from repro.core.dist import DistSpMat as JDist, DistSpMat3D as JDist3
from repro.core.dist import DistSpVec as JVec
from repro.core.mask import structural as j_structural
from repro.core.plan import spgemm as j_spgemm, spmspv as j_spmspv
from repro.robust import audit as jaudit, deadline as jdeadline
from repro.robust import faults as jfaults, recover as jrecover
from repro_torch.core.dist import DistSpMat as TDist, DistSpMat3D as TDist3
from repro_torch.core.dist import DistSpVec as TVec, make_grid
from repro_torch.core.mask import structural
from repro_torch.core.plan import spgemm, spmspv
from repro_torch.core.semiring import ARITHMETIC
from repro_torch.core.spgemm import spgemm_3d
from repro_torch.robust import audit, deadline, faults, recover
from torch_parity import assert_dist_equal, assert_values, np_of
from torch_robust_parity import jax_robust_reference

KINDS = ("nan", "corrupt_val", "corrupt_idx", "drop", "dup")
N = 40


@pytest.fixture(scope="module")
def meshes():
    return j_make_grid(1, 1), make_grid(1, 1, device="cpu")


def _graph(n=N, density=0.3, seed=2):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, n)) < density,
                     rng.random((n, n)).astype(np.float32) + 0.5, 0.0)
    r, c = np.nonzero(dense)
    return dense, (r.astype(np.int64), c.astype(np.int64),
                   dense[r, c].astype(np.float32))


@pytest.fixture(scope="module")
def ab(meshes):
    jm, tm = meshes
    dense, (r, c, v) = _graph()
    return (dense, JDist.from_global_coo((N, N), r, c, v, (1, 1), mesh=jm),
            TDist.from_global_coo((N, N), r, c, v, (1, 1), mesh=tm))


def _both(meshes, j_call, t_call, *specs, level="off"):
    """``(jax_result, port_result)`` with ``specs`` armed and the audit at
    ``level`` in each package; an exception is returned, not raised."""
    out = []
    for fmod, amod, call, mesh, ctx in (
            (jfaults, jaudit, j_call, meshes[0], jax_robust_reference),
            (faults, audit, t_call, meshes[1], contextlib.nullcontext)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with amod.at_level(level), fmod.inject(*specs), ctx():
                try:
                    out.append(call(mesh))
                except (RuntimeError, ValueError) as err:
                    out.append(err)
    return out


def _same_plan_and_c(j, t, exact=False):
    (jc, jp), (tc, tp) = j, t
    assert (tp.attempts, tp.degraded) == (jp.attempts, jp.degraded)
    assert (tp.merge, tp.variant, tp.overlap, tp.compress) == \
        (jp.merge, jp.variant, jp.overlap, jp.compress)
    assert_dist_equal(tc, jc, exact)


def _mm(a, **kw):
    return lambda mesh: (j_spgemm if isinstance(a, JDist) else spgemm)(
        a, a, JAR if isinstance(a, JDist) else ARITHMETIC, mesh=mesh, **kw)


# --------------------------------------------------------------------------
# comm-boundary faults: detected, retried from pristine inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["spgemm2d.comm_a", "spgemm2d.comm_b"])
@pytest.mark.parametrize("kind", KINDS)
def test_spgemm_comm_fault_detected_and_recovered(meshes, ab, site, kind):
    dense, ja, ta = ab
    j, t = _both(meshes, _mm(ja), _mm(ta), f"{site}:{kind}",
                 level="boundary")
    assert t[1].attempts == 2 and t[1].degraded == ()
    _same_plan_and_c(j, t)
    np.testing.assert_allclose(t[0].to_dense(), dense @ dense, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_audit_off_lets_the_same_corruption_through(meshes, ab, kind):
    """The documented trade: with the audit off the fault reaches C — and
    the port's corrupted C is JAX's, so the same entries were hit."""
    dense, ja, ta = ab
    j, t = _both(meshes, _mm(ja), _mm(ta), f"spgemm2d.comm_a:{kind}")
    _same_plan_and_c(j, t)
    if kind == "corrupt_idx":
        # rows past the tile overflow the expansion: the overflow retry
        # runs again from the pristine operand, in both packages
        assert t[1].attempts == 2
        return
    assert t[1].attempts == 1
    got = t[0].to_dense()
    assert not np.allclose(got, dense @ dense, rtol=1e-4, atol=1e-5)


def test_spmspv_comm_x_fault_detected_and_recovered(meshes, ab):
    _, ja, ta = ab
    idx = np.array([0, 3, 17, 22], np.int64)
    val = np.array([1.0, 2.0, 0.5, 3.0], np.float32)
    jx = JVec.from_global(idx, val, N, (1, 1), cap=64, mesh=meshes[0])
    tx = TVec.from_global(idx, val, N, (1, 1), cap=64, mesh=meshes[1])
    calls = (lambda m: j_spmspv(ja, jx, JAR, mesh=m),
             lambda m: spmspv(ta, tx, ARITHMETIC, mesh=m))
    j0, t0 = _both(meshes, *calls)
    for kind in ("corrupt_val", "drop"):
        j, t = _both(meshes, *calls, f"spmspv.comm_x:{kind}",
                     level="boundary")
        assert (t[1].attempts, t[1].degraded) == \
            (j[1].attempts, j[1].degraded) == (2, ())
        for y, y0 in ((t[0], t0[0]), (j[0], j0[0])):
            for g, w in zip(y.to_global(), y0.to_global()):
                np.testing.assert_array_equal(g, w)
        for g, w in zip(t[0].to_global(), j[0].to_global()):
            assert_values(g, w)


# --------------------------------------------------------------------------
# lying ok flags and the degradation ladder
# --------------------------------------------------------------------------

def test_ok_flips_retry(meshes, ab):
    _, ja, ta = ab
    j, t = _both(meshes, _mm(ja), _mm(ta), "plan.spgemm.ok:flip")
    assert t[1].attempts == 2
    _same_plan_and_c(j, t)
    x = (np.array([1, 5], np.int64), np.array([1.0, 1.0], np.float32))
    jx = JVec.from_global(*x, N, (1, 1), cap=64, mesh=meshes[0])
    tx = TVec.from_global(*x, N, (1, 1), cap=64, mesh=meshes[1])
    j, t = _both(meshes, lambda m: j_spmspv(ja, jx, JAR, mesh=m),
                 lambda m: spmspv(ta, tx, ARITHMETIC, mesh=m),
                 "plan.spmspv.ok:flip")
    assert t[1].attempts == j[1].attempts == 2
    for g, w in zip(t[0].to_global(), j[0].to_global()):
        assert_values(g, w)


def test_persistent_merge_fault_walks_ladder(meshes):
    """``merge.kv_ok`` armed for the whole call: every deferred-merge
    attempt reads as overflowed, growth hits the ceiling, and the ladder
    sheds the overlap, the fused mask (C⟨A⟩ then filtered after the
    multiply) and the merge engine; the sort merge never reaches kv_tree
    and gives C."""
    dense, (r, c, v) = _graph(44, 0.3, 7)
    ja = JDist.from_global_coo((44, 44), r, c, v, (1, 1), mesh=meshes[0])
    ta = TDist.from_global_coo((44, 44), r, c, v, (1, 1), mesh=meshes[1])
    jkw, tkw = dict(mask=j_structural(ja)), dict(mask=structural(ta))
    try:
        j, t = _both(meshes, _mm(ja, merge="deferred", prod_cap=1 << 15,
                                 **jkw),
                     _mm(ta, merge="deferred", prod_cap=1 << 15, **tkw),
                     "merge.kv_ok:flip")
    finally:
        jrecover.reset_degradation()
        recover.reset_degradation()
    assert t[1].degraded == ("serial-schedule:overlap", "postfilter",
                             "sort-merge")
    _same_plan_and_c(j, t)
    want = dense @ dense * (dense != 0)
    np.testing.assert_allclose(t[0].to_dense(), want, rtol=1e-4, atol=1e-5)


def test_compressed_exchange_fault(meshes, ab):
    """A corrupted int8 payload is caught and retried compressed; when it
    persists the ladder sheds compression and overlap (recorded)."""
    dense, ja, ta = ab
    for spec, attempts in (("dist.compressed_exchange:corrupt_val", 2),
                           ("dist.compressed_exchange:corrupt_val:count=99",
                            5)):
        j, t = _both(meshes, _mm(ja, compress="int8"),
                     _mm(ta, compress="int8"), spec, level="boundary")
        assert t[1].attempts == attempts
        _same_plan_and_c(j, t)
    assert t[1].compress is None and t[1].overlap is False
    assert t[1].degraded == ("serial-schedule:overlap+compress=int8",)
    np.testing.assert_allclose(t[0].to_dense(), dense @ dense, rtol=1e-4,
                               atol=1e-5)


def test_deadline_trips_back_off_then_shed_then_topology(meshes):
    """A straggling exchange trips the deadline, backs off (the seeded
    draws), sheds the overlapped schedule; a persistent one exhausts the
    ladder and escalates to TopologyError at the same site."""
    _, (r, c, v) = _graph(24, 0.2, 13)
    ja = JDist.from_global_coo((24, 24), r, c, v, (1, 1), mesh=meshes[0])
    ta = TDist.from_global_coo((24, 24), r, c, v, (1, 1), mesh=meshes[1])

    def under(cfg, call, dmod):
        def run(mesh):
            with dmod.configure(**cfg):
                return call(mesh)
        return run
    cfg = dict(startup_deadline=0.05, backoff_base=0.01)
    j, t = _both(meshes, under(cfg, _mm(ja), jdeadline),
                 under(cfg, _mm(ta), deadline),
                 "dist.exchange_deadline:delay:amount=0.15,count=4")
    assert t[1].attempts == 5
    assert t[1].degraded == ("serial-schedule:overlap",)
    _same_plan_and_c(j, t)
    cfg = dict(startup_deadline=0.02, backoff_base=0.005)
    try:
        j, t = _both(meshes, under(cfg, _mm(ja), jdeadline),
                     under(cfg, _mm(ta), deadline),
                     "dist.exchange_deadline:delay:amount=0.05,count=99")
    finally:
        jrecover.reset_degradation()
        recover.reset_degradation()
    assert isinstance(j, jdeadline.TopologyError)
    assert isinstance(t, deadline.TopologyError)
    assert t.site == j.site == "spgemm2d.comm_a"
    assert str(t) == str(j)


def test_ladder_rung_order_and_exhaustion():
    class P:
        degraded = ()
        merge = "deferred"
        attempts = 1
    for mod in (recover, jrecover):
        assert mod.next_rung(P(), None, kind="spgemm") == "sort-merge"
        assert mod.next_rung(P(), object(), kind="spgemm") == "postfilter"
        p = P()
        p.degraded = mod.LADDER
        assert mod.next_rung(p, object(), kind="spgemm") is None
    assert recover.LADDER == jrecover.LADDER
    assert recover._RUNGS == jrecover._RUNGS
    # the port never offers 'pure-jax-segreduce': past legacy-dedup the
    # ladder is exhausted, as JAX's once its backend resolved to none
    p = P()
    p.degraded = ("serial-schedule", "postfilter", "sort-merge",
                  "legacy-dedup")
    assert recover.next_rung(p, object(), kind="spgemm") is None
    assert recover.next_rung(P(), None, kind="spmspv") is None
    with pytest.raises(ValueError, match="pure-jax-segreduce"):
        recover.apply_rung("pure-jax-segreduce", P())


# --------------------------------------------------------------------------
# sites without a retry loop: fail loud
# --------------------------------------------------------------------------

def test_spgemm3d_comm_fault_fails_loud():
    """spgemm_3d has no planner retry: corruption at its wire boundary
    raises, naming the site, as the JAX package's guard does."""
    _, (r, c, v) = _graph(32, 0.2, 3)
    mats = {}
    for dist in ("acol", "brow"):
        mats[dist] = (JDist3.from_global_coo((32, 32), r, c, v, (1, 1, 1),
                                             dist, cap=512),
                      TDist3.from_global_coo((32, 32), r, c, v, (1, 1, 1),
                                             dist, cap=512, device="cpu"))
    mesh3 = make_grid(1, 1, 1, device="cpu")
    for site, dist in (("spgemm3d.comm_a", "acol"),
                       ("spgemm3d.comm_b", "brow")):
        with jaudit.at_level("boundary"), audit.at_level("boundary"), \
                jfaults.inject(f"{site}:corrupt_idx"), \
                faults.inject(f"{site}:corrupt_idx"):
            with pytest.raises(jaudit.AuditError) as je:
                jaudit.guard_exchange(site, mats[dist][0])
            with pytest.raises(audit.AuditError) as te:
                spgemm_3d(mats["acol"][1], mats["brow"][1], ARITHMETIC,
                          mesh=mesh3, prod_cap=8192, out_cap=4096)
        assert te.value.site == je.value.site == site
        assert str(te.value) == str(je.value)


def test_dist_assemble_full_audit_raises():
    _, (r, c, v) = _graph(30, 0.2, 4)
    errs = []
    for fmod, amod, cls, kw in ((jfaults, jaudit, JDist, {}),
                                (faults, audit, TDist, {"device": "cpu"})):
        with amod.at_level("full"), \
                fmod.inject("dist.assemble:corrupt_idx"), \
                pytest.raises(amod.AuditError) as ei:
            cls.from_global_coo((30, 30), r, c, v, (1, 1), **kw)
        errs.append(ei.value)
    assert errs[1].site == errs[0].site == "dist.assemble"
    assert str(errs[1]) == str(errs[0])
    # audit off: assembly passes the corrupted tile on, the same one
    with jfaults.inject("dist.assemble:dup"), faults.inject(
            "dist.assemble:dup"):
        j = JDist.from_global_coo((30, 30), r, c, v, (1, 1))
        t = TDist.from_global_coo((30, 30), r, c, v, (1, 1), device="cpu")
    assert_dist_equal(t, j, exact=True)
    assert int(np_of(t.nnz).sum()) == len(r) + 1
    assert isinstance(t.row, torch.Tensor)
