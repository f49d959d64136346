"""The port's 2D SUMMA and planner at q = 2 against the JAX package's.

Four gloo CPU ranks run the port on a 2x2 grid (``torch_dist_parity``);
the JAX package runs the same case body on 4 forced XLA host devices.
Products are small integers, so every sum is exact and C's tiles, the
``ok`` flags and the plans must match bitwise, under every schedule
(rotate, alltoall, bcast, the per-stage hybrid tuple) x merge (sort,
deferred, incremental), unmasked, with a structural mask and with its
complement. The port runs each with ``overlap`` on and off, and the two
must be bitwise equal. The planner's per-stage hybrid pick, its overflow
retry and ``demote_stage`` are held against JAX's too.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from torch_dist_parity import (JaxReference, compare, port_cases,
                               run_ranks)

N = 96
GRID = (2, 2)
SCHEDULES = {"rotate": "rotation", "alltoall": "allgather",
             "bcast": "hybrid", ("gather", "bcast"): "hybrid"}
MERGES = ("sort", "deferred", "incremental")
MASKS = ("none", "structural", "complement")
PROD_CAP, OUT_CAP = 4096, 2048


def _graph(seed=0, density=0.08, skew=False):
    """A symmetric graph with small integer weights; ``skew`` packs most
    entries into the first row and column blocks, so SUMMA's stages move
    very different volumes."""
    rng = np.random.default_rng(seed)
    p = np.full((N, N), density)
    if skew:
        p[:N // 2, :N // 2] = 0.5
        p[N // 2:, N // 2:] = 0.01
    dense = (rng.random((N, N)) < p) * rng.integers(1, 4, (N, N))
    dense = np.triu(dense, 1)
    dense = dense + dense.T
    r, c = np.nonzero(dense)
    return r.astype(np.int64), c.astype(np.int64), \
        dense[r, c].astype(np.float32)


def _case_keys():
    for sched in SCHEDULES:
        for merge in MERGES:
            for m in MASKS:
                # the complement with every schedule under one merge
                if m != "complement" or merge == "deferred":
                    yield sched, merge, m


def _key(sched, merge, m):
    return f"{'+'.join(sched) if isinstance(sched, tuple) else sched}" \
        f"/{merge}/{m}"


def spgemm_cases(F):
    out = {}
    r, c, v = _graph()
    a = F.dist.DistSpMat.from_global_coo((N, N), r, c, v, GRID, mesh=F.mesh)
    masks = {"none": None, "structural": F.mask.structural(a),
             "complement": F.mask.complement_of(a)}
    port = F.package == "repro_torch"
    for sched, merge, m in _case_keys():
        kw = dict(mesh=F.mesh, prod_cap=PROD_CAP, out_cap=OUT_CAP,
                  variant=SCHEDULES[sched], merge=merge, mask=masks[m],
                  schedule=sched)
        cm, ok = F.plan._spgemm_2d(a, a, F.semiring.ARITHMETIC, **kw)
        res = dict(F.fields(cm), ok=F.out(ok), **{"g:tag": cm.order})
        if port:
            c2, ok2 = F.plan._spgemm_2d(a, a, F.semiring.ARITHMETIC,
                                        overlap=False, **kw)
            res["port:bulk"] = (F.fields(c2), F.out(ok2))
        out[_key(sched, merge, m)] = res
    # stored -0.0s whose one (max, +) product lands alone in C: the bcast
    # schedule delivers tiles as JAX's masked psum does (+0.0), rotate
    # keeps -0.0 (max from -inf keeps the sign)
    z = np.asarray([5, 70], np.int64), np.asarray([70, 40], np.int64)
    zv = np.asarray([-0.0, -0.0], np.float32)
    az = F.dist.DistSpMat.from_global_coo((N, N), *z, zv, GRID, mesh=F.mesh)
    for sched in ("rotate", "bcast"):
        cz, _ = F.plan._spgemm_2d(az, az, F.semiring.MAX_PLUS,
                                  mesh=F.mesh, prod_cap=64, out_cap=64,
                                  merge="sort", variant=SCHEDULES[sched],
                                  schedule=sched)
        live = F.out(cz.row) != 2**31 - 1
        out[f"signed_zero/{sched}"] = dict(
            F.fields(cz), sign=np.signbit(F.out(cz.val)) & live)
    # an out_cap too small for some tiles: the flags say which
    cm, ok = F.plan._spgemm_2d(a, a, F.semiring.ARITHMETIC, mesh=F.mesh,
                               prod_cap=PROD_CAP, out_cap=64,
                               variant="rotation", merge="deferred")
    out["overflow"] = {"ok": F.out(ok)}
    # the planner: its pick on a uniform and a skewed graph (the hybrid
    # per-stage tuple), its overflow retry, and demote_stage
    rs, cs, vs = _graph(seed=1, skew=True)
    sk = F.dist.DistSpMat.from_global_coo((N, N), rs, cs, vs, GRID,
                                          mesh=F.mesh)
    budget = int(1.5 * (sk.cap + sk.cap))     # rotation, one gather stage
    plans = {"uniform": F.plan.plan_spgemm(a, a),
             "masked": F.plan.plan_spgemm(a, a, mask=masks["structural"]),
             "skewed": F.plan.plan_spgemm(sk, sk, mem_budget=budget)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        plans["demoted"] = F.plan.demote_stage(plans["uniform"], 1, 2)
        plans["demoted_hybrid"] = F.plan.demote_stage(plans["skewed"], 1, 2)
    out["plans"] = {"g:" + k: tuple(sorted(dataclasses.asdict(p).items()))
                    for k, p in plans.items()}
    for name, mat, kw in (("retry", a, dict(safety=0.05)),
                          ("hybrid", sk, dict(plan=plans["skewed"])),
                          ("masked", a, dict(mask=masks["structural"],
                                             safety=0.05))):
        cm, p = F.plan.spgemm(mat, mat, F.semiring.ARITHMETIC, mesh=F.mesh,
                              **kw)
        out[f"planned/{name}"] = dict(
            F.fields(cm),
            **{"g:plan": tuple(sorted(dataclasses.asdict(p).items()))})
    return out


@pytest.fixture(scope="module")
def results():
    jax = JaxReference(__name__, "spgemm_cases", [GRID])
    port = run_ranks(port_cases, 4, GRID, __name__, "spgemm_cases")
    return port, jax.result()[GRID]


@pytest.mark.parametrize("sched,merge,m", list(_case_keys()))
def test_spgemm_2d_every_schedule_and_merge(results, sched, merge, m):
    port, jax = results
    key = _key(sched, merge, m)
    want = jax[key]
    assert want["ok"].all(), "the caps must hold the product"
    compare([r[key] for r in port], want, GRID, exact=True, what=key)


@pytest.mark.parametrize("sched,merge,m", list(_case_keys()))
def test_overlap_on_and_off_are_bitwise_equal(results, sched, merge, m):
    port, _ = results
    key = _key(sched, merge, m)
    for r in port:
        fields, ok = r[key]["port:bulk"]
        np.testing.assert_array_equal(ok, r[key]["ok"])
        for f, arr in fields.items():
            np.testing.assert_array_equal(arr, r[key][f], err_msg=f)
            if arr.dtype.kind == "f":
                np.testing.assert_array_equal(np.signbit(arr),
                                              np.signbit(r[key][f]))


@pytest.mark.parametrize("sched", ["rotate", "bcast"])
def test_sign_of_zero_as_jax(results, sched):
    port, jax = results
    key = f"signed_zero/{sched}"
    compare([r[key] for r in port], jax[key], GRID, exact=True, what=key)
    assert jax[key]["sign"].any() == (sched == "rotate")


def test_overflow_flags(results):
    port, jax = results
    assert not jax["overflow"]["ok"].all()
    compare([r["overflow"] for r in port], jax["overflow"], GRID, what="ok")


@pytest.mark.parametrize("name", ["uniform", "masked", "skewed", "demoted",
                                  "demoted_hybrid"])
def test_plans(results, name):
    port, jax = results
    want = jax["plans"]["g:" + name]
    for r in port:
        assert r["plans"]["g:" + name] == want
    if name == "skewed":
        assert dict(want)["variant"] == "hybrid"
        assert dict(want)["schedule"] in (("gather", "bcast"),
                                          ("bcast", "gather"))


@pytest.mark.parametrize("name", ["retry", "hybrid", "masked"])
def test_planned_spgemm(results, name):
    port, jax = results
    key = f"planned/{name}"
    compare([r[key] for r in port], jax[key], GRID, exact=True, what=key)
    if name != "hybrid":
        assert dict(jax[key]["g:plan"])["attempts"] > 1
