"""The robustness layer on a 2x2 grid of four gloo CPU ranks.

Held against the JAX package's 2x2 mesh (4 forced XLA host devices, one
subprocess; its guards eager, its multiplies jitted —
``tests/torch_robust_parity.py``):

- tile choice: with the audit off, a fault at ``spgemm2d.comm_a`` (and at
  ``spmspv.comm_x``) lands on the same tile and entries as in JAX — every
  rank's C (y) shard is JAX's corrupted C (y);
- collective audits: ``spgemm2d.comm_b:drop`` corrupts one rank's tile,
  and every rank retries (the same ``attempts`` and ``degraded``), ending
  in the unfaulted C; an invariant broken on one tile raises on every rank;
- collective deadlines: a ``dist.exchange_deadline`` delay armed on rank 1
  only makes every rank back off and retry together; with ``count=99``
  every rank sheds the schedule and raises the same ``TopologyError``;
- a matrix saved on the 2x2 grid (rank 0 writes) restores onto the 1x1
  grid in this process, bitwise.

No rank decides alone: a rank raising by itself would leave the others
waiting in the next collective until ``run_ranks``' timeout.
"""
import contextlib
import importlib
import os
import warnings

import numpy as np
import pytest

from torch_dist_parity import (JaxReference, assert_same, compare,
                               port_cases, run_ranks, stack_shards)

GRID = (2, 2)
N = 40
KINDS = ("nan", "corrupt_val", "drop", "dup")
CKPT_ENV = "REPRO_TEST_ROBUST_GRID_DIR"


def _graph(seed=2):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((N, N)) < 0.3,
                     rng.random((N, N)).astype(np.float32) + 0.5, 0.0)
    r, c = np.nonzero(dense)
    return dense, r.astype(np.int64), c.astype(np.int64), \
        dense[r, c].astype(np.float32)


def _robust(F):
    return {m: importlib.import_module(f"{F.package}.robust.{m}")
            for m in ("audit", "deadline", "faults", "recover")}


def _rank(F):
    return None if F.i is None else F.i * F.grid[1] + F.j


def robust_cases(F):
    """One case body over both packages (``Frame``)."""
    R = _robust(F)
    faults, audit, deadline = R["faults"], R["audit"], R["deadline"]
    ctx = contextlib.nullcontext
    if F.package == "repro":
        from torch_robust_parity import jax_robust_reference as ctx
    sr = F.semiring.ARITHMETIC
    _, r, c, v = _graph()
    a = F.dist.DistSpMat.from_global_coo((N, N), r, c, v, F.grid,
                                         mesh=F.mesh)
    idx = np.array([0, 3, 17, 22, 31], np.int64)
    xv = np.array([1.0, 2.0, 0.5, 3.0, 1.5], np.float32)
    x = F.dist.DistSpVec.from_global(idx, xv, N, F.grid, cap=16,
                                     mesh=F.mesh)
    out = {}

    def mult(**kw):
        c, p = F.plan.spgemm(a, a, sr, mesh=F.mesh, **kw)
        return F.fields(c), (p.attempts, p.degraded)

    warnings.simplefilter("ignore", RuntimeWarning)
    with ctx():
        out["clean"], _ = mult()
        for kind in KINDS:
            with faults.inject(f"spgemm2d.comm_a:{kind}:seed=1"):
                out[f"off:{kind}"], out[f"g:off:{kind}"] = mult()
        with faults.inject("spmspv.comm_x:corrupt_val"):
            y, p = F.plan.spmspv(a, x, sr, mesh=F.mesh)
            out["off:spmspv"] = F.fields(y)
        with audit.at_level("boundary"), \
                faults.inject("spgemm2d.comm_b:drop"):
            out["drop"], out["g:drop"] = mult()
        # a straggler on rank 1 only (the JAX mesh is one process: there
        # it is armed on the one process)
        lag = ["dist.exchange_deadline:delay:amount=0.3"] \
            if _rank(F) in (None, 1) else []
        with deadline.configure(startup_deadline=0.1, backoff_base=0.01), \
                faults.inject(*lag):
            out["lag"], out["g:lag"] = mult()
        lag = ["dist.exchange_deadline:delay:amount=0.15,count=99"] \
            if _rank(F) in (None, 1) else []
        try:
            with deadline.configure(startup_deadline=0.05,
                                    backoff_base=0.005), faults.inject(*lag):
                mult()
            out["g:topo"] = None
        except deadline.TopologyError as err:
            out["g:topo"] = (err.site, str(err))
        finally:
            R["recover"].reset_degradation()
    # an invariant broken on one tile (the drawn one) raises everywhere
    with audit.at_level("full"), \
            faults.inject("dist.assemble:corrupt_idx:seed=3"):
        try:
            F.dist.DistSpMat.from_global_coo((N, N), r, c, v, F.grid,
                                             mesh=F.mesh)
            out["g:assemble"] = None
        except audit.AuditError as err:
            out["g:assemble"] = err.site
            out["port:assemble_msg"] = str(err)
    if F.package == "repro_torch":
        c, _ = F.plan.spgemm(a, a, sr, mesh=F.mesh)
        F.dist.save_spmat(os.environ[CKPT_ENV], 0, c)
        out["port:coo"] = c.to_global_coo()
        out.update(_world_gathers(F, R, a, mult))
    return out


def _world_gathers(F, R, a, mult):
    """The port's grid-wide gathers that one guarded exchange, and one
    multiply, book under each setting of the audit and the deadline."""
    from repro_torch.core import comm
    audit, deadline = R["audit"], R["deadline"]

    def world(call):
        before = comm.stats["axes"].get("world", {}).get("calls", 0)
        call()
        return comm.stats["axes"].get("world", {}).get("calls", 0) - before

    def guard():
        audit.guard_exchange("spgemm2d.comm_a", a)
    out = {"port:world:off": world(guard)}
    with audit.at_level("boundary"):
        out["port:world:boundary"] = world(guard)
    with deadline.configure(startup_deadline=5.0):
        out["port:world:configured"] = world(guard)
    out["port:world:mult"] = world(mult)
    with deadline.configure(off=True):
        out["port:world:mult_no_guard"] = world(mult)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    os.environ[CKPT_ENV] = str(tmp_path_factory.mktemp("robust_grid"))
    jax = JaxReference(__name__, "robust_cases", [GRID])
    port = run_ranks(port_cases, 4, GRID, __name__, "robust_cases")
    return port, jax.result()[GRID]


@pytest.mark.parametrize("kind", KINDS)
def test_fault_lands_on_jax_tile(results, kind):
    """Audit off: the corrupted C of every rank is JAX's corrupted C."""
    port, jax = results
    compare(port, {f"off:{kind}": jax[f"off:{kind}"],
                   f"g:off:{kind}": jax[f"g:off:{kind}"]}, GRID)
    got = stack_shards([p[f"off:{kind}"]["val"] for p in port], GRID)
    clean = stack_shards([p["clean"]["val"] for p in port], GRID)
    assert got.shape != clean.shape or not np.array_equal(
        np.nan_to_num(got, nan=-1.0), clean), kind


def test_vector_fault_lands_on_jax_piece(results):
    port, jax = results
    compare(port, {"off:spmspv": jax["off:spmspv"]}, GRID)


def test_collective_audit_retries_every_rank(results):
    port, jax = results
    assert jax["g:drop"] == (2, ())
    compare(port, {"drop": jax["clean"], "g:drop": jax["g:drop"]}, GRID)
    for p in port:
        for f in ("row", "col", "nnz"):
            assert_same(p["drop"][f], p["clean"][f])


def test_straggler_on_one_rank_retries_every_rank(results):
    port, jax = results
    assert jax["g:lag"] == (2, ())
    compare(port, {"lag": jax["clean"], "g:lag": jax["g:lag"]}, GRID)


def test_persistent_straggler_is_a_topology_error_on_every_rank(results):
    port, jax = results
    site, msg = jax["g:topo"]
    assert site == "spgemm2d.comm_a" and "serial-schedule" in msg
    for p in port:
        assert p["g:topo"] == (site, msg)


def test_broken_invariant_raises_on_every_rank(results):
    port, jax = results
    assert jax["g:assemble"] == "dist.assemble"
    for p in port:
        assert p["g:assemble"] == "dist.assemble"
        assert "row index out of bounds" in p["port:assemble_msg"]


@pytest.mark.parametrize("setting,calls", [
    ("off", 0), ("boundary", 1), ("configured", 1)])
def test_guard_gathers_at_most_once(results, setting, calls):
    """A guarded exchange on 2x2 books one grid-wide gather at most: the
    checksum verdict and the deadline's times travel together, and below
    the boundary audit the default deadline guard gathers nothing."""
    port, _ = results
    assert [p[f"port:world:{setting}"] for p in port] == [calls] * 4


def test_default_guard_adds_no_collective_to_a_multiply(results):
    port, _ = results
    for p in port:
        assert p["port:world:mult"] == p["port:world:mult_no_guard"] > 0


def test_saved_on_2x2_restores_on_1x1(results):
    """Rank 0 wrote the 2x2 C; a new 1x1 world (this process) restores it
    bitwise: the same global entries, re-tiled."""
    from repro_torch.core.dist import restore_spmat
    port, _ = results
    got, step = restore_spmat(os.environ[CKPT_ENV], (1, 1), device="cpu")
    assert step == 0 and got.grid == (1, 1) and got.order == "row"
    rows, cols, vals = port[0]["port:coo"]
    for p in port[1:]:
        for x, y in zip(p["port:coo"], port[0]["port:coo"]):
            np.testing.assert_array_equal(x, y)
    want = np.zeros((N, N), np.float32)
    want[rows, cols] = vals
    np.testing.assert_array_equal(got.to_dense(), want)
    assert int(got.nnz.sum()) == len(rows)
