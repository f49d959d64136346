"""The port's fault registry, corruption hooks and auditor against the JAX
package's, on the same numpy inputs.

Bitwise throughout: ``_corrupt_tiles`` for every kind (float, int32 and
int8 payloads, matrix and vector families, several tiles), the byte and
file corruptions, the backoff draws, ``checksum_obj`` and
``payload_nbytes`` on 1x1 ``DistSpMat``/``DistSpVec``/``DistSpMat3D``, and
the invariant checks (each violation raises at the same site, with the
same message). The last test is the twin of the JAX package's
``test_every_known_site_is_exercised``: the port's robust tests must name
every one of the 17 sites.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.dist import DistSpMat as JDist, DistSpMat3D as JDist3
from repro.core.dist import DistSpVec as JVec
from repro.robust import audit as jaudit, deadline as jdeadline
from repro.robust import faults as jfaults
from repro_torch.core.dist import DistSpMat as TDist, DistSpMat3D as TDist3
from repro_torch.core.dist import DistSpVec as TVec
from repro_torch.launch.elastic import StepWatchdog
from repro_torch.robust import audit, deadline, faults

KINDS = ("nan", "corrupt_val", "corrupt_idx", "drop", "dup")


def _graph(n=24, density=0.3, seed=1):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, n)) < density,
                     rng.random((n, n)).astype(np.float32) + 0.5, 0.0)
    r, c = np.nonzero(dense)
    return r.astype(np.int64), c.astype(np.int64), \
        dense[r, c].astype(np.float32)


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

def test_known_sites_equal():
    assert faults.KNOWN_SITES == jfaults.KNOWN_SITES
    assert len(faults.KNOWN_SITES) == 17


def test_spec_grammar_and_activation_window():
    spec = "spgemm2d.comm_a:nan:at=2,count=3,seed=7,amount=0.5;loop.crash:crash"
    assert faults._parse_spec(spec) == [
        faults.Fault(**dataclasses.asdict(f))
        for f in jfaults._parse_spec(spec)]
    with pytest.raises(ValueError, match="bad fault spec"):
        faults._parse_spec("justasite")
    with faults.inject("loop.crash:crash:at=2,count=2"):
        fired = [faults.fire("loop.crash") is not None for _ in range(4)]
    assert fired == [False, True, True, False]
    assert not any(f.site == "loop.crash" for f in faults.active())


def _family(kind_dtype, shape, seed, vdims=()):
    """A capacity-padded tile family: (row, col, val, nnz) numpy arrays."""
    rng = np.random.default_rng(seed)
    ntile, cap = int(np.prod(shape)), 32
    nnz = rng.integers(1, cap, ntile).astype(np.int32)
    if kind_dtype != "int8":
        # one full tile: dup corrupts values instead (on int8 values both
        # packages raise there — ROADMAP.md §3, reference defect 6)
        nnz[0] = cap
    if ntile > 1:
        nnz[1] = 0                   # one empty tile is never drawn
    live = np.arange(cap)[None, :] < nnz[:, None]
    row = np.where(live, rng.integers(0, 50, (ntile, cap)),
                   faults.SENTINEL).astype(np.int32)
    col = np.where(live, rng.integers(0, 50, (ntile, cap)),
                   faults.SENTINEL).astype(np.int32)
    if kind_dtype == "int8":
        val = rng.integers(-127, 128, (ntile, cap) + vdims).astype(np.int8)
    elif kind_dtype == "int32":
        val = rng.integers(0, 100, (ntile, cap) + vdims).astype(np.int32)
    else:
        val = rng.random((ntile, cap) + vdims).astype(np.float32)
    return (row.reshape(shape + (cap,)), col.reshape(shape + (cap,)),
            val.reshape(shape + (cap,) + vdims), nnz.reshape(shape))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype,shape,vdims,has_col", [
    ("float32", (2, 2), (), True), ("int8", (2, 2), (), True),
    ("int32", (1, 1), (), True), ("float32", (2, 2, 2), (), True),
    ("float32", (2, 2), (3,), True), ("float32", (2, 2), (), False)])
def test_corrupt_tiles_bitwise(kind, dtype, shape, vdims, has_col):
    for seed in (0, 3):
        row, col, val, nnz = _family(dtype, shape, 11 + seed, vdims)
        spec = f"spgemm2d.comm_a:{kind}:seed={seed}"
        outs = []
        for mod in (jfaults, faults):
            f = mod._parse_spec(spec)[0]
            args = [x.copy() for x in (row, col if has_col else None,
                                       val, nnz) if x is not None]
            if not has_col:
                args.insert(1, None)
            outs.append(mod._corrupt_tiles(f, *args, has_col=has_col))
        for got, want in zip(outs[1], outs[0]):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
        changed = any(not np.array_equal(o, i) for o, i in zip(
            outs[1], (row, col, val, nnz)) if o is not None)
        assert changed, (kind, dtype, shape)


def test_corrupt_bytes_and_file_bitwise(tmp_path):
    data = bytes(range(256)) * 8
    for spec in ("io.mm_body:corrupt_bytes:seed=3",
                 "io.mm_body:truncate:amount=0.4"):
        outs = []
        for mod in (jfaults, faults):
            with mod.inject(spec):
                outs.append(mod.corrupt_bytes("io.mm_body", data))
        assert outs[0] == outs[1] != data
    for spec in ("checkpoint.leaf:flip:seed=2",
                 "checkpoint.leaf:truncate:amount=0.3"):
        got = []
        for k, mod in enumerate((jfaults, faults)):
            p = tmp_path / f"{k}.npy"
            np.save(p, np.arange(1000, dtype=np.float64))
            with mod.inject(spec):
                mod.corrupt_file("checkpoint.leaf", str(p))
            got.append(p.read_bytes())
        assert got[0] == got[1]


def test_backoff_draws_bitwise(monkeypatch):
    for seed in ("0", "41"):
        monkeypatch.setenv("REPRO_FAULT_SEED", seed)
        for site in ("spgemm2d.comm_a", "spmspv.comm_x"):
            for attempt in (1, 2, 3, 7):
                assert deadline.ExchangeGuard().backoff_delay(site, attempt) \
                    == jdeadline.ExchangeGuard().backoff_delay(site, attempt)


def test_flip_ok_and_hooks_copy_before_mutating():
    ok = torch.ones((1, 1), dtype=torch.bool)
    with faults.inject("plan.spgemm.ok:flip"):
        assert not faults.flip_ok("plan.spgemm.ok", ok).any()
        assert faults.flip_ok("plan.spgemm.ok", ok) is ok   # window closed
    r, c, v = _graph()
    a = TDist.from_global_coo((24, 24), r, c, v, (1, 1), device="cpu")
    fields = [x.clone() for x in (a.row, a.col, a.val, a.nnz)]
    with faults.inject("spgemm2d.comm_a:drop:amount=0.5"):
        bad = faults.corrupt_spmat("spgemm2d.comm_a", a)
    assert int(bad.nnz) < int(a.nnz)
    for x, y in zip(fields, (a.row, a.col, a.val, a.nnz)):
        assert torch.equal(x, y)                # the operand is pristine


def test_crash_and_delay_hooks():
    with faults.inject("loop.crash:crash:at=2"):
        faults.maybe_crash("loop.crash")
        with pytest.raises(faults.InjectedCrash, match="hit 2"):
            faults.maybe_crash("loop.crash")
    with faults.inject("loop.device_loss:crash"):
        with pytest.raises(deadline.TopologyError) as ei:
            deadline.maybe_device_loss()
    assert ei.value.site == "loop.device_loss"


# --------------------------------------------------------------------------
# the auditor: checksums and invariants on 1x1 containers
# --------------------------------------------------------------------------

def _pair_mat(cap=512, vdims=()):
    r, c, v = _graph()
    if vdims:
        v = np.stack([v, 2 * v], -1)
    j = JDist.from_global_coo((24, 24), r, c, v, (1, 1), cap=cap,
                              vdims=vdims)
    t = TDist.from_global_coo((24, 24), r, c, v, (1, 1), cap=cap,
                              vdims=vdims, device="cpu")
    return j, t


def _pair_vec():
    idx = np.array([0, 3, 17, 22], np.int64)
    val = np.array([1.0, 2.0, 0.5, 3.0], np.float32)
    return (JVec.from_global(idx, val, 24, (1, 1), cap=16),
            TVec.from_global(idx, val, 24, (1, 1), cap=16, device="cpu"))


def _pair_mat3(dist="acol"):
    r, c, v = _graph(32, 0.2, 3)
    return (JDist3.from_global_coo((32, 32), r, c, v, (1, 1, 1), dist,
                                   cap=512),
            TDist3.from_global_coo((32, 32), r, c, v, (1, 1, 1), dist,
                                   cap=512, device="cpu"))


@pytest.mark.parametrize("which", ["mat", "mat_vdims", "vec", "mat3_acol",
                                   "mat3_brow"])
def test_checksum_and_payload_bytes_bitwise(which):
    j, t = {"mat": _pair_mat, "mat_vdims": lambda: _pair_mat(vdims=(2,)),
            "vec": _pair_vec, "mat3_acol": _pair_mat3,
            "mat3_brow": lambda: _pair_mat3("brow")}[which]()
    assert audit.checksum_obj(t) == jaudit.checksum_obj(j)
    assert audit.payload_nbytes(t) == jaudit.payload_nbytes(j)
    # the same fault on both lands on the same entries
    for kind in KINDS:
        with jfaults.inject(f"spgemm2d.comm_a:{kind}:seed=5"), \
                faults.inject(f"spgemm2d.comm_a:{kind}:seed=5"):
            jb = jfaults.corrupt_obj("spgemm2d.comm_a", j)
            tb = faults.corrupt_obj("spgemm2d.comm_a", t)
        assert audit.checksum_obj(tb) == jaudit.checksum_obj(jb) \
            != jaudit.checksum_obj(j), kind


def _breakages(m):
    """Hand-broken copies of a 1x1 matrix, in both packages' terms."""
    cap = m.row.shape[-1]
    n = int(np.asarray(m.nnz).reshape(-1)[0])
    col = np.array(m.col)
    col.reshape(-1)[0] = 24 + 5                   # out of tile bounds
    row = np.array(m.row)
    row.reshape(-1)[n + 1] = 3                    # non-canonical padding
    val = np.array(m.val)
    val.reshape(-1)[1] = np.nan                   # non-finite (full only)
    swap = np.array(m.col), np.array(m.row)
    for a in swap:                                # keys decrease (full)
        a.reshape(-1)[[0, 1]] = a.reshape(-1)[[1, 0]]
    return {
        "nnz": dict(nnz=np.asarray(m.nnz) + cap + 1),
        "bounds": dict(col=col),
        "padding": dict(row=row),
        "nan": dict(val=val),
        "order": dict(col=swap[0], row=swap[1]),
    }


@pytest.mark.parametrize("level", ["boundary", "full"])
def test_invariant_violations_raise_alike(level):
    j, t = _pair_mat()
    for name, fields in _breakages(j).items():
        jb = dataclasses.replace(j, **{k: jnp.asarray(v)
                                       for k, v in fields.items()})
        tb = dataclasses.replace(t, **{k: torch.from_numpy(np.array(v))
                                       for k, v in fields.items()})
        msgs = []
        for mod, obj in ((jaudit, jb), (audit, tb)):
            with mod.at_level(level):
                try:
                    mod.audit_obj(obj, "dist.assemble")
                    msgs.append(None)
                except mod.AuditError as err:
                    assert err.site == "dist.assemble"
                    msgs.append(str(err))
        assert msgs[0] == msgs[1], name
        if level == "full" or name not in ("nan", "order"):
            assert msgs[1] is not None, name
    jv, tv = _pair_vec()
    idx = np.array(jv.idx)
    idx.reshape(-1)[1] = idx.reshape(-1)[0]        # duplicate index
    with jaudit.at_level("full"), audit.at_level("full"):
        with pytest.raises(jaudit.AuditError) as je:
            jaudit.audit_obj(dataclasses.replace(jv, idx=jnp.asarray(idx)),
                             "spmspv.out")
        with pytest.raises(audit.AuditError) as te:
            audit.audit_obj(dataclasses.replace(
                tv, idx=torch.from_numpy(idx)), "spmspv.out")
    assert str(je.value) == str(te.value) and te.value.site == "spmspv.out"


def test_guard_exchange_brackets_and_passes_through():
    _, t = _pair_mat()
    with faults.inject("spgemm2d.comm_a:corrupt_val:count=2"):
        with audit.at_level("boundary"), \
                pytest.raises(audit.AuditError, match="checksum mismatch"):
            audit.guard_exchange("spgemm2d.comm_a", t)
        # audit off: the fault passes through (the documented trade)
        out = audit.guard_exchange("spgemm2d.comm_a", t)
    assert not torch.equal(out.val, t.val)
    assert audit.guard_exchange("spgemm2d.comm_a", t) is t


def test_deadline_guard_trips_and_learns():
    g = deadline.ExchangeGuard(startup_deadline=0.05, min_samples=2,
                               floor=0.0)
    with faults.inject("dist.exchange_deadline:delay:amount=0.1"):
        with pytest.raises(deadline.ExchangeTimeout) as ei:
            with g.watch("spmspv.comm_x"):
                pass
    assert isinstance(ei.value, audit.AuditError)
    assert ei.value.site == "spmspv.comm_x" and g.trips("spmspv.comm_x") == 1
    for _ in range(3):
        with g.watch("spmspv.comm_x"):
            pass
    st = g.stats("spmspv.comm_x")
    assert st["n"] == 3 and st["trips"] == 1 and st["budget_s"] < 0.05
    g.reset()
    assert g.stats("spmspv.comm_x")["n"] == 0 and g.trips("spmspv.comm_x")
    with deadline.configure(off=True):
        assert not deadline.enabled() and deadline.sites() == []
        assert deadline.stats("x")["budget_s"] is None


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(grace=2.0, window=4, min_samples=3)
    for dt in (1.0, 1.0, 1.0):
        wd.times.append(dt)
    assert wd.budget() == 2.0
    assert wd.is_straggling(2.5) and not wd.is_straggling(1.5)
    wd.reset()
    assert wd.budget() is None and not wd.is_straggling(100.0)


# --------------------------------------------------------------------------
# coverage: the port's robust tests name every known site
# --------------------------------------------------------------------------

ROBUST_TESTS = ("test_torch_faults.py", "test_torch_robust_plan.py",
                "test_torch_checkpoint.py", "test_torch_robust_grid.py")


def test_every_known_site_is_exercised():
    here = Path(__file__).resolve().parent
    src = "".join((here / f).read_text() for f in ROBUST_TESTS)
    missed = [s for s in faults.KNOWN_SITES
              if f'"{s}' not in src and f"'{s}" not in src]
    assert not missed, f"fault sites with no chaos coverage: {missed}"
