"""Checkpoints, the checkpointed loop, crash/resume of the apps and the
matrix files, held against the JAX package.

- ``train/checkpoint.py``: a checkpoint written by either package is
  byte-for-byte the other's (leaf files and manifest) and restores in the
  other; the CRC fallback and the truncation check behave alike.
- ``CheckpointedLoop``: crash/resume, a completed run, stragglers through
  the watchdog, topology faults with and without a hook.
- PageRank, FastSV and HipMCL crashed by ``loop.crash`` and resumed from
  their checkpoints finish bitwise equal to the bare run; PageRank also
  resumes a checkpoint the JAX app wrote (within ``SUM_RTOL``).
- ``save_spmat``/``restore_spmat`` across the packages; ``io/mmio.py`` and
  ``io/binio.py``: the same bytes, the same parse, the same named errors
  under the ``io.mm_body``/``io.bin_body`` faults.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.apps.pagerank import pagerank as j_pagerank
from repro.core import make_grid as j_make_grid
from repro.core.dist import DistSpMat as JDist
from repro.core.dist import restore_spmat as j_restore_spmat
from repro.core.dist import save_spmat as j_save_spmat
from repro.io import binio as jbinio, mmio as jmmio
from repro.robust import faults as jfaults
from repro.train import checkpoint as jckpt
from repro_torch.apps.fastsv import fastsv
from repro_torch.apps.hipmcl import hipmcl
from repro_torch.apps.pagerank import pagerank
from repro_torch.core.dist import DistSpMat as TDist, make_grid
from repro_torch.core.dist import restore_spmat, save_spmat
from repro_torch.io import binio, mmio
from repro_torch.launch.elastic import StepWatchdog
from repro_torch.robust import deadline, faults
from repro_torch.robust.faults import InjectedCrash
from repro_torch.robust.recover import CheckpointedLoop
from repro_torch.train import checkpoint as ckpt
from torch_parity import SUM_RTOL, jax_apps_jitted


@pytest.fixture(scope="module")
def tmesh():
    return make_grid(1, 1, device="cpu")


def _tree(torch_leaves=False):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64)
    tree = {"x": x, "y": np.arange(8, dtype=np.int32),
            "nest": {"b": [np.float32(2.5), np.arange(3)], "a": np.int64(7)},
            "flag": np.asarray(True), "skip": None}
    if torch_leaves:
        tree["x"] = torch.from_numpy(x)
    return tree


def _files(step_dir):
    return {p.name: p.read_bytes() for p in sorted(step_dir.iterdir())}


def test_checkpoint_bytes_and_cross_restore(tmp_path):
    """Either package's checkpoint is the other's, byte for byte, and
    restores there (flat and into a ``like`` tree)."""
    jd, td = tmp_path / "j", tmp_path / "t"
    jckpt.save_checkpoint(str(jd), 3, _tree())
    ckpt.save_checkpoint(str(td), 3, _tree(torch_leaves=True))
    assert _files(jd / "step_00000003") == _files(td / "step_00000003")
    for restore_flat, d in ((ckpt.restore_flat, jd),
                            (jckpt.restore_flat, td)):
        flat, step = restore_flat(str(d))
        assert step == 3
        assert sorted(flat) == ["flag", "nest/a", "nest/b/0", "nest/b/1",
                                "x", "y"]
        np.testing.assert_array_equal(flat["x"], _tree()["x"])
    like = _tree()
    got, step = ckpt.restore_checkpoint(str(jd), like)
    assert step == 3 and got["skip"] is None and list(got) == list(like)
    np.testing.assert_array_equal(got["nest"]["b"][1], np.arange(3))
    assert got["nest"]["a"] == 7 and got["nest"]["b"][0].dtype == np.float32
    assert ckpt.latest_step(str(td)) == 3 and ckpt.all_steps(str(td)) == [3]


def test_checkpoint_leaf_faults_fall_back_alike(tmp_path):
    steps = []
    for mod, fmod, d in ((jckpt, jfaults, tmp_path / "j"),
                         (ckpt, faults, tmp_path / "t")):
        good = {"x": np.arange(64, dtype=np.float64), "y": np.arange(8)}
        mod.save_checkpoint(str(d), 1, good)
        with fmod.inject("checkpoint.leaf:flip"):
            mod.save_checkpoint(str(d), 2, {"x": good["x"] * 2,
                                            "y": good["y"] + 1})
        with pytest.warns(RuntimeWarning, match="falling back"):
            state, step = mod.restore_flat(str(d))
        np.testing.assert_array_equal(state["x"], good["x"])
        with pytest.raises(mod.CheckpointError, match="CRC32 mismatch"):
            mod.restore_flat(str(d), step=2)
        with fmod.inject("checkpoint.leaf:truncate:amount=0.5"):
            mod.save_checkpoint(str(d), 4, {"x": np.arange(1024.0)})
        with pytest.raises(mod.CheckpointError, match="unreadable"):
            mod.restore_flat(str(d), step=4)
        steps.append((step, _files(d / "step_00000002")))
    assert steps[0] == steps[1]


# --------------------------------------------------------------------------
# the checkpointed loop
# --------------------------------------------------------------------------

def _body(it, state):
    x = state["x"]
    return {"x": x * np.float64(1.000001) + np.float64(it)}, bool(it >= 9)


def test_loop_crash_resume_and_completed_run(tmp_path):
    x0 = {"x": np.arange(16, dtype=np.float64)}
    baseline = CheckpointedLoop(None).run(dict(x0), _body, 20)
    d = str(tmp_path / "ck")
    with faults.inject("loop.crash:crash:at=4"):
        with pytest.raises(InjectedCrash):
            CheckpointedLoop(d, keep=2).run(dict(x0), _body, 20)
    assert ckpt.all_steps(d) == [1, 2]                # keep=2 retained
    resumed = CheckpointedLoop(d).run(dict(x0), _body, 20)
    np.testing.assert_array_equal(resumed["x"], baseline["x"])

    def explode(it, state):
        raise AssertionError("body must not re-run after completion")
    again = CheckpointedLoop(d).run(dict(x0), explode, 20)
    np.testing.assert_array_equal(again["x"], baseline["x"])
    # every=3: a crash loses at most the iterations since the last save
    d3 = str(tmp_path / "ck3")
    with faults.inject("loop.crash:crash:at=6"):
        with pytest.raises(InjectedCrash):
            CheckpointedLoop(d3, every=3).run(dict(x0), _body, 20)
    assert ckpt.all_steps(d3) == [2]
    resumed = CheckpointedLoop(d3, every=3).run(dict(x0), _body, 20)
    np.testing.assert_array_equal(resumed["x"], baseline["x"])


def test_loop_straggler_watchdog_and_hook():
    wd = StepWatchdog(grace=3.0, window=8, min_samples=3)
    calls = []

    def slow_body(it, state):
        import time
        time.sleep(0.01)
        return state, bool(it >= 9)
    with faults.inject("loop.delay:delay:at=5,count=3,amount=0.2"), \
            pytest.warns(RuntimeWarning, match="straggling"):
        CheckpointedLoop(None, watchdog=wd, straggler_patience=2,
                         on_straggler=lambda it, dt: calls.append(it)).run(
            {"x": np.zeros(4)}, slow_body, 20)
    assert calls == [5]             # iterations 4 and 5 straggled


def test_loop_topology_faults(tmp_path):
    def body(it, state):
        return {"x": np.asarray(state["x"]) + 1}, False
    with faults.inject("loop.device_loss:crash:at=2"):
        with pytest.raises(deadline.TopologyError):
            CheckpointedLoop(str(tmp_path / "t")).run({"x": np.int64(0)},
                                                      body, 6)
    # the last completed iteration (0) was checkpointed before raising
    assert ckpt.all_steps(str(tmp_path / "t")) == [0]
    hooked = []
    loop = CheckpointedLoop(
        on_topology=lambda s, e: (hooked.append(e.site), s)[1])
    with faults.inject("loop.device_loss:crash:at=2"), \
            pytest.warns(RuntimeWarning, match="topology fault"):
        state = loop.run({"x": np.int64(0)}, body, 6)
    assert int(state["x"]) == 6 and hooked == ["loop.device_loss"]


# --------------------------------------------------------------------------
# the apps: crash, resume, bitwise
# --------------------------------------------------------------------------

def _graph(n, density, seed, symmetric):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(dense, 0)
    if symmetric:
        dense = np.maximum(dense, dense.T)
    r, c = np.nonzero(dense)
    return r.astype(np.int64), c.astype(np.int64), dense[r, c]


def _crash_resume(fn, tmp_path, at):
    bare = fn(None)
    d = str(tmp_path / "ck")
    with faults.inject(f"loop.crash:crash:at={at}"):
        with pytest.raises(InjectedCrash):
            fn(d)
    assert ckpt.all_steps(d)
    return bare, fn(d)


def test_pagerank_crash_resume_bitwise(tmesh, tmp_path):
    r, c, v = _graph(40, 0.15, 9, False)
    a = TDist.from_global_coo((40, 40), c, r, v, (1, 1), mesh=tmesh)
    bare, resumed = _crash_resume(lambda d: pagerank(
        a, mesh=tmesh, max_iters=12, tol=0.0, checkpoint_dir=d), tmp_path, 5)
    np.testing.assert_array_equal(bare, resumed)


def test_pagerank_resumes_a_jax_checkpoint(tmesh, tmp_path):
    """The JAX app crashes at iteration 4; the port resumes its
    checkpoint and converges with its own bare run (float sums in other
    orders: ``SUM_RTOL``)."""
    r, c, v = _graph(40, 0.15, 9, False)
    ja = JDist.from_global_coo((40, 40), c, r, v, (1, 1),
                               mesh=j_make_grid(1, 1))
    a = TDist.from_global_coo((40, 40), c, r, v, (1, 1), mesh=tmesh)
    d = str(tmp_path / "jax")
    with jax_apps_jitted(), jfaults.inject("loop.crash:crash:at=5"):
        with pytest.raises(jfaults.InjectedCrash):
            j_pagerank(ja, mesh=j_make_grid(1, 1), max_iters=12, tol=0.0,
                       checkpoint_dir=d)
    assert ckpt.latest_step(d) == 3
    got = pagerank(a, mesh=tmesh, max_iters=12, tol=0.0, checkpoint_dir=d)
    want = pagerank(a, mesh=tmesh, max_iters=12, tol=0.0)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0)


def test_fastsv_crash_resume_bitwise(tmesh, tmp_path):
    # a path graph: FastSV needs several hooking iterations on it
    n = 48
    r = np.arange(n - 1, dtype=np.int64)
    rows, cols = np.concatenate([r, r + 1]), np.concatenate([r + 1, r])
    a = TDist.from_global_coo((n, n), rows, cols,
                              np.ones(len(rows), np.float32), (1, 1),
                              mesh=tmesh)
    bare, resumed = _crash_resume(lambda d: fastsv(
        a, mesh=tmesh, checkpoint_dir=d), tmp_path, 2)
    np.testing.assert_array_equal(bare, resumed)
    np.testing.assert_array_equal(bare, np.zeros(n, np.int64))


def test_hipmcl_crash_resume_bitwise(tmesh, tmp_path):
    rng = np.random.default_rng(4)
    blocks = [(0, 12), (12, 30), (30, 40)]
    dense = np.zeros((40, 40), np.float32)
    for lo, hi in blocks:
        dense[lo:hi, lo:hi] = rng.random((hi - lo, hi - lo)) < 0.6
    dense = np.maximum(dense, dense.T)
    np.fill_diagonal(dense, 1.0)
    r, c = np.nonzero(dense)
    a = TDist.from_global_coo((40, 40), r, c, dense[r, c], (1, 1),
                              mesh=tmesh)
    bare, resumed = _crash_resume(lambda d: hipmcl(
        a, mesh=tmesh, checkpoint_dir=d), tmp_path, 3)
    np.testing.assert_array_equal(bare, resumed)
    assert len(np.unique(bare)) == 3


# --------------------------------------------------------------------------
# sparse checkpoints and the matrix files
# --------------------------------------------------------------------------

def test_save_restore_spmat_across_packages(tmesh, tmp_path):
    r, c, v = _graph(30, 0.2, 3, False)
    ja = JDist.from_global_coo((30, 30), r, c, v, (1, 1), order="col")
    ta = TDist.from_global_coo((30, 30), r, c, v, (1, 1), mesh=tmesh,
                               order="col")
    j_save_spmat(str(tmp_path / "j"), 0, ja)
    save_spmat(str(tmp_path / "t"), 0, ta)
    assert _files(tmp_path / "j" / "step_00000000") == \
        _files(tmp_path / "t" / "step_00000000")
    got, step = restore_spmat(str(tmp_path / "j"), (1, 1), mesh=tmesh)
    want, _ = j_restore_spmat(str(tmp_path / "t"), (1, 1))
    assert step == 0 and got.order == want.order == "col"
    for f in ("row", "col", "val", "nnz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def _entries(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, 200).astype(np.int64),
            rng.integers(0, 40, 200).astype(np.int64), rng.random(200))


def test_mm_files_alike_and_faults_named(tmp_path):
    r, c, v = _entries()
    paths = [str(tmp_path / f"{k}.mtx") for k in "jt"]
    jmmio.write_mm_parallel(paths[0], (50, 40), r, c, v)
    mmio.write_mm_parallel(paths[1], (50, 40), r, c, v)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    shape, rr, cc, vv = mmio.read_mm_parallel(paths[0], nreaders=3)
    want = jmmio.read_mm_parallel(paths[0], nreaders=3)
    assert shape == want[0] == (50, 40)
    for got, w in zip((rr, cc, vv), want[1:]):
        np.testing.assert_array_equal(got, w)
    for spec in ("io.mm_body:truncate:amount=0.5",
                 "io.mm_body:corrupt_bytes:amount=1.0,seed=4"):
        errs = []
        for mod, fmod in ((jmmio, jfaults), (mmio, faults)):
            with fmod.inject(spec), pytest.raises(ValueError) as ei:
                mod.read_mm_parallel(paths[0], nreaders=1)
            errs.append(str(ei.value))
        assert errs[0] == errs[1] and "j.mtx" in errs[1]
    (tmp_path / "bad.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n10 10\n1 1 1.0\n")
    with pytest.raises(ValueError, match="size line"):
        mmio.read_mm_header(str(tmp_path / "bad.mtx"))


def test_bin_files_alike_and_faults_named(tmp_path):
    r, c, v = _entries(2)
    paths = [str(tmp_path / f"{k}.cbin") for k in "jt"]
    jbinio.write_binary(paths[0], (50, 50), r, c, v)
    binio.write_binary(paths[1], (50, 50), r, c, v)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    shape, rr, cc, vv = binio.read_binary(paths[0])
    assert shape == (50, 50)
    for got, w in zip((rr, cc, vv), (r, c, v)):
        np.testing.assert_array_equal(got, w)
    errs = []
    for mod, fmod, p in ((jbinio, jfaults, paths[0]),
                         (binio, faults, paths[1])):
        with fmod.inject("io.bin_body:truncate:amount=0.25"):
            mod.write_binary(p, (50, 50), r, c, v)
        with pytest.raises(ValueError, match="truncated body") as ei:
            mod.read_binary(p)
        errs.append(str(ei.value).replace(p, "<path>"))
    assert errs[0] == errs[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (tmp_path / "junk.cbin").write_bytes(b"\x00" * 48)
    with pytest.raises(ValueError, match="bad magic"):
        binio.read_binary(str(tmp_path / "junk.cbin"))
