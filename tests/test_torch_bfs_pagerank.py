"""BFS and PageRank through the port's whole slice, against the JAX package.

The graphs are those of ``tests/test_apps.py`` in size (48 vertices for
BFS, 32 for PageRank), made from a seed with numpy and assembled by
``repro`` on a 1x1 grid; the port starts from the same tiles
(``DistSpMat.from_numpy``). The JAX apps run once per graph from
module-scoped fixtures (jitted, ``torch_parity.jax_apps_jitted``); BFS
levels and the planner's decisions per level must match bitwise, PageRank
within 1e-6 (max |Δ|). The tests marked ``gpu`` run both apps at R-MAT
scale 12 on the card against the port's CPU run, and count the segreduce
kernel's launches by route against what the CPU run sends to it.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from repro.apps import bfs_levels as j_bfs, pagerank as j_pagerank
from repro.core.dist import DistSpMat as JDist, make_grid as j_make_grid
from repro.obs import recorder as j_recorder
from repro_torch.apps import bfs_levels as t_bfs, pagerank as t_pagerank
from repro_torch.core.dist import DistSpMat as TDist, make_grid as t_make_grid
from repro_torch.io.rmat import rmat_coo
from repro_torch.kernels import segreduce
from repro_torch.obs import recorder
from repro_torch.robust.recover import CheckpointedLoop

from torch_parity import CPU, jax_apps_jitted, np_of

PR_TOL = 1e-6            # PageRank, max |Δ| against JAX's on the CPU
GPU_PR_TOL = 1e-5        # the card's PageRank against the port's CPU run


def _graph(n, density, seed, symmetric, split=None):
    """A random 0/1 graph without self loops; ``split`` cuts every edge
    between vertices below and above it (an unreachable part)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(dense, 0)
    if symmetric:
        dense = np.maximum(dense, dense.T)
    if split is not None:
        dense[:split, split:] = 0
        dense[split:, :split] = 0
    return dense


def _pair(dense, rows_are_dst=False):
    """Both packages' tiles of ``dense`` (entry (i, j) = edge i -> j); for
    PageRank the matrix holds A[dst, src]."""
    r, c = np.nonzero(dense)
    if rows_are_dst:
        r, c = c, r
    j = JDist.from_global_coo(dense.shape, r, c, np.ones(len(r), np.float32),
                              (1, 1), cap=4096)
    t = TDist.from_numpy(np_of(j.row), np_of(j.col), np_of(j.val),
                         np_of(j.nnz), j.shape, j.grid, j.order, CPU)
    return j, t


def _scipy_levels(dense, source):
    ref = csgraph.shortest_path(sp.csr_matrix(dense), unweighted=True,
                                indices=source)
    return np.where(np.isinf(ref), -1, ref).astype(np.int32)


def _plans(events):
    keys = ("variant", "merge", "prod_cap", "out_cap", "attempts")
    return [tuple(e[k] for k in keys) for e in events]


BFS_GRAPHS = {
    # symmetric, two components: vertices 36.. are unreachable from 0
    "unreachable": lambda: _graph(48, 0.12, 1, True, split=36),
    # directed: BFS follows edges u -> v, entry (v, u) of the matrix
    "directed": lambda: _graph(48, 0.08, 1, False),
}


@pytest.fixture(scope="module")
def bfs_runs():
    """The JAX BFS once per graph: levels and its planner's events."""
    jmesh = j_make_grid(1, 1)
    out = {}
    with jax_apps_jitted():
        for name, make in BFS_GRAPHS.items():
            dense = make()
            ja, ta = _pair(dense, rows_are_dst=True)
            with j_recorder.capture() as rec:
                levels = j_bfs(ja, 0, mesh=jmesh)
                plans = _plans(rec.events("plan.spmspv"))
                nlevels = rec.snapshot()["spans"]["bfs.level"]["count"]
            out[name] = (dense, ta, levels, plans, nlevels)
    return out


@pytest.mark.parametrize("name", sorted(BFS_GRAPHS))
def test_bfs_levels(bfs_runs, name):
    dense, ta, want, want_plans, want_levels = bfs_runs[name]
    tmesh = t_make_grid(1, 1, device="cpu")
    with recorder.capture() as rec:
        got = t_bfs(ta, 0, mesh=tmesh)
        plans = _plans(rec.events("plan.spmspv"))
        spans = rec.snapshot()["spans"]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # entry (v, u) is the edge u -> v, so BFS walks dense's rows
    np.testing.assert_array_equal(got[:48], _scipy_levels(dense, 0))
    if name == "unreachable":
        assert (got[36:] == -1).all() and (got[:36] >= 0).any()
    assert plans == want_plans
    assert spans["bfs.level"]["count"] == want_levels == len(plans)
    assert spans["spmspv"]["count"] == len(plans)


def test_bfs_max_iters_and_explicit_caps(bfs_runs):
    dense, ta, want, _, _ = bfs_runs["unreachable"]
    tmesh = t_make_grid(1, 1, device="cpu")
    got = t_bfs(ta, 0, mesh=tmesh, max_iters=2)
    np.testing.assert_array_equal(got, np.where(want <= 2, want, -1))
    got = t_bfs(ta, 0, mesh=tmesh, prod_cap=4096, out_cap=64)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pagerank_run():
    """A directed 32-vertex graph with dangling vertices (no out-edges):
    the JAX PageRank once, with its iteration count."""
    dense = _graph(32, 0.12, 2, False)
    dense[[3, 11, 20]] = 0                   # dangling: no out-edges
    ja, ta = _pair(dense, rows_are_dst=True)
    with jax_apps_jitted(), j_recorder.capture() as rec:
        want = j_pagerank(ja, mesh=j_make_grid(1, 1), alpha=0.85)
        iters = rec.snapshot()["spans"]["pagerank.iter"]["count"]
    return dense, ta, want, iters


def test_pagerank(pagerank_run):
    dense, ta, want, want_iters = pagerank_run
    with recorder.capture() as rec:
        got = t_pagerank(ta, mesh=t_make_grid(1, 1, device="cpu"),
                         alpha=0.85)
        spans = rec.snapshot()["spans"]
    assert got.dtype == np.float32 and got.shape == (32,)
    assert float(np.abs(got - want).max()) <= PR_TOL
    assert spans["pagerank.iter"]["count"] == want_iters
    assert spans["spmv"]["count"] == want_iters
    # the formula, in float64: dangling mass spread evenly, L1-normalized
    n = 32
    out_deg = dense.sum(1)
    assert (out_deg == 0).sum() >= 3
    P = np.where(out_deg[None, :] > 0, dense.T / np.maximum(out_deg, 1), 0)
    r = np.full(n, 1 / n)
    for _ in range(500):
        r = 0.85 * (P @ r + r[out_deg == 0].sum() / n) + 0.15 / n
    np.testing.assert_allclose(got, r / r.sum(), rtol=1e-3, atol=1e-6)


def test_pagerank_refuses_what_is_not_ported(pagerank_run):
    """``elastic=True`` on 1x1: two device losses are survived in-process
    (the interrupted iteration re-runs, r bitwise the uninterrupted run's);
    a third, past ``max_topology_events``, is refused as in the JAX
    package: the TopologyError propagates."""
    import warnings
    from repro_torch.robust import faults
    from repro_torch.robust.deadline import TopologyError
    _, ta, _, _ = pagerank_run
    tmesh = t_make_grid(1, 1, device="cpu")
    want = t_pagerank(ta, mesh=tmesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with faults.inject("loop.device_loss:crash:at=3,count=2"):
            got = t_pagerank(ta, mesh=tmesh, elastic=True)
        np.testing.assert_array_equal(got, want)
        with faults.inject("loop.device_loss:crash:at=3,count=3"), \
                pytest.raises(TopologyError, match="injected device loss"):
            t_pagerank(ta, mesh=tmesh, elastic=True)


def test_checkpointed_loop_bare_run():
    """Iterations 0, 1, ... until ``done`` (that iteration's state kept) or
    ``max_iters``; one ``<name>.iter`` span each."""
    seen = []

    def body(it, state):
        seen.append(it)
        return {"x": state["x"] + 1}, state["x"] + 1 >= 4

    with recorder.capture() as rec:
        out = CheckpointedLoop(name="count").run({"x": 0}, body, 10)
        assert rec.snapshot()["spans"]["count.iter"]["count"] == 4
    assert out == {"x": 4} and seen == [0, 1, 2, 3]
    seen.clear()
    assert CheckpointedLoop().run({"x": 0}, body, 2) == {"x": 2}
    assert seen == [0, 1]
    assert CheckpointedLoop().run({"x": 0}, body, 0) == {"x": 0}
    # the hooks are only called on a topology fault or a straggler: with
    # none, the loop runs as bare
    seen.clear()
    loop = CheckpointedLoop(on_topology=print, on_straggler=print)
    assert loop.run({"x": 0}, body, 10) == {"x": 4}
    assert seen == [0, 1, 2, 3]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

GPU_SCALE = 12


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the segreduce kernel runs only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def rmat(cuda):
    """R-MAT scale 12 (Graph500 parameters), symmetrized, no self loops,
    randomly permuted, on the card and on the CPU."""
    shape, r, c, v = rmat_coo(GPU_SCALE, 16, seed=0, symmetrize=True,
                              drop_self_loops=True)
    tiles = {dev: TDist.from_global_coo(shape, r, c, v, (1, 1), device=dev,
                                        random_permute=True)
             for dev in ("cpu", "cuda")}
    deg = np.bincount(r, minlength=shape[0])
    perm = np.random.default_rng(0).permutation(shape[0])
    # a source of degree >= 1, in the permuted numbering
    source = int(perm[np.flatnonzero(deg)[0]])
    return tiles, source


class _Routes:
    """The routes the segreduce calls of a CPU run would take on the card
    (``segreduce.route``), counted while the run goes through the plain
    version."""

    def __init__(self, monkeypatch):
        self.counts = {"sorted": 0, "atomic": 0}
        inner = segreduce.segment_reduce

        def count(values, seg_ids, num_segments, tag, **kw):
            d = int(np.prod(values.shape[1:], dtype=np.int64))
            self.counts[segreduce.route(values.dtype, d,
                                        kw.get("sorted_ids", False))] += 1
            return inner(values, seg_ids, num_segments, tag, **kw)

        monkeypatch.setattr(segreduce, "segment_reduce", count)


def _launches(fn):
    segreduce.launches = 0
    segreduce.route_launches.update(sorted=0, atomic=0)
    segreduce.reset_descents()
    out = fn()
    torch.cuda.synchronize()
    assert segreduce.descents() == 0, "a sorted_ids promise was broken"
    return out, dict(segreduce.route_launches)


@pytest.mark.gpu
def test_bfs_on_gpu_vs_cpu(rmat):
    tiles, source = rmat
    want = t_bfs(tiles["cpu"], source, mesh=t_make_grid(1, 1, device="cpu"))
    got, routes = _launches(lambda: t_bfs(
        tiles["cuda"], source, mesh=t_make_grid(1, 1, device="cuda")))
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > 1 and routes["sorted"] > 0


@pytest.mark.gpu
def test_pagerank_on_gpu_vs_cpu(rmat):
    tiles, _ = rmat
    want = t_pagerank(tiles["cpu"], mesh=t_make_grid(1, 1, device="cpu"))
    got = t_pagerank(tiles["cuda"], mesh=t_make_grid(1, 1, device="cuda"))
    assert float(np.abs(got - want).max()) <= GPU_PR_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("app", ["bfs", "pagerank"])
def test_segreduce_launches_by_route_on_gpu(rmat, monkeypatch, app):
    """One BFS level and one PageRank iteration: every segreduce call that
    the CPU run makes launches the kernel on the card, on its route (a
    call that reached a library reduction instead would be missing)."""
    tiles, source = rmat
    run = {"bfs": lambda t, dev: t_bfs(t, source, max_iters=1,
                                       mesh=t_make_grid(1, 1, device=dev)),
           "pagerank": lambda t, dev: t_pagerank(
               t, max_iters=1, mesh=t_make_grid(1, 1, device=dev))}[app]
    with monkeypatch.context() as mp:
        model = _Routes(mp)
        run(tiles["cpu"], "cpu")
    _, routes = _launches(lambda: run(tiles["cuda"], "cuda"))
    assert routes == model.counts
    if app == "pagerank":      # the out-degrees, then one spmv_row
        assert routes == dict(sorted=1, atomic=1)
    else:                      # sort variant, sparse merge: 3 an attempt
        assert routes["atomic"] == 0 and routes["sorted"] % 3 == 0 \
            and routes["sorted"] > 0
