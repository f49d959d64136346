"""The port's graph apps on a 2x2 grid of four gloo CPU ranks.

Triangle counting, BFS and PageRank are held against the JAX package on
its 2x2 mesh (4 forced XLA host devices, one subprocess) and against
scipy: triangles and BFS levels bitwise, PageRank within ``SUM_RTOL``
(gloo ranks and XLA add in other orders). FastSV, maximal matching and
HipMCL are held against the port's own 1x1 answers and against scipy
(FastSV's labels, a maximal consistent matching, the float64 MCL's
partition): the JAX package's 2x2 run of them alone takes minutes. Every
rank must hold the same host answer.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from torch_dist_parity import (Frame, JaxReference, assert_same, port_cases,
                               run_ranks)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the network generator and the references)

N = 96
GRID = (2, 2)
ROOTS = (0, 41)
MCL_PROTEINS = 160


def _graph(seed=0, density=0.03, symmetric=True):
    """Unit weights, several components; ``symmetric=False`` gives a
    directed graph with dangling vertices (PageRank's)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((N, N)) < density).astype(np.float32)
    np.fill_diagonal(dense, 0)
    if symmetric:
        dense = np.maximum(dense, dense.T)
    return dense


def _coo(dense):
    r, c = np.nonzero(dense)
    return r.astype(np.int64), c.astype(np.int64), dense[r, c]


def _bipartite(nr=N, nc=80, density=0.04, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.random((nr, nc)) < density).astype(np.float32)


def apps_cases(F):
    D, mesh = F.dist, F.mesh
    sym = _graph()
    a = D.DistSpMat.from_global_coo((N, N), *_coo(sym), F.grid, mesh=mesh)
    out = {"g:tri": F.tricount.triangle_count(a, mesh=mesh),
           "g:bfs": tuple(F.bfs.bfs_levels(a, s, mesh=mesh) for s in ROOTS)}
    # edge u -> v is entry (v, u): PageRank's A[dst, src]
    d = _graph(seed=1, density=0.05, symmetric=False)
    ad = D.DistSpMat.from_global_coo((N, N), *_coo(d.T.copy()), F.grid,
                                     mesh=mesh)
    out["g:pr"] = F.pagerank.pagerank(ad, mesh=mesh)
    if F.package == "repro_torch":
        out["port:cc"] = F.fastsv.fastsv(a, mesh=mesh)
        out["port:cc_skew"] = F.fastsv.fastsv(a, mesh=mesh, skew_aware=True)
        b = _bipartite()
        ab = D.DistSpMat.from_global_coo(b.shape, *_coo(b), F.grid,
                                         mesh=mesh)
        out["port:match"] = F.matching.maximal_matching(ab, mesh=mesh)
        _, r, c, v = chip_smoke.planted_families(MCL_PROTEINS, 8, 16, 0.5, 2)
        am = D.DistSpMat.from_global_coo(
            (MCL_PROTEINS, MCL_PROTEINS), r, c, v.astype(np.float32),
            F.grid, mesh=mesh)
        out["port:mcl"] = F.hipmcl.hipmcl(am, mesh=mesh)
    return out


@pytest.fixture(scope="module")
def results():
    jax = JaxReference(__name__, "apps_cases", [GRID])
    port = run_ranks(port_cases, 4, GRID, __name__, "apps_cases")
    one = apps_cases(Frame("repro_torch", (1, 1)))
    return port, jax.result()[GRID], one


def test_tricount(results):
    port, jax, one = results
    a = sp.csr_matrix(_graph())
    want = int(round((a @ a @ a).diagonal().sum() / 6))
    assert jax["g:tri"] == one["g:tri"] == want
    assert [r["g:tri"] for r in port] == [want] * 4


@pytest.mark.parametrize("k", range(len(ROOTS)))
def test_bfs_levels(results, k):
    port, jax, _ = results
    d = csgraph.shortest_path(sp.csr_matrix(_graph()), unweighted=True,
                              indices=ROOTS[k])
    want = np.where(np.isinf(d), -1, d).astype(np.int32)
    np.testing.assert_array_equal(jax["g:bfs"][k], want)
    for r in port:
        assert_same(r["g:bfs"][k], jax["g:bfs"][k], exact=True)


def test_pagerank(results):
    port, jax, one = results
    assert jax["g:pr"].dtype == np.float32
    for r in port:
        assert_same(r["g:pr"], jax["g:pr"], what="pagerank")
        np.testing.assert_array_equal(r["g:pr"], port[0]["g:pr"])
    assert_same(one["g:pr"], jax["g:pr"], what="pagerank 1x1")


@pytest.mark.parametrize("key", ["port:cc", "port:cc_skew"])
def test_fastsv(results, key):
    port, _, one = results
    _, lab = csgraph.connected_components(sp.csr_matrix(_graph()),
                                          directed=False)
    # min-hooking from arange ends at each component's smallest vertex
    first = np.full(lab.max() + 1, N)
    np.minimum.at(first, lab, np.arange(N))
    want = first[lab].astype(np.int64)
    np.testing.assert_array_equal(one[key], want)
    for r in port:
        np.testing.assert_array_equal(r[key], want)


def test_matching(results):
    port, _, one = results
    csr = sp.csr_matrix(_bipartite())
    card = chip_smoke.check_matching(*one["port:match"], csr)
    for r in port:
        mr, mc = r["port:match"]
        assert chip_smoke.check_matching(mr, mc, csr) == card
        np.testing.assert_array_equal(mr, one["port:match"][0])
        np.testing.assert_array_equal(mc, one["port:match"][1])


def test_hipmcl(results):
    port, _, one = results
    family, r, c, v = chip_smoke.planted_families(MCL_PROTEINS, 8, 16, 0.5, 2)
    a = sp.csr_matrix((v, (r, c)), shape=(MCL_PROTEINS, MCL_PROTEINS))
    ref, _, _ = chip_smoke.mcl_reference(a)
    assert chip_smoke.same_partition(one["port:mcl"], ref)
    for rk in port:
        np.testing.assert_array_equal(rk["port:mcl"], one["port:mcl"])
    assert chip_smoke.purity(one["port:mcl"], family) == 1.0
