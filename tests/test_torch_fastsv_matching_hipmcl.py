"""FastSV, maximal matching and HipMCL through the port, against the JAX
package on the same numpy inputs (1x1 grid, CPU).

FastSV labels and the mate vectors must match bitwise, with the same
iteration counts. HipMCL must run the same iterations with each iterate's
pattern equal and its values within ``MCL_TOL``; its labels match bitwise
on the two-clique graph of ``tests/test_apps.py``. On a planted-family
network the JAX package's final symmetrization drops entries (reference
defect 5, ROADMAP.md §3): there the port's labels match the JAX FastSV of
the full union of the JAX package's own final iterate, and the partition of
``chip_smoke.mcl_reference`` (scipy, float64). The JAX apps run once per
graph from module-scoped fixtures, with their primitives jitted
(``torch_parity.jax_graph_apps_jitted``). The tests marked ``gpu`` run each
app on the card against the port's CPU run.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

import repro.core.semiring as jsr
from repro.apps import (fastsv as j_fastsv, hipmcl as j_hipmcl,
                        maximal_matching as j_matching)
from repro.core.coo import ewise_union as j_ewise_union
from repro.core.dist import DistSpMat as JDist, make_grid as j_make_grid
from repro.obs import recorder as j_recorder
from repro_torch.apps import fastsv, hipmcl, maximal_matching
from repro_torch.core.dist import DistSpMat as TDist, make_grid as t_make_grid
from repro_torch.io.rmat import rmat_coo
from repro_torch.kernels import segreduce
from repro_torch.obs import recorder

from torch_parity import (CPU, jax_graph_apps_jitted, jax_mat_ewise_local,
                          jax_mat_transpose, jax_reference, np_of)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the network generator and the references)

MCL_TOL = 1e-5           # HipMCL iterate values, max |Δ| against JAX's


def make_graph(n, density, seed, symmetric=True):
    """``tests/test_apps.py``'s random 0/1 graph without self loops."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(dense, 0)
    if symmetric:
        dense = np.maximum(dense, dense.T)
    r, c = np.nonzero(dense)
    return dense.shape, r, c, dense[r, c]


def two_components():
    """A ring 0..10, an isolated vertex 11 and a path 12..23."""
    n = 24
    dense = np.zeros((n, n), np.float32)
    for i in range(0, 10):
        dense[i, (i + 1) % 11] = dense[(i + 1) % 11, i] = 1
    for i in range(12, n - 1):
        dense[i, i + 1] = dense[i + 1, i] = 1
    r, c = np.nonzero(dense)
    return dense.shape, r, c, dense[r, c]


def rmat8():
    shape, r, c, v = rmat_coo(8, 16, seed=0, symmetrize=True,
                              drop_self_loops=True)
    perm = np.random.default_rng(0).permutation(shape[0])
    return shape, perm[r], perm[c], v


def _pair(shape, r, c, v, cap=None):
    """Both packages' tiles of the same entries (the port's taken from the
    JAX package's arrays), and the graph as a scipy CSR."""
    j = JDist.from_global_coo(shape, np.asarray(r, np.int64),
                              np.asarray(c, np.int64), v, (1, 1), cap=cap)
    t = TDist.from_numpy(np_of(j.row), np_of(j.col), np_of(j.val),
                         np_of(j.nnz), j.shape, j.grid, j.order, CPU)
    csr = sp.csr_matrix((np.ones(len(r)), (r, c)), shape=shape)
    return j, t, csr


def _span_count(rec, name):
    return rec.snapshot()["spans"].get(name, {}).get("count", 0)


@pytest.fixture(scope="module")
def tmesh():
    return t_make_grid(1, 1, device="cpu")


# --------------------------------------------------------------------------
# FastSV
# --------------------------------------------------------------------------

FASTSV_GRAPHS = {
    "sparse60": lambda: make_graph(60, 0.03, 3),
    "dense60": lambda: make_graph(60, 0.08, 4),
    "two_components": two_components,
    "rmat8": rmat8,
}


@pytest.fixture(scope="module")
def fastsv_runs():
    """The JAX FastSV once per graph (and once with ``skew_aware`` on
    dense60): labels and hooking iterations."""
    jmesh = j_make_grid(1, 1)
    out = {}
    with jax_graph_apps_jitted():
        for name, make in FASTSV_GRAPHS.items():
            j, t, csr = _pair(*make(), cap=8192)
            with j_recorder.capture() as rec:
                labels = j_fastsv(j, mesh=jmesh)
                iters = _span_count(rec, "fastsv.iter")
            out[name] = (t, csr, labels, iters)
        j, t, _ = _pair(*make_graph(60, 0.08, 4), cap=8192)
        out["skew"] = (t, j_fastsv(j, mesh=jmesh, skew_aware=True))
    return out


@pytest.mark.parametrize("name", sorted(FASTSV_GRAPHS))
def test_fastsv_labels(fastsv_runs, tmesh, name):
    ta, csr, want, want_iters = fastsv_runs[name]
    with recorder.capture() as rec:
        got = fastsv(ta, mesh=tmesh)
        iters = _span_count(rec, "fastsv.iter")
    assert got.dtype == np.int64 == want.dtype
    np.testing.assert_array_equal(got, want)
    assert iters == want_iters
    # min-hooking from arange ends at each component's smallest vertex
    n = csr.shape[0]
    ncc, comp = csgraph.connected_components(csr, directed=False)
    smallest = np.full(ncc, n)
    np.minimum.at(smallest, comp, np.arange(n))
    np.testing.assert_array_equal(got, smallest[comp])


def test_fastsv_skew_aware(fastsv_runs, tmesh):
    ta, want = fastsv_runs["skew"]
    np.testing.assert_array_equal(fastsv(ta, mesh=tmesh, skew_aware=True),
                                  want)


@pytest.mark.parametrize("app", ["fastsv", "hipmcl"])
def test_refuses_what_is_not_ported(fastsv_runs, tmesh, app):
    """``elastic=True`` on 1x1: two device losses are survived in-process
    (the labels the uninterrupted run's); a third, past
    ``max_topology_events``, is refused: the TopologyError propagates."""
    import warnings
    from repro_torch.robust import faults
    from repro_torch.robust.deadline import TopologyError
    ta = fastsv_runs["two_components"][0]
    fn = {"fastsv": fastsv, "hipmcl": hipmcl}[app]
    want = fn(ta, mesh=tmesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with faults.inject("loop.device_loss:crash:at=2,count=2"):
            got = fn(ta, mesh=tmesh, elastic=True)
        np.testing.assert_array_equal(got, want)
        with faults.inject("loop.device_loss:crash:at=2,count=3"), \
                pytest.raises(TopologyError, match="injected device loss"):
            fn(ta, mesh=tmesh, elastic=True)


# --------------------------------------------------------------------------
# maximal matching
# --------------------------------------------------------------------------

def _bipartite(nr, nc, density, seed):
    rng = np.random.default_rng(seed)
    dense = (rng.random((nr, nc)) < density).astype(np.float32)
    r, c = np.nonzero(dense)
    return dense.shape, r, c, dense[r, c]


MATCHING_GRAPHS = {
    "bipartite32": lambda: _bipartite(32, 32, 0.15, 7),
    "rect24x40": lambda: _bipartite(24, 40, 0.1, 8),
    "diagonal16": lambda: ((16, 16), np.arange(16), np.arange(16),
                           np.ones(16, np.float32)),
    "rmat8": rmat8,
}


@pytest.fixture(scope="module")
def matching_runs():
    """The JAX matching once per graph, and once on bipartite32 cut to one
    iteration."""
    jmesh = j_make_grid(1, 1)
    out = {}
    with jax_graph_apps_jitted():
        for name, make in MATCHING_GRAPHS.items():
            j, t, csr = _pair(*make(), cap=8192)
            out[name] = (t, csr, j_matching(j, mesh=jmesh))
        j, t, _ = _pair(*MATCHING_GRAPHS["bipartite32"](), cap=8192)
        out["one_iter"] = (t, None, j_matching(j, mesh=jmesh, max_iters=1))
    return out


@pytest.mark.parametrize("name", sorted(MATCHING_GRAPHS) + ["one_iter"])
def test_matching(matching_runs, tmesh, name):
    ta, csr, (want_r, want_c) = matching_runs[name]
    got_r, got_c = maximal_matching(
        ta, mesh=tmesh, **({"max_iters": 1} if name == "one_iter" else {}))
    assert got_r.dtype == np.int64 and got_c.dtype == np.int64
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_c, want_c)
    if csr is not None:          # consistent, every pair an edge, maximal
        card = chip_smoke.check_matching(got_r, got_c, csr)
        if name == "diagonal16":
            assert card == 16


def test_check_matching_catches_faults(matching_runs):
    """The card's checks (``chip_smoke.check_matching``) refuse an
    inconsistent and a non-maximal matching."""
    _, csr, (mr, mc) = matching_runs["bipartite32"]
    r = int(np.flatnonzero(mr >= 0)[0])
    bad_c = mc.copy()
    bad_c[mr[r]] = -1
    with pytest.raises(AssertionError, match="disagree"):
        chip_smoke.check_matching(mr, bad_c, csr)
    bad_r = mr.copy()
    bad_r[r] = -1
    with pytest.raises(AssertionError, match="not maximal"):
        chip_smoke.check_matching(bad_r, bad_c, csr)


# --------------------------------------------------------------------------
# HipMCL
# --------------------------------------------------------------------------

def two_cliques():
    """``tests/test_apps.py``: two 6-cliques with self-loops joined by one
    weak edge."""
    n = 12
    dense = np.zeros((n, n), np.float32)
    dense[:6, :6] = 1.0
    dense[6:, 6:] = 1.0
    dense[5, 6] = dense[6, 5] = 0.1
    r, c = np.nonzero(dense)
    return dense.shape, r, c, dense[r, c]


def planted():
    """64 proteins in planted families of 8-16 (phase 14's generator)."""
    _, r, c, v = chip_smoke.planted_families(64, 8, 16, 0.5, 2)
    return (64, 64), r, c, v.astype(np.float32)


HIPMCL_GRAPHS = {
    "two_cliques": (two_cliques, dict(inflation=2.0, max_iters=12,
                                      prod_cap=1 << 14, out_cap=1 << 12)),
    "planted": (planted, {}),
}


def _recording(loop_cls, states):
    """``loop_cls`` whose run keeps every state the body returns."""
    class Recording(loop_cls):
        def run(self, state, body, max_iters):
            def kept(it, st):
                out, done = body(it, st)
                states.append(out)
                return out, done
            return super().run(state, kept, max_iters)
    return Recording


@pytest.fixture(scope="module")
def hipmcl_runs():
    """The JAX HipMCL once per graph: its labels, every iterate, and the
    labels of the JAX FastSV on the full union of its final iterate and
    that iterate's transpose."""
    jmesh = j_make_grid(1, 1)
    jmod = sys.modules["repro.apps.hipmcl"]
    out = {}
    with jax_graph_apps_jitted(), jax_reference():
        for name, (make, kw) in HIPMCL_GRAPHS.items():
            shape, r, c, v = make()
            j, t, _ = _pair(shape, r, c, v, cap=1024)
            states = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jmod, "CheckpointedLoop",
                           _recording(jmod.CheckpointedLoop, states))
                labels = j_hipmcl(j, mesh=jmesh, **kw)
            last = states[-1]
            c_fin = JDist.from_global_coo(
                shape, last["rows"], last["cols"], last["vals"], (1, 1),
                mesh=jmesh, order=bytes(last["order"]).decode())
            sym = jax_mat_ewise_local(
                c_fin, jax_mat_transpose(c_fin, mesh=jmesh),
                lambda t1, t2: j_ewise_union(t1, t2, jsr.ARITHMETIC.add),
                mesh=jmesh)
            full = j_fastsv(sym, mesh=jmesh)
            out[name] = (t, (shape, r, c, v), kw, labels, states, full)
    return out


def _port_hipmcl(ta, kw, tmesh):
    states = []
    tmod = sys.modules["repro_torch.apps.hipmcl"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmod, "CheckpointedLoop",
                   _recording(tmod.CheckpointedLoop, states))
        labels = hipmcl(ta, mesh=tmesh, **kw)
    return labels, states


@pytest.mark.parametrize("name", sorted(HIPMCL_GRAPHS))
def test_hipmcl_iterates(hipmcl_runs, tmesh, name):
    ta, _, kw, _, want, _ = hipmcl_runs[name]
    _, got = _port_hipmcl(ta, kw, tmesh)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["rows"], w["rows"])
        np.testing.assert_array_equal(g["cols"], w["cols"])
        assert g["vals"].dtype == np.asarray(w["vals"]).dtype == np.float32
        assert float(np.abs(g["vals"] - w["vals"]).max()) <= MCL_TOL
        assert bytes(g["order"]) == bytes(w["order"])
        assert abs(float(g["prev_sum"]) - float(w["prev_sum"])) <= MCL_TOL


def test_hipmcl_labels_two_cliques(hipmcl_runs, tmesh):
    ta, _, kw, want, _, full = hipmcl_runs["two_cliques"]
    got, _ = _port_hipmcl(ta, kw, tmesh)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full)   # its union dropped nothing
    assert len(set(got[:6])) == len(set(got[6:])) == 1 and got[0] != got[6]


def test_hipmcl_union_keeps_every_entry(hipmcl_runs, tmesh):
    """Reference defect 5: the JAX package symmetrizes the attractor
    pattern into ``cap=t1.cap`` slots, dropping the row-major tail of the
    union, which splits clusters. The port keeps the whole union: its
    labels are the JAX FastSV's on the JAX package's own final iterate,
    symmetrized in full, and its partition is the float64 MCL's."""
    ta, (shape, r, c, v), kw, want, _, full = hipmcl_runs["planted"]
    got, _ = _port_hipmcl(ta, kw, tmesh)
    np.testing.assert_array_equal(got, full)
    ref, _, _ = chip_smoke.mcl_reference(
        sp.csr_matrix((v.astype(np.float64), (r, c)), shape=shape))
    assert chip_smoke.same_partition(got, ref)
    assert not chip_smoke.same_partition(want, ref)
    assert len(np.unique(want)) > len(np.unique(ref))


def test_partition_helpers():
    assert chip_smoke.same_partition([0, 0, 1, 2], [5, 5, 0, 3])
    assert not chip_smoke.same_partition([0, 0, 1, 1], [0, 0, 0, 1])
    assert not chip_smoke.same_partition([0, 0, 0, 1], [0, 0, 1, 1])
    truth = np.array([0, 0, 0, 1, 1, 1])
    assert chip_smoke.purity(np.array([0, 0, 0, 1, 1, 1]), truth) == 1.0
    assert chip_smoke.purity(np.array([0, 0, 0, 0, 0, 0]), truth) == 0.5


def test_label_file_round_trip(tmp_path):
    """Phase 14's LABEL file through the port's reader gives back the
    network, relabelled."""
    from repro_torch.io import read_generalized_tuples
    family, rows, cols, vals = chip_smoke.planted_families(200, 8, 16, 0.5, 2)
    path = tmp_path / "net.lbl"
    chip_smoke.write_label_file(path, rows, cols, vals)
    shape, r, c, v, labels = read_generalized_tuples(str(path), 4)
    orig = np.array([int(lb[5:]) for lb in labels])
    assert shape == (200, 200) and sorted(orig) == list(range(200))
    got = sp.csr_matrix((v, (orig[r], orig[c])), shape=shape)
    want = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    assert abs(got - want).max() <= 5e-6 * abs(want).max()
    assert (abs(got - got.T)).max() == 0
    assert np.all(np.bincount(family)[:-1] >= 8)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the segreduce kernel runs only there")
    return torch.device("cuda")


def _both(shape, r, c, v):
    return {dev: TDist.from_global_coo(shape, r, c, v, (1, 1), device=dev)
            for dev in ("cpu", "cuda")}


def _on_card(fn):
    segreduce.route_launches.update(sorted=0, atomic=0)
    segreduce.reset_descents()
    out = fn()
    torch.cuda.synchronize()
    assert segreduce.descents() == 0, "a sorted_ids promise was broken"
    return out, dict(segreduce.route_launches)


@pytest.mark.gpu
def test_fastsv_on_gpu_vs_cpu(cuda):
    shape, r, c, v = rmat_coo(10, 16, seed=0, symmetrize=True,
                              drop_self_loops=True)
    tiles = _both(shape, r, c, v)
    want = fastsv(tiles["cpu"], mesh=t_make_grid(1, 1, device="cpu"))
    got, routes = _on_card(lambda: fastsv(
        tiles["cuda"], mesh=t_make_grid(1, 1, device="cuda")))
    np.testing.assert_array_equal(got, want)
    assert routes["sorted"] > 0 and routes["atomic"] == 2 * routes["sorted"]


@pytest.mark.gpu
def test_matching_on_gpu_vs_cpu(cuda):
    shape, r, c, v = rmat_coo(10, 16, seed=0, symmetrize=True,
                              drop_self_loops=True)
    tiles = _both(shape, r, c, v)
    want = maximal_matching(tiles["cpu"],
                            mesh=t_make_grid(1, 1, device="cpu"))
    got, routes = _on_card(lambda: maximal_matching(
        tiles["cuda"], mesh=t_make_grid(1, 1, device="cuda")))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert routes["sorted"] == 0 and routes["atomic"] > 0


@pytest.mark.gpu
def test_hipmcl_on_gpu_vs_cpu(cuda):
    _, r, c, v = chip_smoke.planted_families(512, 16, 32, 0.5, 2)
    tiles = _both((512, 512), r, c, v.astype(np.float32))
    want = hipmcl(tiles["cpu"], mesh=t_make_grid(1, 1, device="cpu"))
    got, routes = _on_card(lambda: hipmcl(
        tiles["cuda"], mesh=t_make_grid(1, 1, device="cuda")))
    np.testing.assert_array_equal(got, want)   # each component's least id
    assert routes["sorted"] > 0 and routes["atomic"] > 0
