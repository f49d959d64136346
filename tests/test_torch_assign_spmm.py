"""Vector assign/extract, SpMM and the label-format reader of the port,
against the JAX package on the same numpy inputs (1x1 grid, CPU).

Assign and extract results and their ``ok`` flags must match bitwise, a
router overflow included; an overwrite with duplicate targets keeps one of
its writers' values (which one is arbitrary in both packages). SpMM's f32
sums agree within ``SUM_RTOL``, min/max semirings bitwise. The reader's
ids, coordinates, values and labels match bitwise. The JAX references run
jitted (``torch_parity.jax_assign``/``jax_extract``). The tests marked
``gpu`` run assign, extract and SpMM on the card against the CPU.
"""
import numpy as np
import pytest
import torch

import repro.core.semiring as jsr
from repro.core.dist import DistSpMat as JDist, DistVec as JVec
from repro.core.dist import make_grid as j_make_grid
from repro.core.spmm import (local_spmm as j_local_spmm,
                             spmm_15d as j_spmm_15d, spmm_2d as j_spmm_2d)
from repro.io import read_generalized_tuples as j_read
from repro.obs import recorder as j_recorder
import repro_torch.core.semiring as tsr
from repro_torch.core import assign as t_assign, extract as t_extract
from repro_torch.core import local_spmm, spmm_15d, spmm_2d
from repro_torch.core.coo import SENTINEL
from repro_torch.core.dist import DistSpMat as TDist, DistVec as TVec
from repro_torch.core.dist import make_grid as t_make_grid
from repro_torch.io import read_generalized_tuples as t_read
from repro_torch.kernels import segreduce
from repro_torch.obs import recorder

from torch_parity import (CPU, assert_values, coo_pair, jax_assign,
                          jax_extract, np_of, rand_entries)

N = 50                 # vector length
CAP = 32               # update / request slots


@pytest.fixture(scope="module")
def jmesh():
    return j_make_grid(1, 1)


@pytest.fixture(scope="module")
def tmesh():
    return t_make_grid(1, 1, device="cpu")


def _vec(x):
    """The same DistVec in both packages."""
    return (JVec.from_global(x, (1, 1), layout="col"),
            TVec.from_global(x, (1, 1), layout="col", device="cpu"))


def _updates(seed, nvalid, dtype=np.int32, unique=False, hi=N):
    """(1, 1, CAP) global indices (SENTINEL past ``nvalid``) and values."""
    rng = np.random.default_rng(seed)
    idx = np.full(CAP, SENTINEL, np.int32)
    idx[:nvalid] = (rng.permutation(hi)[:nvalid] if unique
                    else rng.integers(0, hi, nvalid))
    rng.shuffle(idx)                 # padding interleaved with the entries
    if np.issubdtype(dtype, np.floating):
        val = (rng.random(CAP) * 8 - 4).astype(dtype)
    else:
        val = rng.integers(-1000, 1000, CAP).astype(dtype)
    return idx.reshape(1, 1, CAP), val.reshape(1, 1, CAP)


def _assign_both(jmesh, tmesh, x, idx, val, jadd, tadd, **kw):
    jv, tv = _vec(x)
    jout, jok = jax_assign(jv, idx, val, mesh=jmesh, add=jadd, **kw)
    tout, tok = t_assign(tv, torch.from_numpy(idx), torch.from_numpy(val),
                         mesh=tmesh, add=tadd, **kw)
    return jout, jok, tout, tok


MONOIDS = {"min_int": (jsr.MIN_INT, tsr.MIN_INT),
           "max_int": (jsr.MAX_INT, tsr.MAX_INT),
           "sum": (jsr.PLUS, tsr.PLUS)}


@pytest.mark.parametrize("monoid", sorted(MONOIDS))
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("skew_aware", [False, True])
def test_assign_merges_duplicates_as_jax(jmesh, tmesh, monoid, accumulate,
                                         skew_aware):
    jadd, tadd = MONOIDS[monoid]
    x = np.random.default_rng(1).integers(-500, 500, N).astype(np.int32)
    idx, val = _updates(2, 24)                      # duplicates among 24
    jout, jok, tout, tok = _assign_both(
        jmesh, tmesh, x, idx, val, jadd, tadd, accumulate=accumulate,
        skew_aware=skew_aware)
    assert tout.n == jout.n and tout.layout == jout.layout
    assert_values(tout.data, jout.data, exact=True)
    assert_values(tok, jok, exact=True)
    assert bool(tok.all())
    # the monoid's merge by hand
    want = x.copy()
    live = idx.ravel() != SENTINEL
    for i in np.unique(idx.ravel()[live]):
        vals = val.ravel()[live][idx.ravel()[live] == i]
        upd = {"min_int": vals.min, "max_int": vals.max,
               "sum": vals.sum}[monoid]()
        want[i] = {"min_int": min, "max_int": max,
                   "sum": lambda a, b: a + b}[monoid](want[i], upd) \
            if accumulate else upd
    np.testing.assert_array_equal(tout.to_global(), want)


@pytest.mark.parametrize("skew_aware", [False, True])
def test_assign_f32_sum(jmesh, tmesh, skew_aware):
    x = np.random.default_rng(3).random(N).astype(np.float32)
    idx, val = _updates(4, 30, np.float32)
    jout, jok, tout, tok = _assign_both(jmesh, tmesh, x, idx, val, jsr.PLUS,
                                        tsr.PLUS, accumulate=True,
                                        skew_aware=skew_aware)
    assert_values(tout.data, jout.data)
    assert_values(tok, jok, exact=True)


@pytest.mark.parametrize("skew_aware", [False, True])
def test_assign_overwrite_unique_targets(jmesh, tmesh, skew_aware):
    x = np.arange(N, dtype=np.int32) * 7
    idx, val = _updates(5, 20, unique=True)
    jout, jok, tout, tok = _assign_both(jmesh, tmesh, x, idx, val, None,
                                        None, skew_aware=skew_aware)
    assert_values(tout.data, jout.data, exact=True)
    assert_values(tok, jok, exact=True)
    want = x.copy()
    live = idx.ravel() != SENTINEL
    want[idx.ravel()[live]] = val.ravel()[live]
    np.testing.assert_array_equal(tout.to_global(), want)


@pytest.mark.parametrize("skew_aware", [False, True])
def test_assign_overwrite_duplicates_takes_a_writer(tmesh, skew_aware):
    """Duplicate targets without a monoid take an arbitrary writer (as in
    CombBLAS and JAX): each target holds one of its writers' values, and
    untouched slots keep theirs."""
    x = np.arange(N, dtype=np.int32) * 7
    idx, val = _updates(6, 30, hi=8)                # 30 writes onto 8
    _, tv = _vec(x)
    tout, tok = t_assign(tv, torch.from_numpy(idx), torch.from_numpy(val),
                         mesh=tmesh, skew_aware=skew_aware)
    got = tout.to_global()
    live = idx.ravel() != SENTINEL
    targets = set(idx.ravel()[live].tolist())
    for i in range(N):
        writers = val.ravel()[live][idx.ravel()[live] == i]
        assert got[i] in writers if i in targets else got[i] == x[i]
    assert bool(tok.all())


@pytest.mark.parametrize("skew_aware", [False, True])
def test_assign_route_overflow_clears_ok(jmesh, tmesh, skew_aware):
    """A router of 8 slots for 20 updates keeps the first 8 in bucket order
    and reports it. With ``skew_aware`` every entry rides the heavy path
    on 1x1 (its one piece holds all the traffic), so nothing overflows."""
    x = np.zeros(N, np.int32)
    idx, val = _updates(7, 20, unique=True)
    jout, jok, tout, tok = _assign_both(jmesh, tmesh, x, idx, val,
                                        jsr.MAX_INT, tsr.MAX_INT,
                                        route_cap=8, skew_aware=skew_aware)
    assert_values(tout.data, jout.data, exact=True)
    assert_values(tok, jok, exact=True)
    assert bool(tok.all()) == skew_aware


def test_route_cap_rounds_and_defaults(jmesh, tmesh):
    """route_cap = max(2 * cap, 64) unless given; 20 live updates fit
    route_cap=20 exactly and overflow 19."""
    x = np.zeros(N, np.int32)
    idx, val = _updates(8, 20, unique=True)
    for rc, fits in ((None, True), (20, True), (19, False)):
        jout, jok, tout, tok = _assign_both(jmesh, tmesh, x, idx, val,
                                            jsr.MIN_INT, tsr.MIN_INT,
                                            route_cap=rc)
        assert bool(tok.all()) == fits == bool(np.asarray(jok).all())
        assert_values(tout.data, jout.data, exact=True)


@pytest.mark.parametrize("route_cap", [None, 12])
def test_extract_as_jax(jmesh, tmesh, route_cap):
    """Answers go back by slot; padding, requests past n and requests the
    router dropped read 0."""
    x = (np.arange(N, dtype=np.int32) * 3 + 1)
    idx, _ = _updates(9, 26)
    idx.ravel()[:3] = [N, N + 5, 2 * N]             # past n: unanswered
    jv, tv = _vec(x)
    jvals, jok = jax_extract(jv, idx, mesh=jmesh, route_cap=route_cap)
    tvals, tok = t_extract(tv, torch.from_numpy(idx), mesh=tmesh,
                           route_cap=route_cap)
    assert_values(tvals, jvals, exact=True)
    assert_values(tok, jok, exact=True)
    assert bool(tok.all()) == (route_cap is None)
    if route_cap is None:
        g = idx.ravel()
        want = np.where((g != SENTINEL) & (g < N), x[np.minimum(g, N - 1)], 0)
        np.testing.assert_array_equal(np_of(tvals).ravel(), want)


def test_extract_f32(jmesh, tmesh):
    x = np.random.default_rng(10).random(N).astype(np.float32)
    idx, _ = _updates(11, 31)
    jv, tv = _vec(x)
    jvals, jok = jax_extract(jv, idx, mesh=jmesh)
    tvals, tok = t_extract(tv, torch.from_numpy(idx), mesh=tmesh)
    assert_values(tvals, jvals, exact=True)
    assert_values(tok, jok, exact=True)


# --------------------------------------------------------------------------
# SpMM
# --------------------------------------------------------------------------

SPMM_SEMIRINGS = {"plus_times": (jsr.ARITHMETIC, tsr.ARITHMETIC, False),
                  "min_plus": (jsr.MIN_PLUS, tsr.MIN_PLUS, True),
                  "max_min": (jsr.MAX_MIN, tsr.MAX_MIN, True)}
K = 16


def _dense_x(n, seed):
    return np.random.default_rng(seed).standard_normal((n, K)) \
        .astype(np.float32)


@pytest.mark.parametrize("name", sorted(SPMM_SEMIRINGS))
def test_local_spmm(name):
    jsr_, tsr_, exact = SPMM_SEMIRINGS[name]
    r, c, v = rand_entries(24, 70, seed=12)          # duplicates included
    j, t = coo_pair((24, 24), r, c, v, cap=96)
    x = _dense_x(24, 13)
    want = j_local_spmm(j, x, jsr_)
    got = local_spmm(t, torch.from_numpy(x), tsr_)
    assert_values(got, want, exact=exact)


def _spmat_pair(n, seed):
    r, c, v = rand_entries(n, 3 * n, seed=seed)
    j = JDist.from_global_coo((n, n), r, c, v, (1, 1), cap=4 * n)
    t = TDist.from_numpy(np_of(j.row), np_of(j.col), np_of(j.val),
                         np_of(j.nnz), j.shape, j.grid, j.order, CPU)
    return j, t, (r, c, v)


@pytest.mark.parametrize("name", sorted(SPMM_SEMIRINGS))
def test_spmm_15d_and_2d(jmesh, tmesh, name):
    jsr_, tsr_, exact = SPMM_SEMIRINGS[name]
    ja, ta, (r, c, v) = _spmat_pair(40, 14)
    x = _dense_x(40, 15)
    jx, tx = _vec(x)
    jy = j_spmm_15d(ja, jx, jsr_, mesh=jmesh)
    ty = spmm_15d(ta, tx, tsr_, mesh=tmesh)
    assert ty.layout == jy.layout == "row" and ty.n == jy.n
    assert_values(ty.data, jy.data, exact=exact)
    jy2 = j_spmm_2d(ja, x, jsr_, mesh=jmesh)
    ty2 = spmm_2d(ta, torch.from_numpy(x), tsr_, mesh=tmesh)
    assert_values(ty2, jy2, exact=exact)
    # on 1x1 both run local_spmm on the one tile
    assert torch.equal(ty2, ty.data.reshape(ty2.shape))
    if name == "plus_times":
        dense = np.zeros((40, 40), np.float64)
        np.add.at(dense, (r, c), v)
        np.testing.assert_allclose(ty2.numpy(), dense @ x, rtol=1e-5,
                                   atol=1e-5)


def test_spmm_2d_checks_its_operand(tmesh):
    _, ta, _ = _spmat_pair(40, 16)
    with pytest.raises(AssertionError):
        spmm_2d(ta, torch.zeros(39, K), mesh=tmesh)


# --------------------------------------------------------------------------
# the label-format reader
# --------------------------------------------------------------------------

def _write_labels(path, seed):
    """Protein-ish and scattered-integer labels, weighted and unweighted
    lines, blank lines; ~1,000 lines so each of the 4 workers' byte ranges
    cuts lines in the middle."""
    rng = np.random.default_rng(seed)
    names = [f"PROT_{i:06d}" for i in rng.permutation(300)[:120]] + \
        [str(int(x)) for x in rng.integers(0, 10**12, 30)] + ["ACGTTGCA"]
    lines = []
    for k in range(1000):
        a, b = rng.integers(0, len(names), 2)
        if k % 7 == 0:
            lines.append(f"{names[a]} {names[b]}")
        else:
            lines.append(f"{names[a]}\t{names[b]}\t{rng.random():.6g}")
        if k % 97 == 0:
            lines.append("")
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("nworkers", [1, 4])
def test_read_generalized_tuples_as_jax(tmp_path, nworkers):
    path = str(_write_labels(tmp_path / "net.lbl", 17))
    want = j_read(path, nworkers)
    with recorder.capture() as rec:
        got = t_read(path, nworkers)
        snap = rec.snapshot()
    assert got[0] == want[0]
    for g, w in zip(got[1:4], want[1:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]
    # same span and counter names as the JAX package's recorder
    assert snap["spans"]["io.read_tuples"]["count"] == 1
    with j_recorder.capture() as jrec:
        j_read(path, nworkers)
        jsnap = jrec.snapshot()
    assert snap["counters"]["io.bytes_read"] == \
        jsnap["counters"]["io.bytes_read"]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the segreduce kernel runs only there")
    return torch.device("cuda")


def _on(v: TVec, dev):
    return TVec(v.data.to(dev), v.n, v.grid, v.layout)


@pytest.mark.gpu
def test_assign_extract_on_gpu_vs_cpu(cuda):
    gmesh = t_make_grid(1, 1, device="cuda")
    cmesh = t_make_grid(1, 1, device="cpu")
    x = np.random.default_rng(18).integers(-500, 500, N).astype(np.int32)
    idx, val = _updates(19, 24)
    _, tv = _vec(x)
    ti, tval = torch.from_numpy(idx), torch.from_numpy(val)
    segreduce.launches = 0
    for kw in (dict(add=tsr.MIN_INT, accumulate=True),
               dict(add=tsr.MAX_INT, skew_aware=True)):
        want, wok = t_assign(tv, ti, tval, mesh=cmesh, **kw)
        got, gok = t_assign(_on(tv, cuda), ti.to(cuda), tval.to(cuda),
                            mesh=gmesh, **kw)
        assert torch.equal(got.data.cpu(), want.data)
        assert torch.equal(gok.cpu(), wok)
    # the merge and the touch count each time, the census once
    assert segreduce.launches == 5
    want, wok = t_extract(tv, ti, mesh=cmesh)
    got, gok = t_extract(_on(tv, cuda), ti.to(cuda), mesh=gmesh)
    assert torch.equal(got.cpu(), want) and torch.equal(gok.cpu(), wok)


@pytest.mark.gpu
def test_spmm_on_gpu_vs_cpu(cuda):
    r, c, v = rand_entries(40, 120, seed=20)
    ta, tg = (TDist.from_global_coo((40, 40), r, c, v, (1, 1), device=dev)
              for dev in ("cpu", "cuda"))
    x = torch.from_numpy(_dense_x(40, 21))
    want = spmm_2d(ta, x, mesh=t_make_grid(1, 1, device="cpu"))
    segreduce.route_launches.update(sorted=0, atomic=0)
    got = spmm_2d(tg, x.to(cuda), mesh=t_make_grid(1, 1, device="cuda"))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    # vector values: the atomic route, though the ids are sorted
    assert segreduce.route_launches == {"sorted": 0, "atomic": 1}
