"""In-process elastic regrid on gloo CPU ranks, held against the JAX package.

A grid position of the port is a process, so a grid smaller than the
world lives on world ranks ``0 .. n-1`` (the JAX package's ``make_grid``
takes the first ``n`` devices), and ``regrid`` moves a matrix between two
grids of one world. Each case runs once over both packages (``Frame``):
the port on four (eight) gloo ranks, one ``run_ranks`` spawn a world size,
JAX in one subprocess with 4 (8) forced XLA host devices
(``JaxReference``).

- ``DistSpMat.regrid`` (JAX's ``TestRegrid2D`` at the grids four ranks
  allow): 2x2 -> 1x1, 1x1 -> 2x2 (the ranks new to the grid ``join``),
  the ``order`` tag, ``cap`` re-planned and overridden, the empty matrix,
  1x1 -> 1x1; ``DistSpMat3D.regrid`` (``TestRegrid3D``): 2x2x2 -> 1x2x2
  and back (ranks 4-7 ``join``), 2x2x2 -> 2x1x1 with ``dist='csub'``.
  Global COO and tile fields
  bitwise; a rank the new grid leaves out gets None.
- The sub-world grid: 1x2x2's collectives in a world of eight reach ranks
  0-3 only, and ranks 4-7 hold no position of it.
- ``elastic=True`` PageRank and FastSV on ``tests/elastic_regrid_scenario.py``'s
  dyadic 32-vertex and 64-vertex graphs, a device loss at the 4th
  iteration on 2x2: bitwise JAX's live run and the uninterrupted 1x1 run;
  PageRank checkpoints every iteration, so rank 0 saves on 1x1 after the
  shrink while ranks 1-3 wait in the final broadcast (a save that waited on
  them would hang). HipMCL on a small planted network: JAX's labels. Every
  rank returns the same answer.
"""
import importlib
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from torch_dist_parity import (Frame, JaxReference, assert_same, run_ranks,
                               stack_shards)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the planted-network generator)

# tests/elastic_regrid_scenario.py's graphs and loss (importing it would set
# XLA_FLAGS in this process)
N_PR, N_SV, CRASH_AT = 32, 64, 4
GRID = (2, 2)
GRID3 = (2, 2, 2)
MCL_PROTEINS = 48
LOSS = f"loop.device_loss:crash:at={CRASH_AT}"
REGRID2D = ("shrink", "grow", "order_row", "order_col", "cap", "empty",
            "on_mesh")
APPS = ("pagerank", "fastsv", "hipmcl")
CKPT_ENV = "REPRO_TEST_ELASTIC_DIR"


def _coo(n=48, density=0.08, seed=0):
    """``tests/test_elastic.py``'s matrices."""
    rng = np.random.default_rng(seed)
    dense = rng.random((n, n)) < density
    r, c = np.nonzero(dense)
    v = rng.standard_normal(len(r)).astype(np.float32)
    return (n, n), r.astype(np.int64), c.astype(np.int64), v


def _mesh(F, *grid):
    pr, pc = grid[-2:]
    layers = grid[0] if len(grid) == 3 else 1
    if F.package == "repro":
        return F.dist.make_grid(pr, pc, layers)
    return F.dist.make_grid(pr, pc, layers, device="cpu")


def _rank(F):
    """This process's world rank (None in JAX: one process holds all)."""
    if F.package == "repro":
        return None
    return F.dist.comm.world()[0]


def _held(m):
    """A regrid's result as host values: grid, tag, cap, global COO, and
    the fields (the whole array in JAX, this rank's shard in the port);
    None where the new grid left this rank out."""
    if m is None:
        return None
    fields = {f: Frame.out(getattr(m, f)) for f in ("row", "col", "val",
                                                    "nnz")}
    return {"grid": tuple(m.grid), "order": m.order, "cap": int(m.cap),
            "dist": getattr(m, "dist", None), "coo": m.to_global_coo(),
            "fields": fields}


def regrid_cases(F):
    """``TestRegrid2D`` on a world of four: every case's result a rank."""
    D = F.dist.DistSpMat
    rank = _rank(F)
    one = _mesh(F, 1, 1)
    out = {}
    shape, r, c, v = _coo(seed=1)
    a = D.from_global_coo(shape, r, c, v, GRID, mesh=F.mesh)
    out["shrink"] = _held(a.regrid((1, 1), mesh=one))
    shape, r, c, v = _coo(seed=2)
    if rank in (None, 0):
        a = D.from_global_coo(shape, r, c, v, (1, 1), mesh=one)
        out["grow"] = _held(a.regrid(GRID, mesh=F.mesh))
    else:
        out["grow"] = _held(D.join(GRID, mesh=F.mesh))
    for tag in ("row", "col"):
        shape, r, c, v = _coo(seed=3)
        a = D.from_global_coo(shape, r, c, v, GRID, mesh=F.mesh, order=tag)
        out[f"order_{tag}"] = _held(a.regrid((1, 1), mesh=one))
    shape, r, c, v = _coo(seed=4)
    a = D.from_global_coo(shape, r, c, v, GRID, mesh=F.mesh)
    b = a.regrid((1, 1), mesh=one)
    out["cap"] = None if b is None else (
        int(b.cap), int(b.regrid((1, 1), mesh=one, cap=4096).cap))
    z = np.zeros(0, np.int64)
    a = D.from_global_coo((32, 32), z, z, np.zeros(0, np.float32), GRID,
                          mesh=F.mesh)
    out["empty"] = _held(a.regrid((1, 1), mesh=one))
    out["on_mesh"] = None
    if rank in (None, 0):                 # 1x1 -> 1x1: rank 0's grid
        shape, r, c, v = _coo(seed=5)
        a = D.from_global_coo(shape, r, c, v, (1, 1), mesh=one)
        out["on_mesh"] = _held(a.regrid((1, 1), mesh=one))
    return out


def regrid3d_cases(F):
    """``TestRegrid3D`` on a world of eight, and (the port) the 1x2x2
    grid's collectives."""
    D = F.dist.DistSpMat3D
    # JAX's TestRegrid3D assembles its targets host-side (mesh=None: a
    # one-layer JAX mesh has no 'layer' axis); the port's tiles need a
    # device
    tgt = (lambda *g: None) if F.package == "repro" else \
        (lambda *g: _mesh(F, *g))
    out = {}
    shape, r, c, v = _coo(n=60, seed=6)
    a = D.from_global_coo(shape, r, c, v, GRID3, "acol", mesh=F.mesh)
    b = a.regrid((1, 2, 2), mesh=tgt(1, 2, 2))
    out["layer_shrink"] = _held(b)
    # and back (a grow): the four ranks new to 2x2x2 join
    g = b.regrid(GRID3, mesh=F.mesh) if b is not None else \
        D.join(GRID3, mesh=F.mesh)
    out["layer_grow"] = _held(g)
    shape, r, c, v = _coo(n=60, seed=7)
    a = D.from_global_coo(shape, r, c, v, GRID3, "brow", mesh=F.mesh)
    out["dist_override"] = _held(a.regrid((2, 1, 1), mesh=tgt(2, 1, 1),
                                          dist="csub"))
    if F.package == "repro_torch":
        out["subworld"] = _subworld(F)
    return out


def _subworld(F):
    """The 1x2x2 grid of a world of eight: its WORLD group's ranks, a
    gather and a sum over it on ranks 0-3; ranks 4-7 only learn that they
    are outside."""
    import torch
    import torch.distributed as dist
    comm = F.dist.comm
    g = comm.of((1, 2, 2))
    rank = comm.world()[0]
    if not g.member:
        return {"member": False, "groups": len(g.groups),
                "holds": comm.holds((1, 2, 2))}
    x = torch.tensor([10 + rank], dtype=torch.int64)
    return {"member": True, "holds": comm.holds((1, 2, 2)),
            "ranks": dist.get_process_group_ranks(g.groups[comm.WORLD]),
            "gather": comm.gather_grid(x, (1, 2, 2)).reshape(-1),
            "sum": int(comm.psum(x, g, comm.WORLD)),
            "row": int(comm.psum(x, g, "row")),
            "col": int(comm.psum(x, g, "col"))}


def _mcl_graph():
    """Planted families of 2-4 among the first 32 proteins, then 16 with
    no similar protein (a self-loop alone): the JAX package's union keeps
    ``cap`` entries of the attractor pattern and its transpose, and drops
    the row-major tail (reference defect 5), which here holds singletons
    alone, so its labels are the float64 MCL's too."""
    fam = 32
    _, r, c, v = chip_smoke.planted_families(fam, 2, 4, 0.9, 1)
    lone = np.arange(fam, MCL_PROTEINS, dtype=np.int64)
    return ((MCL_PROTEINS, MCL_PROTEINS), np.concatenate([r, lone]),
            np.concatenate([c, lone]),
            np.concatenate([v, np.ones(len(lone))]).astype(np.float32))


def _app(F, name, grid, mesh, elastic, ckpt=None):
    if name == "pagerank":
        n = N_PR
        src = np.repeat(np.arange(n, dtype=np.int64), 2)
        dst = np.empty(2 * n, np.int64)
        dst[0::2] = (np.arange(n) + 1) % n
        dst[1::2] = (np.arange(n) + 17) % n
        a = F.dist.DistSpMat.from_global_coo(
            (n, n), dst, src, np.ones(2 * n, np.float32), grid, mesh=mesh,
            cap=1024)
        return F.pagerank.pagerank(a, mesh=mesh, alpha=0.5, tol=0.0,
                                   max_iters=6, checkpoint_dir=ckpt,
                                   elastic=elastic)
    if name == "fastsv":
        n = N_SV
        e = [(i, i + 1) for lo in (0, 32) for i in range(lo, lo + 31)]
        rows = np.array([x for p in e for x in p], np.int64)
        cols = np.array([x for p in e for x in p[::-1]], np.int64)
        a = F.dist.DistSpMat.from_global_coo(
            (n, n), rows, cols, np.ones(len(rows), np.float32), grid,
            mesh=mesh, cap=1024)
        return F.fastsv.fastsv(a, mesh=mesh, max_iters=16, elastic=elastic)
    shape, r, c, v = _mcl_graph()
    a = F.dist.DistSpMat.from_global_coo(shape, r, c, v, grid, mesh=mesh)
    return F.hipmcl.hipmcl(a, mesh=mesh, elastic=elastic)


def _elastic(F, names, base):
    """Each app of ``names`` with ``elastic=True`` and a device loss at its
    4th iteration on 2x2 (and, with ``base``, uninterrupted on 1x1); with
    the iterations each rank ran (spans ``<app>.iter``) and its regrid and
    topology records."""
    faults = importlib.import_module(f"{F.package}.robust.faults")
    obs = importlib.import_module(f"{F.package}.obs")
    warnings.simplefilter("ignore", RuntimeWarning)
    out = {}
    for name in names:
        ckpt = os.path.join(os.environ[CKPT_ENV], F.package) \
            if name == "pagerank" else None
        with obs.capture() as rec, faults.inject(LOSS):
            got = _app(F, name, GRID, F.mesh, True, ckpt)
            snap = rec.snapshot()
        out[name] = {
            "live": got,
            "iters": snap["spans"].get(f"{name}.iter", {}).get("count", 0),
            "regrids": snap["spans"].get("dist.regrid", {}).get("count", 0),
            "topology": snap["events"].get("loop.topology", 0),
            "ckpt": None}
        if base:
            out[name]["base"] = _app(F, name, (1, 1), _mesh(F, 1, 1), False)
        if ckpt is not None:
            state, step = importlib.import_module(
                f"{F.package}.train.checkpoint").restore_flat(ckpt)
            out[name]["ckpt"] = (step, state["r"])
    return out


def elastic_cases(F):
    """The port's ranks: every app, and its uninterrupted 1x1 run."""
    return _elastic(F, APPS, base=True)


def jax_elastic_pr_sv(F):
    return _elastic(F, APPS[:2], base=False)


def jax_elastic_mcl(F):
    return _elastic(F, APPS[2:], base=False)


def port_world(rank, module, funcs):
    """A rank's side: each ``module.func(Frame('repro_torch', grid))``."""
    mod = importlib.import_module(module)
    return {f: getattr(mod, f)(Frame("repro_torch", grid))
            for f, grid in funcs}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(CKPT_ENV, str(tmp_path_factory.mktemp("elastic")))
        # three JAX subprocesses beside the ranks: HipMCL's 2x2 iterations
        # compile a multiply a shape, the longest of them
        jax = [JaxReference(__name__, f, [GRID]) for f in
               ("regrid_cases", "jax_elastic_pr_sv", "jax_elastic_mcl")]
        port = run_ranks(port_world, 4, __name__,
                         [("regrid_cases", GRID), ("elastic_cases", GRID)])
    regrid, *apps = [j.result()[GRID] for j in jax]
    return port, regrid, {k: v for a in apps for k, v in a.items()}


@pytest.fixture(scope="module")
def eight():
    jax = JaxReference(__name__, "regrid3d_cases", [GRID3], devices=8)
    port = run_ranks(port_world, 8, __name__, [("regrid3d_cases", GRID3)])
    return [p["regrid3d_cases"] for p in port], jax.result()[GRID3]


def _positions(grid):
    return int(np.prod(grid))


def _check(got_ranks, want):
    """A regrid's results by rank against JAX's: None off the new grid;
    on it, the same grid, tag, cap and global COO (bitwise) on every rank,
    and the ranks' tile fields stacked are JAX's global fields."""
    n = _positions(want["grid"])
    assert [g is None for g in got_ranks] == \
        [rk >= n for rk in range(len(got_ranks))]
    held = got_ranks[:n]
    for g in held:
        for k in ("grid", "order", "cap", "dist"):
            assert g[k] == want[k], (k, g[k], want[k])
        for x, y in zip(g["coo"], want["coo"]):
            assert_same(x, y, exact=True)
    for f, w in want["fields"].items():
        assert_same(stack_shards([g["fields"][f] for g in held],
                                 want["grid"]), w, exact=True, what=f)


@pytest.mark.parametrize("case", REGRID2D)
def test_regrid_2d(four, case):
    port, jax, _ = four
    got = [p["regrid_cases"][case] for p in port]
    want = jax[case]
    if case == "cap":
        assert got[0] == want and got[1:] == [None] * 3
        shape, r, _, _ = _coo(seed=4)
        assert want[0] >= len(r) and want[1] == 4096
        return
    if case == "on_mesh":
        got = got[:1]                       # rank 0's 1x1 grid alone
    _check(got, want)
    if case == "shrink":
        _, r, c, v = _coo(seed=1)
        assert len(want["coo"][0]) == len(r)
    if case.startswith("order_"):
        assert want["order"] == case[6:]
    if case == "empty":
        assert int(want["fields"]["nnz"].sum()) == 0


@pytest.mark.parametrize("case", ["layer_shrink", "layer_grow",
                                  "dist_override"])
def test_regrid_3d(eight, case):
    port, jax = eight
    _check([p[case] for p in port], jax[case])
    assert jax[case]["dist"] == ("csub" if case == "dist_override"
                                 else "acol")


def test_subworld_grid_reaches_its_ranks_only(eight):
    port, _ = eight
    sub = [p["subworld"] for p in port]
    assert [s["member"] for s in sub] == [True] * 4 + [False] * 4
    assert [s["holds"] for s in sub] == [True] * 4 + [False] * 4
    assert all(s["groups"] == 0 for s in sub[4:])
    for rk, s in enumerate(sub[:4]):
        assert s["ranks"] == [0, 1, 2, 3]
        np.testing.assert_array_equal(s["gather"], [10, 11, 12, 13])
        assert s["sum"] == 46
        # rank r = (i, j) = divmod(r, 2): 'row' varies i, 'col' varies j
        i, j = divmod(rk, 2)
        assert s["row"] == (10 + j) + (12 + j)
        assert s["col"] == (10 + 2 * i) + (11 + 2 * i)


@pytest.mark.parametrize("app", APPS)
def test_elastic_app(four, app):
    port, _, jax = four
    got = [p["elastic_cases"][app] for p in port]
    want = jax[app]
    # HipMCL's state is global COO: only its mesh moves, no regrid
    assert want["topology"] == 1
    assert want["regrids"] == (0 if app == "hipmcl" else 1)
    for rk, g in enumerate(got):
        # every rank returns the same answer: JAX's live run's, bitwise,
        # and the uninterrupted 1x1 run's
        assert_same(g["live"], want["live"], exact=True,
                    what=f"{app} rank {rk}")
        assert_same(g["base"], want["live"], exact=True,
                    what=f"{app} 1x1 rank {rk}")
        assert g["topology"] == 1 and g["regrids"] == want["regrids"]
        # rank 0 ran every iteration; the others the three before the loss
        assert g["iters"] == (want["iters"] if rk == 0 else CRASH_AT - 1)
    assert want["iters"] > CRASH_AT
    if app == "pagerank":
        # saved after every iteration: on 1x1 after the loss, by rank 0
        step, r = got[0]["ckpt"]
        assert step == want["ckpt"][0] == want["iters"] - 1
        assert_same(r, want["ckpt"][1], exact=True)
    if app == "hipmcl":
        shape, r, c, v = _mcl_graph()
        ref, _, _ = chip_smoke.mcl_reference(
            sp.csr_matrix((v.astype(np.float64), (r, c)), shape=shape))
        assert chip_smoke.same_partition(want["live"], ref)
        assert 1 < len(np.unique(ref)) < MCL_PROTEINS
