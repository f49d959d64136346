"""The port's process grid at q > 1 against the JAX package's mesh.

The port runs as one gloo CPU rank a grid position (``torch_dist_parity.
run_ranks``); the JAX package runs the same case body on 4 forced XLA host
devices in a subprocess (``JaxReference``). Both build their operands from
the same seeded numpy arrays. Each rank's tiles, pieces and ``ok`` flags
are its shard of JAX's global array and are compared stacked; host values
(``to_global``, sums) must be the same on every rank. Index structure,
flags and every non-sum value are compared bitwise, float sums within
``SUM_RTOL``.

Covered here: the containers (assembly, extraction), ``core/comm.py``'s
collectives and groups, the matrix/vector ops, SpMV/SpMSpV, assign/extract
and SpMM, on 2x2 and, where the op allows a non-square grid, on 1x2 and
2x1 (a swapped 'row'/'col' axis shows there).
"""
import ast
from pathlib import Path

import numpy as np
import pytest

from torch_dist_parity import (JaxReference, compare, port_cases,
                               run_ranks)

N = 90                        # not a multiple of 4: pieces and tiles pad
K = 4                         # SpMM's dense columns
GRIDS = [(2, 2), (1, 2), (2, 1)]
SQUARE_ONLY = ("transpose", "spmv_iter", "spvec_layout", "spmm_2d")


def _matrix(seed=0, density=0.1):
    rng = np.random.default_rng(seed)
    dense = (rng.random((N, N)) < density) * rng.integers(1, 5, (N, N))
    r, c = np.nonzero(dense)
    return r.astype(np.int64), c.astype(np.int64), \
        dense[r, c].astype(np.float32)


def _updates(grid, cap=12, seed=3):
    """Per-position update lists (global ids with repeats, SENTINEL-padded)
    as the global (pr, pc, cap) arrays."""
    rng = np.random.default_rng(seed)
    pr, pc = grid
    gi = np.full((pr, pc, cap), 2**31 - 1, np.int32)
    gv = np.zeros((pr, pc, cap), np.int32)
    for i in range(pr):
        for j in range(pc):
            k = int(rng.integers(4, cap))
            gi[i, j, :k] = rng.integers(0, N, k)
            gv[i, j, :k] = rng.integers(0, 1000, k)
    return gi, gv


def grid_cases(F):
    """Every op of the slice on ``F.grid``, for both packages."""
    grid = F.grid
    pr, pc = grid
    square = pr == pc
    D, O, S, A, M, SR = F.dist, F.matops, F.spmv, F.assign, F.spmm, \
        F.semiring
    r, c, v = _matrix()
    out = {}
    a = D.DistSpMat.from_global_coo((N, N), r, c, v, grid, mesh=F.mesh)
    ac = D.DistSpMat.from_global_coo((N, N), r, c, v, grid, mesh=F.mesh,
                                     order="col", pad=1.5)
    out["assemble"] = dict(F.fields(a), col_order=F.fields(ac),
                           **{"g:tag": (a.order, ac.order, a.cap, ac.cap),
                              "g:coo": a.to_global_coo(),
                              "g:dense": a.to_dense(),
                              "g:nnz": int(F.call(O.mat_nnz, a)),
                              "g:total_nnz": int(a.total_nnz),
                              "g:sum": F.out(F.call(O.mat_sum, a))})
    rng = np.random.default_rng(1)
    x = rng.random(N).astype(np.float32)
    xv = {lay: D.DistVec.from_global(x, grid, layout=lay, mesh=F.mesh)
          for lay in ("col", "row")}
    sidx = np.sort(rng.choice(N, 17, replace=False))[::-1].copy()
    sval = rng.random(17).astype(np.float32)
    xs = D.DistSpVec.from_global(sidx, sval, N, grid, cap=16, layout="col",
                                 mesh=F.mesh)
    xsr = D.DistSpVec.from_global(sidx, sval, N, grid, cap=16, layout="row",
                                  mesh=F.mesh)
    out["vectors"] = {"col": F.fields(xv["col"]), "row": F.fields(xv["row"]),
                      "sp": F.fields(xs), "sprow": F.fields(xsr),
                      "g:col": xv["col"].to_global(),
                      "g:row": xv["row"].to_global(),
                      "g:sp": xs.to_global(),
                      "g:spdense": xs.to_global_dense(),
                      "g:vec_sum": F.out(F.call(O.vec_sum, xv["col"])),
                      "g:spvec_nnz": int(F.call(O.spvec_nnz, xs))}
    red = {}
    for axis in (0, 1):
        for mon in ("PLUS", "MIN", "MAX"):
            red[f"{mon}{axis}"] = F.fields(F.call(
                O.mat_reduce, a, axis=axis, add=getattr(SR, mon),
                mesh=F.mesh))
    red["scale_cols"] = F.fields(F.call(O.mat_scale_cols, a, xv["col"],
                                        mesh=F.mesh))
    red["scale_rows"] = F.fields(F.call(O.mat_scale_rows, a, xv["row"],
                                        mesh=F.mesh))
    red["lower"] = F.fields(F.call(O.mat_select_lower, a, mesh=F.mesh))
    red["lower_eq"] = F.fields(F.call(O.mat_select_lower, a, mesh=F.mesh,
                                      strict=False))
    out["matops"] = red
    sp = {}
    for variant in ("row", "col"):
        for name in ("ARITHMETIC", "MIN_PLUS", "MAX_MIN"):
            sp[f"{name}_{variant}"] = F.fields(F.call(
                S.spmv, a, xv["col"], sr=getattr(SR, name), mesh=F.mesh,
                variant=variant))
    out["spmv"] = sp
    ss = {}
    levels = D.DistVec.from_global(
        np.where(rng.random(N) < 0.3, 2, -1).astype(np.int32), grid,
        layout="row", mesh=F.mesh)
    vmask = F.mask.vector_mask(levels, pred=lambda lv: lv >= 0,
                               complement=True)
    # every local variant on 2x2; the exchanges alone on 1x2 and 2x1
    for variant in ("sort", "bucket", "spa") if square else ("sort",):
        for merge, name in (("sparse", "ARITHMETIC"), ("sparse", "MIN_PLUS"),
                            ("dense", "ARITHMETIC")):
            for masked in (False, True):
                y, ok = F.plan._spmspv_2d(
                    a, xs, getattr(SR, name), mesh=F.mesh, variant=variant,
                    merge=merge, prod_cap=512, out_cap=128,
                    mask=vmask if masked else None)
                ss[f"{variant}_{merge}_{name}_{masked}"] = dict(
                    F.fields(y), ok=F.out(ok))
    # an out_cap too small for a piece: the ok flags say so
    y, ok = F.plan._spmspv_2d(a, xs, SR.ARITHMETIC, mesh=F.mesh,
                              variant="sort", merge="sparse", prod_cap=512,
                              out_cap=8)
    ss["overflow"] = {"ok": F.out(ok)}
    out["spmspv"] = ss
    out["g:mask_allowed"] = F.mask.mask_allowed_count(vmask)
    asg = {}
    vids = D.DistVec.from_global(np.arange(N, dtype=np.int32)[::-1].copy(),
                                 grid, layout="col", mesh=F.mesh)
    gi, gv = _updates(grid)
    # distinct targets across the grid: an overwrite then has one writer
    gi_u = np.random.default_rng(4).choice(N, pr * pc * 3, replace=False) \
        .astype(np.int32).reshape(pr, pc, 3)
    gv_u = (gi_u * 7 + 1).astype(np.int32)
    for name, kw, (ui, uv) in (
            ("min_acc", dict(add=SR.MIN_INT, accumulate=True), (gi, gv)),
            ("max", dict(add=SR.MAX_INT), (gi, gv)),
            ("skew", dict(add=SR.MIN_INT, accumulate=True, skew_aware=True,
                          heavy_frac=0.1), (gi, gv)),
            ("overwrite", {}, (gi_u, gv_u)),
            ("tight", dict(add=SR.MIN_INT, route_cap=8), (gi, gv))):
        w, ok = F.call(A.assign, vids, F.shard(ui), F.shard(uv),
                       mesh=F.mesh, **kw)
        asg[name] = dict(F.fields(w), ok=F.out(ok))
    got, ok = F.call(A.extract, vids, F.shard(gi), mesh=F.mesh)
    asg["extract"] = {"vals": F.out(got), "ok": F.out(ok)}
    got, ok = F.call(A.extract, vids, F.shard(gi), mesh=F.mesh, route_cap=8)
    asg["extract_tight"] = {"ok": F.out(ok)}
    out["assign"] = asg
    X = rng.random((N, K)).astype(np.float32)
    xk = D.DistVec.from_global(X, grid, layout="col", mesh=F.mesh)
    out["spmm"] = {name: F.fields(F.call(M.spmm_15d, a, xk,
                                         sr=getattr(SR, name), mesh=F.mesh))
                   for name in ("ARITHMETIC", "MAX_PLUS")}
    if square:
        at = F.call(O.mat_transpose, a, mesh=F.mesh)
        out["transpose"] = dict(F.fields(at), **{"g:tag": at.order})
        out["spmv_iter"] = {
            "it": F.fields(F.call(S.spmv_iter, a, xv["col"],
                                  sr=SR.ARITHMETIC, mesh=F.mesh)),
            "layout": F.fields(F.call(S.transpose_layout, xv["row"],
                                      mesh=F.mesh))}
        out["spvec_layout"] = F.fields(F.call(S.transpose_spvec_layout,
                                              xsr, mesh=F.mesh))
        # X 2D-block distributed: position (i, j) holds row block j of X
        # restricted to k-panel i
        nb, kp = a.nb, K // pr
        Xp = np.zeros((nb * pc, K), np.float32)
        Xp[:N] = X
        blocks = np.stack([np.stack([Xp[j * nb:(j + 1) * nb,
                                        i * kp:(i + 1) * kp]
                                     for j in range(pc)]) for i in range(pr)])
        res = {}
        for name in ("ARITHMETIC", "MAX_PLUS"):
            if F.package == "repro":
                y = F.call(M.spmm_2d, a, F.shard(Xp), sr=getattr(SR, name),
                           mesh=F.mesh)
                y = F.out(y).reshape(pr, pc, -1, K)
            else:
                y = F.out(M.spmm_2d(a, F.shard(blocks)[0, 0],
                                    getattr(SR, name), mesh=F.mesh))[None,
                                                                     None]
            res[name] = y
        out["spmm_2d"] = res
    if F.package == "repro_torch":
        out["port:comm"] = _comm_checks(F)
    return out


def _comm_checks(F):
    """``core/comm.py`` on this rank: results the parent checks against
    numpy (there is no JAX counterpart to hold them against)."""
    import torch
    from repro_torch.core import comm
    g = comm.of(F.grid)
    me = torch.tensor([g.rank * 10 + 1, g.rank * 10 + 2], dtype=torch.int32)
    res = {"rank": g.rank, "ij": (g.i, g.j),
           "index": (g.index("row"), g.index("col"), g.index(comm.WORLD))}
    for ax in ("row", "col", comm.WORLD):
        name = ax if isinstance(ax, str) else "world"
        res[f"gather_{name}"] = comm.all_gather(me, g, ax).numpy()
        res[f"tiled_{name}"] = comm.all_gather(me, g, ax, tiled=True).numpy()
        res[f"psum_{name}"] = comm.psum(me.float() / 3, g, ax).numpy()
        n = g.size(ax)
        blk = torch.arange(2 * n, dtype=torch.float32) + 100 * g.rank
        res[f"scatter_{name}"] = comm.psum_scatter(blk, g, ax).numpy()
        res[f"a2a_{name}"] = comm.all_to_all(blk, g, ax).numpy()
        # three dtypes in one collective; entry t goes to member t
        pos = torch.arange(n)
        res[f"a2af_{name}"] = tuple(x.numpy() for x in comm.all_to_all_fields(
            (blk, (g.rank + pos) % 3 == 0, pos * 1000 + g.rank), g, ax))
        # a partial permutation: member 0 sends to member n-1 only
        res[f"perm_{name}"] = comm.ppermute(me, g, ax, [(0, n - 1)]).numpy()
        res[f"bcast_{name}"] = comm.broadcast(me, g, ax, n - 1).numpy()
        res[f"bool_{name}"] = comm.all_gather(
            torch.tensor([g.rank % 2 == 0]), g, ax).numpy()
    res["me_after"] = me.numpy()            # the broadcast left it alone
    cnt = g.rank + 1                        # uneven prefixes
    rows = torch.arange(8, dtype=torch.int32) + 100 * g.rank
    vals = torch.arange(8, dtype=torch.float64) / (g.rank + 1)
    counts, (R, V) = comm.gather_prefixes((rows, vals), cnt, F.grid)
    res["prefix"] = (counts, R, V)
    res["all_true"] = (F.dist.grid_all(torch.tensor(True), F.grid),
                       F.dist.grid_all(torch.tensor(g.rank != 1), F.grid))
    return res


@pytest.fixture(scope="module")
def results():
    jax = JaxReference(__name__, "grid_cases", GRIDS)
    port = {grid: run_ranks(port_cases, grid[0] * grid[1], grid, __name__,
                            "grid_cases")
            for grid in GRIDS}
    return port, jax.result()


CASES = [(grid, case) for grid in GRIDS
         for case in ("assemble", "vectors", "matops", "spmv", "spmspv",
                      "assign", "spmm", "g:mask_allowed") + SQUARE_ONLY
         if grid[0] == grid[1] or case not in SQUARE_ONLY]


@pytest.mark.parametrize("grid,case", CASES)
def test_port_equals_jax_on_the_grid(results, grid, case):
    port, jax = results
    ranks = [r[case] for r in port[grid]]
    want = jax[grid][case]
    if case.startswith("g:"):
        assert all(r == want for r in ranks), (ranks, want)
    else:
        compare([{"x": r} for r in ranks], {"x": want}, grid, what=case)


@pytest.mark.parametrize("grid", GRIDS)
def test_comm_collectives_and_groups(results, grid):
    """Axis 'col' varies j within process row i, axis 'row' varies i within
    process column j, as in JAX's mesh; every collective against numpy."""
    port, _ = results
    pr, pc = grid
    res = [r["port:comm"] for r in port[grid]]
    me = [np.array([r * 10 + 1, r * 10 + 2], np.int32) for r in range(pr * pc)]
    members = {"row": lambda r: [i * pc + r % pc for i in range(pr)],
               "col": lambda r: [(r // pc) * pc + j for j in range(pc)],
               "world": lambda r: list(range(pr * pc))}
    for rk, got in enumerate(res):
        assert got["rank"] == rk and got["ij"] == divmod(rk, pc)
        assert got["index"] == (rk // pc, rk % pc, rk)
        np.testing.assert_array_equal(got["me_after"], me[rk])
        for name, mem in members.items():
            ms = mem(rk)
            n = len(ms)
            np.testing.assert_array_equal(got[f"gather_{name}"],
                                          np.stack([me[m] for m in ms]))
            np.testing.assert_array_equal(got[f"tiled_{name}"],
                                          np.concatenate([me[m] for m in ms]))
            want = np.float32(0)
            want = me[ms[0]].astype(np.float32) / 3
            for m in ms[1:]:
                want = want + me[m].astype(np.float32) / 3
            np.testing.assert_array_equal(got[f"psum_{name}"], want)
            pos = ms.index(rk)
            blks = [np.arange(2 * n, dtype=np.float32) + 100 * m for m in ms]
            red = blks[0][2 * pos:2 * pos + 2]
            for b in blks[1:]:
                red = red + b[2 * pos:2 * pos + 2]
            np.testing.assert_array_equal(got[f"scatter_{name}"], red)
            a2a = np.concatenate([b[2 * pos:2 * pos + 2] for b in blks])
            np.testing.assert_array_equal(got[f"a2a_{name}"], a2a)
            f32, flags, i64 = got[f"a2af_{name}"]
            np.testing.assert_array_equal(f32, a2a)
            np.testing.assert_array_equal(flags,
                                          [(m + pos) % 3 == 0 for m in ms])
            np.testing.assert_array_equal(i64, [pos * 1000 + m for m in ms])
            assert (flags.dtype, i64.dtype) == (np.bool_, np.int64)
            perm = me[ms[0]] if (pos == n - 1) else np.zeros(2, np.int32)
            if n == 1:
                perm = me[rk]
            np.testing.assert_array_equal(got[f"perm_{name}"], perm)
            np.testing.assert_array_equal(got[f"bcast_{name}"], me[ms[-1]])
            np.testing.assert_array_equal(
                got[f"bool_{name}"].reshape(-1), [m % 2 == 0 for m in ms])
        counts, R, V = got["prefix"]
        np.testing.assert_array_equal(counts, np.arange(1, pr * pc + 1))
        for m in range(pr * pc):
            np.testing.assert_array_equal(
                R[m, :m + 1], np.arange(m + 1, dtype=np.int32) + 100 * m)
            np.testing.assert_array_equal(
                V[m, :m + 1], np.arange(m + 1, dtype=np.float64) / (m + 1))
        assert got["all_true"] == (True, False)


def test_one_by_one_grid_needs_no_process_group():
    """On 1x1 every collective is the identity and no world is needed."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import comm
    assert not dist.is_initialized()
    g = comm.of((1, 1))
    assert (g.pr, g.pc, g.rank, g.backend, g.groups) == (1, 1, 0, None, {})
    x = torch.arange(6, dtype=torch.float32)
    assert comm.all_gather(x, g, "row", tiled=True) is x
    assert comm.psum_scatter(x, g, "col") is x
    assert comm.all_to_all_fields((x,), g, "row")[0] is x
    assert comm.ppermute(x, g, comm.WORLD, [(0, 0)]) is x
    assert torch.equal(comm.all_gather(x, g, "col")[0], x)


def test_only_comm_imports_torch_distributed():
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    users = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            if any(n == "torch.distributed" or n.startswith(
                    "torch.distributed.") for n in names):
                users.append(path.relative_to(root).as_posix())
    assert sorted(set(users)) == ["core/comm.py"], users
