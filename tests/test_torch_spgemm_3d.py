"""The port's 3D communication-avoiding SpGEMM against the JAX package's.

Eight gloo CPU ranks run the port on a 2x2x2 grid and four on a 4x1x1
grid (``torch_dist_parity``); the JAX package runs the same case bodies on
8 forced XLA host devices, each ``spgemm_3d`` configuration under one jit.
Weights are small integers, so every sum is exact and the comparison is
bitwise: ``DistSpMat3D``'s fields for the 'acol', 'brow' and 'csub'
distributions and its ``to_global_coo``, then C3's fields, order tag and
``ok`` flags over the merges (sort, deferred, incremental) x schedules
(rotate, alltoall, bcast), unmasked, with a structural ``mat3`` mask, its
complement, a ``pred`` on the mask's values and a ``value_mask``, and one
case whose inter-layer pieces overflow their ``cap_l`` slots. The port
runs each with ``overlap`` on and off, and the two must be bitwise equal.
"""
import numpy as np
import pytest

from torch_dist_parity import (JaxReference, compare, port_cases,
                               run_ranks, stack_shards)

N = 80
GRIDS = ((2, 2, 2), (4, 1, 1))
PROD_CAP, OUT_CAP = 2048, 1024
# (schedule, merge, mask) by grid: no full cross, one jit a configuration
CASES = {
    (2, 2, 2): (("rotate", "deferred", "none"),
                ("rotate", "sort", "structural"),
                ("rotate", "incremental", "complement"),
                ("alltoall", "deferred", "structural"),
                ("alltoall", "incremental", "none"),
                ("bcast", "sort", "complement"),
                ("bcast", "deferred", "value"),
                ("rotate", "deferred", "overflow")),
    (4, 1, 1): (("rotate", "deferred", "pred"),
                ("alltoall", "sort", "none"),
                ("bcast", "incremental", "complement"),
                ("rotate", "incremental", "structural")),
}
VARIANT = {"rotate": "rotation", "alltoall": "allgather", "bcast": "hybrid"}


def _entries(seed, density, col_keep=None):
    """Random N x N entries with small integer weights; ``col_keep`` keeps
    only the columns where it is True."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((N, N)) < density) * rng.integers(1, 4, (N, N))
    if col_keep is not None:
        dense = dense * col_keep[None, :]
    r, c = np.nonzero(dense)
    return r.astype(np.int64), c.astype(np.int64), \
        dense[r, c].astype(np.float32), dense


def _overflow_operands(grid):
    """B whose columns all lie in sub-block 0 of their column block: every
    entry of a layer's partial C goes to layer 0, so with a prod_cap that
    holds each layer's stages and partial C, the pieces for layer 0 need
    more than cap_l = prod_cap // L slots. Returns (B's entries, prod_cap,
    the largest stage product count and partial nnz of a rank)."""
    L, q, _ = grid
    tile = -(-N // (L * q * q)) * (L * q * q)
    kbl = tile // (L * q)
    cols = np.arange(N)
    rb, cb, vb, db = _entries(2, 0.1, (cols % (kbl * L)) < kbl)
    _, _, _, da = _entries(1, 0.1)
    tr = tile // q                            # A's and C's tile rows
    sl = tile // L                            # one layer's contraction slab
    tk = sl // q                              # one stage's contraction
    flops, part = 0, 0
    for l in range(L):
        for i in range(q):
            for j in range(q):
                a = da[i * tr:(i + 1) * tr, l * sl:(l + 1) * sl] != 0
                b = db[l * sl:(l + 1) * sl, j * (tile // q):
                       (j + 1) * (tile // q)] != 0
                part = max(part, int(((a.astype(np.int64) @ b) > 0).sum()))
                for k in range(q):
                    fa = a[:, k * tk:(k + 1) * tk].sum(axis=0)
                    fb = b[k * tk:(k + 1) * tk].sum(axis=1)
                    flops = max(flops, int(fa @ fb))
    prod_cap = -(-max(flops, part) // (8 * L)) * 8 * L
    return (rb, cb, vb), prod_cap, flops, part


def spgemm3d_cases(F):
    out = {}
    grid = F.grid
    L, q, _ = grid
    port = F.package == "repro_torch"
    ra, ca, va, _ = _entries(1, 0.1)
    rb, cb, vb, _ = _entries(2, 0.1)
    D3 = F.dist.DistSpMat3D
    a3 = D3.from_global_coo((N, N), ra, ca, va, grid, "acol", mesh=F.mesh)
    b3 = D3.from_global_coo((N, N), rb, cb, vb, grid, "brow", mesh=F.mesh)
    # the mask: A's pattern, C-distributed; random_permute on one of the
    # assemblies so the permutation's path runs too
    m3 = D3.from_global_coo((N, N), ra, ca, va, grid, "csub", mesh=F.mesh)
    p3 = D3.from_global_coo((N, N), ra, ca, va, grid, "csub", mesh=F.mesh,
                            random_permute=True, seed=3)
    for name, m in (("acol", a3), ("brow", b3), ("csub", m3),
                    ("csub_permuted", p3)):
        r, c, v = m.to_global_coo()
        out[f"assembly/{name}"] = dict(
            F.fields(m), **{"g:cap": m.cap, "g:tag": m.order,
                            "g:blocks": tuple(m.block_sizes()),
                            "g:coo": (r, c, v)})
    masks = {"none": None, "structural": F.mask.structural(m3),
             "complement": F.mask.complement_of(m3),
             "pred": F.mask.structural(m3, pred=_odd, val_pred=_above_one),
             "value": F.mask.value_mask(_above_one), "overflow": None}
    for sched, merge, m in CASES[grid]:
        kw = dict(mesh=F.mesh, prod_cap=PROD_CAP, out_cap=OUT_CAP,
                  merge=merge, variant=VARIANT[sched], schedule=sched,
                  mask=masks[m])
        x, y = a3, b3
        if m == "overflow":
            (ro, co, vo), kw["prod_cap"], _, _ = _overflow_operands(grid)
            y = D3.from_global_coo((N, N), ro, co, vo, grid, "brow",
                                   mesh=F.mesh)
        c3, ok = _spgemm_3d(F, x, y, kw)
        res = dict(F.fields(c3), ok=F.out(ok),
                   **{"g:tag": c3.order, "g:dist": c3.dist})
        if port:
            c2, ok2 = _spgemm_3d(F, x, y, dict(kw, overlap=False))
            res["port:bulk"] = (F.fields(c2), F.out(ok2))
        out[f"{sched}/{merge}/{m}"] = res
    if port:
        out["port:errors"] = _port_errors(F, a3, b3, m3)
    return out


def _odd(v):
    """A mask ``pred`` over the mask's values: odd weights count."""
    return v % 2 == 1


def _above_one(v):
    """A ``val_pred`` over C's values."""
    return v > 1


def _spgemm_3d(F, a3, b3, kw):
    """``spgemm_3d``; in JAX under one jit a configuration."""
    if F.package == "repro":
        import torch_parity as tp
        return tp.jax_spgemm_3d(a3, b3, F.semiring.ARITHMETIC, **kw)
    return F.spgemm.spgemm_3d(a3, b3, F.semiring.ARITHMETIC, **kw)


def _port_errors(F, a3, b3, m3):
    """What the port refuses, as the words of each error."""
    errs = {}
    kw = dict(mesh=F.mesh, prod_cap=PROD_CAP, out_cap=OUT_CAP)
    L, q, _ = F.grid
    if F.grid == (2, 2, 2):
        # a 2D mask operand (a DistSpMat on the 2x4 grid of the same world)
        a2 = F.dist.DistSpMat.from_global_coo((N, N), [0], [1], [1.0],
                                              (2, 4), device="cpu")
        try:
            F.spgemm.spgemm_3d(a3, b3, mask=F.mask.structural(a2), **kw)
        except ValueError as e:
            errs["mask2d"] = str(e)
        # B on another grid of the same world
        b8 = F.dist.DistSpMat3D.from_global_coo(
            (N, N), [0], [1], np.ones(1, np.float32), (8, 1, 1), "brow",
            device="cpu")
        try:
            F.spgemm.spgemm_3d(a3, b8, **kw)
        except ValueError as e:
            errs["grids"] = str(e)
    try:                                # a grid larger than the world
        m3.regrid((2 * L, q, q), mesh=F.mesh)
    except RuntimeError as e:
        errs["regrid"] = str(e)
    return errs


@pytest.fixture(scope="module")
def results():
    jax = JaxReference(__name__, "spgemm3d_cases", GRIDS, devices=8)
    port = {g: run_ranks(port_cases, g[0] * g[1] * g[2], g, __name__,
                         "spgemm3d_cases") for g in GRIDS}
    return port, jax.result()


def _case_ids():
    return [(g, c) for g in GRIDS for c in CASES[g]]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dist", ["acol", "brow", "csub", "csub_permuted"])
def test_assembly_and_round_trip(results, grid, dist):
    port, jax = results
    key = f"assembly/{dist}"
    compare([r[key] for r in port[grid]], jax[grid][key], grid, exact=True,
            what=key)
    # to_global_coo gives back the assembled entries (sorted tile by tile)
    r, c, v = jax[grid][key]["g:coo"]
    if dist != "csub_permuted":
        seed = 2 if dist == "brow" else 1
        ra, ca, va, _ = _entries(seed, 0.1)
        got = np.lexsort((c, r))
        want = np.lexsort((ca, ra))
        np.testing.assert_array_equal(r[got], ra[want])
        np.testing.assert_array_equal(c[got], ca[want])
        np.testing.assert_array_equal(v[got], va[want])


@pytest.mark.parametrize("grid,case", _case_ids(),
                         ids=[f"{g[0]}x{g[1]}x{g[2]}-{'/'.join(c)}"
                              for g, c in _case_ids()])
def test_spgemm_3d_as_jax(results, grid, case):
    port, jax = results
    key = "/".join(case)
    want = jax[grid][key]
    assert want["g:dist"] == "csub" and want["g:tag"] == "row"
    if case[2] == "overflow":
        _, prod_cap, flops, part = _overflow_operands(grid)
        # each layer's stages and partial C fit prod_cap: only the pieces
        # for one layer overflow their cap_l = prod_cap // L slots
        assert flops <= prod_cap and part <= prod_cap
        assert part > prod_cap // grid[0]
        assert not want["ok"].all()
    else:
        assert want["ok"].all(), "the caps must hold the product"
    compare([r[key] for r in port[grid]], want, grid, exact=True, what=key)


@pytest.mark.parametrize("grid,case", _case_ids(),
                         ids=[f"{g[0]}x{g[1]}x{g[2]}-{'/'.join(c)}"
                              for g, c in _case_ids()])
def test_overlap_on_and_off_are_bitwise_equal(results, grid, case):
    port, _ = results
    key = "/".join(case)
    for r in port[grid]:
        fields, ok = r[key]["port:bulk"]
        np.testing.assert_array_equal(ok, r[key]["ok"])
        for f, arr in fields.items():
            np.testing.assert_array_equal(arr, r[key][f], err_msg=f)


def test_masked_product_equals_the_dense_oracle(results):
    """C3 of the structural case, assembled on the host, is (A @ B) .* A."""
    port, _ = results
    grid = (2, 2, 2)
    _, _, _, da = _entries(1, 0.1)
    _, _, _, db = _entries(2, 0.1)
    want = (da @ db) * (da != 0)
    r = port[grid][0]["rotate/sort/structural"]
    shards = [x["rotate/sort/structural"] for x in port[grid]]
    R = stack_shards([s["row"] for s in shards], grid)
    C = stack_shards([s["col"] for s in shards], grid)
    V = stack_shards([s["val"] for s in shards], grid)
    Z = stack_shards([s["nnz"] for s in shards], grid)
    L, q, _ = grid
    tr = -(-N // (L * q * q)) * (L * q * q) // q
    tc = tr // L
    got = np.zeros((tr * q, tr * q), np.float32)
    for l in range(L):
        for i in range(q):
            for j in range(q):
                k = int(Z[l, i, j])
                got[R[l, i, j, :k] + i * tr,
                    C[l, i, j, :k] + j * tc * L + l * tc] = V[l, i, j, :k]
    np.testing.assert_array_equal(got[:N, :N], want.astype(np.float32))
    assert r["ok"].all()


def test_refusals(results):
    port, _ = results
    errs = port[(2, 2, 2)][0]["port:errors"]
    assert "MaskSpec.mat3" in errs["mask2d"]
    assert "different grids" in errs["grids"]
    for grid in GRIDS:
        assert "needs a world of at least" in \
            port[grid][0]["port:errors"]["regrid"]
