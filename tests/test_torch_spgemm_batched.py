"""The port's batched SpGEMM and int8 wire compression against the JAX
package's, on the 1x1 grid (in this process) and on 2x2 (four gloo CPU
ranks, ``torch_dist_parity``); the JAX package runs the same case bodies
in one subprocess with 4 forced XLA host devices, jitted.

Uncompressed products have small integer weights, so their sums are exact
and ``_restrict_cols`` and ``spgemm_2d_batched`` (nbatch 1, 2 and 3, the
last with uneven slabs) are held bitwise. With ``compress='int8'`` on
each schedule, C's index structure and ``ok`` flags are bitwise; its
values are sums of dequantized products, held within ``VAL_RTOL`` of the
largest |C| (the two packages add them in other orders, and XLA computes
the jitted scale as a multiply by 1/127). The int8 payload and the
error-feedback residual are held bitwise against the JAX package's
``quantize_payload`` run op by op, as the package runs it at the wire
boundary (outside ``shard_map``): under ``jit`` XLA contracts the
residual's multiply and subtract into one FMA, which the port, like the
JAX package run eagerly, does not. The port's overlap on and off must be
bitwise equal, ``compress=`` must refuse what JAX refuses with the same
``ValueError``, and ``plan.spgemm(compress='int8')`` must run.
"""
import numpy as np
import pytest

from torch_dist_parity import (JaxReference, assert_same, compare,
                               port_cases, run_ranks, stack_shards)

N = 96
GRIDS = ((1, 1), (2, 2))
PROD_CAP, OUT_CAP = 8192, 8192
VAL_RTOL = 1e-5           # of the largest |C|, for compressed values
SCHEDULES = {(1, 1): ("rotate", "alltoall", "bcast"),
             (2, 2): ("rotate", "alltoall", "bcast", ("gather", "bcast"))}
VARIANT = {"rotate": "rotation", "alltoall": "allgather", "bcast": "hybrid"}


def _graph(seed, real=False):
    """A random N x N matrix: small integer weights, or (``real``) values
    in [0.5, 1.5) that int8 cannot carry exactly."""
    rng = np.random.default_rng(seed)
    mask = rng.random((N, N)) < 0.08
    vals = (rng.random((N, N)) + 0.5) if real else rng.integers(1, 4, (N, N))
    dense = mask * vals
    r, c = np.nonzero(dense)
    return r.astype(np.int64), c.astype(np.int64), \
        dense[r, c].astype(np.float32)


def _sched_key(s):
    return "+".join(s) if isinstance(s, tuple) else s


def _variant(s):
    return "hybrid" if isinstance(s, tuple) else VARIANT[s]


def _spgemm_2d(F, a, b, sr, **kw):
    """``spgemm_2d``; in JAX under one jit a configuration."""
    if F.package == "repro":
        import torch_parity as tp
        return tp.jax_spgemm_2d(a, b, sr, **kw)
    return F.spgemm.spgemm_2d(a, b, sr, **kw)


def _zeros_like(F, x):
    if F.package == "repro":
        import jax.numpy as jnp
        return jnp.zeros_like(x)
    import torch
    return torch.zeros_like(x)


def batched_cases(F):
    out = {}
    grid = F.grid
    port = F.package == "repro_torch"
    D = F.dist.DistSpMat
    ARITH = F.semiring.ARITHMETIC
    a = D.from_global_coo((N, N), *_graph(0), grid, mesh=F.mesh)
    b = D.from_global_coo((N, N), *_graph(1), grid, mesh=F.mesh)
    base = dict(mesh=F.mesh, prod_cap=PROD_CAP, out_cap=OUT_CAP)
    # _restrict_cols: a slab at the start and one in the middle
    for lo, width in ((0, b.nb // 2), (b.nb // 3, b.nb // 3)):
        out[f"restrict/{lo}/{width}"] = F.fields(
            F.spgemm._restrict_cols(b, lo, width))
    # batched, uncompressed: nbatch 1, 2 and 3 (3 leaves a short slab)
    full, _ = _spgemm_2d(F, a, b, ARITH, **base)
    out["full"] = F.fields(full)
    for nbatch in (1, 2, 3):
        outs = F.call(F.spgemm.spgemm_2d_batched, a, b, sr=ARITH,
                      nbatch=nbatch, **base)
        out[f"batched/{nbatch}"] = {
            f"{t}": dict(F.fields(c), ok=F.out(ok))
            for t, (c, ok) in enumerate(outs)}
    # compressed, each schedule, with error feedback on
    ar = D.from_global_coo((N, N), *_graph(2, real=True), grid, mesh=F.mesh)
    br = D.from_global_coo((N, N), *_graph(3, real=True), grid, mesh=F.mesh)
    exact, _ = _spgemm_2d(F, ar, br, ARITH, **base)
    out["exact"] = F.fields(exact)
    q8, scale, resid = F.compression.quantize_payload(ar.val, ar.nnz)
    out["payload"] = {"q8": F.out(q8), "scale": F.out(scale),
                      "resid": F.out(resid)}
    for sched in SCHEDULES[grid]:
        kw = dict(base, variant=_variant(sched), schedule=sched,
                  compress="int8")
        c, ok, res = _spgemm_2d(F, ar, br, ARITH,
                                ef_resid=_zeros_like(F, ar.val), **kw)
        rec = dict(F.fields(c), ok=F.out(ok), resid=F.out(res))
        if port:
            c2, ok2, res2 = _spgemm_2d(F, ar, br, ARITH, overlap=False,
                                       ef_resid=_zeros_like(F, ar.val), **kw)
            rec["port:bulk"] = (F.fields(c2), F.out(ok2), F.out(res2))
        out[f"compress/{_sched_key(sched)}"] = rec
    # batched with compression: the batches' C, and A's residual carried
    # batch to batch, against JAX's quantize_payload chain
    nbatch = 3
    outs = F.call(F.spgemm.spgemm_2d_batched, ar, br, sr=ARITH,
                  nbatch=nbatch, compress="int8", **base)
    out["batched_int8"] = {f"{t}": dict(F.fields(c), ok=F.out(ok))
                           for t, (c, ok) in enumerate(outs)}
    if port:
        # the same loop by hand: each batch's residual as spgemm_2d hands
        # it on, and C as spgemm_2d_batched gave it
        slab = -(-br.nb // nbatch)
        resid = _zeros_like(F, ar.val)
        chain = {}
        for t in range(nbatch):
            bt = F.spgemm._restrict_cols(br, t * slab, slab)
            c, _, resid = F.spgemm.spgemm_2d(ar, bt, ARITH, compress="int8",
                                             ef_resid=resid, **base)
            chain[f"{t}"] = (F.out(resid), F.fields(c))
        out["port:chain"] = chain
    else:
        # the JAX package's residual chain, quantized op by op
        resid = _zeros_like(F, ar.val)
        chain = {}
        for t in range(nbatch):
            _, _, resid = F.compression.quantize_payload(ar.val, ar.nnz,
                                                         resid)
            chain[f"{t}"] = F.out(resid)
        out["chain"] = chain
    # what compress= refuses
    errs = {}
    ai = D.from_global_coo((N, N), *_graph(0)[:2],
                           np.ones(len(_graph(0)[0]), np.int32), grid,
                           mesh=F.mesh)
    for name, x, sr, kw in (
            ("ef_resid", ar, ARITH, dict(ef_resid=_zeros_like(F, ar.val))),
            ("mode", ar, ARITH, dict(compress="fp8")),
            ("floating", ai, ARITH, dict(compress="int8")),
            ("identity", ar, F.semiring.MIN_PLUS, dict(compress="int8"))):
        try:
            F.spgemm.spgemm_2d(x, x, sr, **base, **kw)
        except ValueError as e:
            errs[name] = str(e)
    out["errors"] = {"g:" + k: v for k, v in errs.items()}
    # the planner passes compress through
    c, p = F.plan.spgemm(ar, br, ARITH, mesh=F.mesh, compress="int8")
    out["planned"] = dict(F.fields(c), **{"g:compress": p.compress,
                                          "g:attempts": p.attempts})
    return out


@pytest.fixture(scope="module")
def results():
    jax = JaxReference(__name__, "batched_cases", GRIDS)
    port = {(1, 1): [port_cases(0, (1, 1), __name__, "batched_cases")],
            (2, 2): run_ranks(port_cases, 4, (2, 2), __name__,
                              "batched_cases")}
    return port, jax.result()


def _compressed_as_jax(port, want, grid, what):
    """Index structure and flags bitwise, values within VAL_RTOL of the
    largest |C|."""
    got = {f: stack_shards([r[f] for r in port], grid)
           for f in want if not f.startswith(("g:", "port:", "resid"))}
    for f in ("row", "col", "nnz", "ok"):
        if f in want:
            assert_same(got[f], want[f], True, f"{what}/{f}")
    scale = float(np.abs(want["val"]).max())
    assert got["val"].dtype == want["val"].dtype
    np.testing.assert_allclose(got["val"], want["val"], rtol=0,
                               atol=VAL_RTOL * scale, err_msg=what)


@pytest.mark.parametrize("grid", GRIDS)
def test_restrict_cols(results, grid):
    port, jax = results
    for key in (k for k in jax[grid] if k.startswith("restrict/")):
        compare([r[key] for r in port[grid]], jax[grid][key], grid,
                exact=True, what=key)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("nbatch", [1, 2, 3])
def test_batched_as_jax_and_union_is_c(results, grid, nbatch):
    port, jax = results
    key = f"batched/{nbatch}"
    want = jax[grid][key]
    assert len(want) == nbatch
    compare([r[key] for r in port[grid]], want, grid, exact=True, what=key)
    # the union of the batches' entries is the unbatched C
    full = jax[grid]["full"]
    n_full = full["nnz"].sum()
    assert sum(want[t]["nnz"].sum() for t in want) == n_full
    assert all(want[t]["ok"].all() for t in want)
    dense = {}
    for t in want:
        _add_entries(dense, want[t], grid)
    ref = {}
    _add_entries(ref, full, grid)
    assert dense == ref


def _add_entries(acc, f, grid):
    cells = int(np.prod(grid))
    row = f["row"].reshape(cells, -1)
    col = f["col"].reshape(cells, -1)
    val = f["val"].reshape(cells, -1)
    nnz = f["nnz"].reshape(cells)
    for t in range(cells):
        for k in range(int(nnz[t])):
            key = (t, int(row[t, k]), int(col[t, k]))
            assert key not in acc
            acc[key] = float(val[t, k])


@pytest.mark.parametrize("grid", GRIDS)
def test_payload_bitwise_as_jax(results, grid):
    port, jax = results
    want = jax[grid]["payload"]
    for f in ("q8", "scale", "resid"):
        got = stack_shards([r["payload"][f] for r in port[grid]], grid)
        assert_same(got, want[f], True, f)
        assert got.view(np.uint8).tobytes() == want[f].view(np.uint8) \
            .tobytes(), f
    # padding quantizes to exact 0
    nnz = jax[grid]["exact"]["nnz"]
    cap = want["q8"].shape[-1]
    pad = np.arange(cap) >= nnz[..., None]
    assert not want["q8"][pad].any() and not want["resid"][pad].any()


@pytest.mark.parametrize("grid,sched",
                         [(g, s) for g in GRIDS for s in SCHEDULES[g]],
                         ids=[f"{g[0]}x{g[1]}-{_sched_key(s)}"
                              for g in GRIDS for s in SCHEDULES[g]])
def test_compressed_spgemm_as_jax(results, grid, sched):
    port, jax = results
    key = f"compress/{_sched_key(sched)}"
    want = jax[grid][key]
    assert want["ok"].all()
    ranks = [r[key] for r in port[grid]]
    _compressed_as_jax(ranks, want, grid, key)
    # the residual handed back is A's, bitwise as JAX quantizes it
    got = stack_shards([r["resid"] for r in ranks], grid)
    assert_same(got, jax[grid]["payload"]["resid"], True, "resid")
    # compression is not a silent no-op, and stays within JAX's own bound
    # (tests/dist_overlap_scenarios.py): 2 (vmax/254) vmax (k + 1), k the
    # most terms an entry of C sums (A's fullest row)
    exact = jax[grid]["exact"]
    err = np.abs(stack_shards([r["val"] for r in ranks], grid)
                 - exact["val"]).max()
    k = np.bincount(_graph(2, real=True)[0], minlength=N).max()
    assert 0 < err <= 2 * (1.5 / 254) * 1.5 * (k + 1)
    # overlap on and off: bitwise equal
    for r in ranks:
        fields, ok, res = r["port:bulk"]
        np.testing.assert_array_equal(ok, r["ok"])
        np.testing.assert_array_equal(res, r["resid"])
        for f, arr in fields.items():
            np.testing.assert_array_equal(arr, r[f], err_msg=f)


@pytest.mark.parametrize("grid", GRIDS)
def test_batched_compressed_with_error_feedback(results, grid):
    port, jax = results
    want = jax[grid]["batched_int8"]
    for t in want:
        _compressed_as_jax([r["batched_int8"][t] for r in port[grid]],
                           want[t], grid, f"batched_int8/{t}")
        # A's residual after batch t, bitwise as JAX's chain
        got = stack_shards([r["port:chain"][t][0] for r in port[grid]],
                           grid)
        assert_same(got, jax[grid]["chain"][t], True, f"resid {t}")
        # the loop by hand gives spgemm_2d_batched's C bitwise
        for r in port[grid]:
            for f, arr in r["port:chain"][t][1].items():
                np.testing.assert_array_equal(arr, r["batched_int8"][t][f])
    # the residual moves batch to batch (error feedback is on)
    assert not np.array_equal(jax[grid]["chain"]["0"],
                              jax[grid]["chain"]["1"])


@pytest.mark.parametrize("grid", GRIDS)
def test_compress_refuses_as_jax(results, grid):
    port, jax = results
    want = jax[grid]["errors"]
    assert set(want) == {"g:ef_resid", "g:mode", "g:floating", "g:identity"}
    for r in port[grid]:
        assert r["errors"] == want


@pytest.mark.parametrize("grid", GRIDS)
def test_planned_compressed_spgemm(results, grid):
    port, jax = results
    want = jax[grid]["planned"]
    assert want["g:compress"] == "int8"
    for r in port[grid]:
        assert r["planned"]["g:compress"] == "int8"
        assert r["planned"]["g:attempts"] == want["g:attempts"]
    _compressed_as_jax([r["planned"] for r in port[grid]], want, grid,
                       "planned")
