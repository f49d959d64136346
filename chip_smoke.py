"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. setup: the card's name and power limit, the torch and CUDA versions, the
   kernels' build time (nvcc, from the sources in this checkout);
2. kernel vs plain: every hand-written kernel against its plain PyTorch
   version on the card, over tags, dtypes, id orders and sizes, with times;
3. main path: masked triangle counting of an R-MAT graph (Graph500
   parameters, scale 15, edge factor 16, seed 0) through
   ``DistSpMat.from_global_coo`` -> ``triangle_count`` -> planner ->
   ``spgemm_2d`` on a 1x1 grid, held against scipy.

The two lines before the last are a JSON object with one record per kernel
and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (the bound is stated against these)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

RMAT_SCALE, RMAT_EDGE_FACTOR, RMAT_SEED = 15, 16, 0
EXPECTED_TRIANGLES = 6_688_911


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# phase 1: setup
# --------------------------------------------------------------------------

def setup() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load("segreduce")
    info = _build.build_info["segreduce"]
    log(f"build segreduce: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
            log("  ptxas:", line.strip())
    return smi.splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: segreduce kernel vs plain
# --------------------------------------------------------------------------

def _segreduce_inputs(n, s, dtype, ids_kind, seed, vdims=()):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if ids_kind == "oor":               # ~10% ids outside [0, s), unsorted
        ids = torch.randint(-s // 8 - 1, s + s // 8 + 1, (n,), generator=g,
                            device="cuda", dtype=torch.int32)
    else:
        ids = torch.randint(0, s, (n,), generator=g, device="cuda",
                            dtype=torch.int32)
        if ids_kind == "sorted":
            ids = torch.sort(ids).values
    shape = (n,) + tuple(vdims)
    if dtype == torch.bool:
        vals = torch.rand(shape, generator=g, device="cuda") < 0.5
    elif dtype.is_floating_point:
        vals = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    else:
        vals = torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             device="cuda", dtype=torch.int64).to(dtype)
    return vals, ids


def _compare(got, want, vals, ids, s, tag):
    """Max abs error; raises unless exact (ints, bools, min/max) or, for a
    float sum, within the bound of any summation order: two orders of a
    segment with c values differ by at most 2(c-1)u*sum|v| (u = 2^-24 for
    f32, 2^-53 for f64), and a segment of one value is exact."""
    from repro_torch.kernels.segreduce import segment_reduce_plain
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    if tag != "sum" or not got.dtype.is_floating_point:
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{bad} segments differ")
        return 0.0
    err = (got.double() - want.double()).abs()
    u = 2.0 ** -24 if got.dtype == torch.float32 else 2.0 ** -53
    count = segment_reduce_plain(torch.ones_like(ids), ids, s, "sum").double()
    count = count.reshape((-1,) + (1,) * (got.dim() - 1))
    abssum = segment_reduce_plain(vals.abs(), ids, s, "sum").double()
    tol = 2.0 * (count - 1).clamp(min=0) * u * abssum
    if not bool((err <= tol).all()):
        raise AssertionError(f"f32 sum beyond order bound: max err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def check_segreduce() -> dict:
    from repro_torch.kernels import segreduce
    from repro_torch.kernels.segreduce import segment_reduce_plain

    max_err = 0.0
    cases = []
    # (n, s, dtype, tag, ids kind, identity, value dims)
    for dtype in (torch.float32, torch.int32, torch.bool, torch.float64,
                  torch.int64):
        for tag in ("sum", "min", "max"):      # a bool sum is a logical or
            for ids_kind in ("sorted", "unsorted", "oor"):
                for n, s in ((8, 8), (1000, 300), (300, 1), (4096, 1 << 16),
                             (1 << 20, 1 << 20)):
                    cases.append((n, s, dtype, tag, ids_kind, None, ()))
    # the main path's shapes: f32 sums over N = S = 2^22 and 2^24
    for n in (1 << 22, 1 << 24):
        cases.append((n, n, torch.float32, "sum", "sorted", None, ()))
    # declared identities that differ from the dtype extreme: MAX_INT / MIN_INT
    # over untouched segments, and touched values below MAX_INT's identity
    cases.append((1000, 5000, torch.int32, "max", "unsorted", -(2**31) + 1, ()))
    cases.append((1000, 5000, torch.int32, "min", "unsorted", 2**31 - 1, ()))
    cases.append((1000, 5000, torch.float32, "min", "oor", float("inf"), ()))
    cases.append((1000, 5000, torch.bool, "max", "oor", False, ()))
    # vector values: rows of D elements, one touch per row
    for dtype, tag, ident in ((torch.float32, "sum", None),
                              (torch.float32, "max", -float("inf")),
                              (torch.int32, "min", 2**31 - 1),
                              (torch.bool, "sum", None)):
        for vdims in ((3,), (2, 5)):
            cases.append((1 << 16, 1 << 12, dtype, tag, "oor", ident, vdims))
    for i, (n, s, dtype, tag, ids_kind, ident, vdims) in enumerate(cases):
        vals, ids = _segreduce_inputs(n, s, dtype, ids_kind, seed=i,
                                      vdims=vdims)
        if ident == -(2**31) + 1:
            vals[:4] = -(2**31)              # below the declared identity
        if i % 7 == 0:
            ids = ids.long()                 # int64 ids (narrowed by the wrapper)
        got = segreduce.segment_reduce(vals, ids, s, tag, identity=ident)
        want = segment_reduce_plain(vals, ids, s, tag, identity=ident)
        torch.cuda.synchronize()
        try:
            err = _compare(got, want, vals, ids, s, tag)
        except AssertionError as e:
            raise AssertionError(f"segreduce n={n} s={s} {dtype} {tag} "
                                 f"{ids_kind} identity={ident} vdims={vdims}: "
                                 f"{e}") from e
        max_err = max(max_err, err)
    log(f"segreduce: {len(cases)} cases match the plain version "
        f"(max abs err of f32/f64 sums {max_err:.3g})")

    # times at the main path's largest shape: N = S = 2^24, f32 sum,
    # sorted ids (the merge engine's run ids)
    n = s = 1 << 24
    vals, ids = _segreduce_inputs(n, s, torch.float32, "sorted", seed=99)
    got = segreduce.segment_reduce(vals, ids, s, "sum")
    want = segment_reduce_plain(vals, ids, s, "sum")
    err_main = _compare(got, want, vals, ids, s, "sum")
    ms = cuda_time_ms(lambda: segreduce.segment_reduce(vals, ids, s, "sum"),
                      iters=50)
    plain_ms = cuda_time_ms(lambda: segment_reduce_plain(vals, ids, s, "sum"),
                            iters=20)
    ids64 = ids.long()
    out = torch.zeros(s, dtype=torch.float32, device="cuda")
    library_ms = cuda_time_ms(
        lambda: out.scatter_reduce_(0, ids64, vals, "sum", include_self=False),
        iters=50)
    # least time: each input read once (value + id), each output written
    # once (out; a sum keeps no touch count); one add per input at the f32
    # peak
    nbytes = n * (4 + 4) + s * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n / F32_FLOPS * 1e3
    log(f"segreduce N=S=2^24 f32 sum sorted: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scatter_reduce_ {library_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e9:.3f} GB)")
    return {"name": "segreduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segreduce.cu",
            "replaces": "src/repro/kernels/segreduce.py:88",
            "launches": None, "max_abs_err": max(max_err, err_main),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# --------------------------------------------------------------------------
# phase 3: main path (masked triangle counting, R-MAT scale 15, 1x1 grid)
# --------------------------------------------------------------------------

def scipy_reference(shape, rows, cols):
    """Independent answer: the permutation of from_global_coo(seed=0)
    applied by hand, L = strict lower triangle, C = (L @ L) .* L."""
    import scipy.sparse as sp
    n = shape[0]
    rp = np.random.default_rng(0).permutation(n).astype(np.int64)
    r, c = rp[rows], rp[cols]
    a = sp.csr_matrix((np.ones(len(r), np.float32), (r, c)), shape=shape)
    low = sp.tril(a, k=-1).tocsr()
    cm = (low @ low).multiply(low).tocoo()
    cm.eliminate_zeros()
    return cm


def main_path() -> int:
    from repro_torch.apps.tricount import triangle_count
    from repro_torch.core.dist import DistSpMat, make_grid
    from repro_torch.core.mask import structural
    from repro_torch.core.matops import mat_apply_local, mat_select_lower
    from repro_torch.core.plan import spgemm
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.io.rmat import rmat_coo
    from repro_torch.kernels import segreduce
    from repro_torch.obs import recorder

    t0 = time.perf_counter()
    shape, rows, cols, vals = rmat_coo(RMAT_SCALE, RMAT_EDGE_FACTOR,
                                       seed=RMAT_SEED, symmetrize=True,
                                       drop_self_loops=True)
    mesh = make_grid(1, 1, device="cuda")
    a = DistSpMat.from_global_coo(shape, rows, cols, vals, (1, 1), mesh=mesh,
                                  random_permute=True)
    log(f"R-MAT scale {RMAT_SCALE} ef {RMAT_EDGE_FACTOR}: {shape[0]} vertices, "
        f"nnz(A) {len(rows)}, cap {a.cap}; assembly "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ref = scipy_reference(shape, rows, cols)
    ref_count = int(ref.sum())
    log(f"scipy: {ref_count} triangles, nnz(C) {ref.nnz}, max entry "
        f"{ref.data.max():.0f} ({time.perf_counter() - t0:.2f} s)")
    if ref_count != EXPECTED_TRIANGLES:
        raise AssertionError(f"scipy count {ref_count} != {EXPECTED_TRIANGLES}")

    t0 = time.perf_counter()
    cold = triangle_count(a, mesh=mesh)
    torch.cuda.synchronize()
    log(f"tricount cold: {cold} ({time.perf_counter() - t0:.3f} s)")

    # the main path: one warm call with the recorder off, timed on the
    # host clock, its launches counted from 0
    torch.cuda.reset_peak_memory_stats()
    segreduce.launches = 0
    t0 = time.perf_counter()
    count = triangle_count(a, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segreduce.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"tricount warm: {count} triangles, {wall:.4f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB, segreduce launches {launches}")
    # plan and spans from a separate recorded call (recording synchronizes
    # at each spgemm2d.execute span, so its times are not the wall above)
    with recorder.capture() as rec:
        recorded = triangle_count(a, mesh=mesh)
        plans = rec.events("plan.spgemm") + rec.events("plan.spgemm.done")
        snap = rec.snapshot()
    for p in plans:
        log(f"  {p['name']}: prod_cap {p['prod_cap']} out_cap {p['out_cap']} "
            f"variant {p['variant']} merge {p['merge']} "
            f"attempts {p['attempts']}")
    for site in ("tricount", "plan.spgemm", "spgemm2d", "spgemm2d.execute",
                 "merge.dedup", "merge.sort"):
        st = snap["spans"].get(site)
        if st:
            log(f"  span {site} (recorded call): n={st['count']} total "
                f"{st['total_us'] / 1e3:.3f} ms")
    if recorded != count:
        raise AssertionError(f"recorded call counted {recorded}, not {count}")
    if count != ref_count:
        raise AssertionError(f"triangle_count {count} != scipy {ref_count}")
    if launches <= 0:
        raise AssertionError("the main path launched no segreduce kernel")

    # C itself, entry by entry, against scipy under the same permutation
    ones = lambda t: t.apply(lambda v: torch.ones_like(v))
    low = mat_select_lower(mat_apply_local(a, ones, mesh=mesh), mesh=mesh)
    c, plan = spgemm(low, low, ARITHMETIC, mesh=mesh, mask=structural(low))
    cr, cc, cv = c.to_global_coo()
    got = np.lexsort((cc, cr))
    want = np.lexsort((ref.col, ref.row))
    if not (np.array_equal(cr[got], ref.row[want].astype(np.int64))
            and np.array_equal(cc[got], ref.col[want].astype(np.int64))
            and np.array_equal(cv[got].view(np.uint32),
                               ref.data[want].astype(np.float32)
                               .view(np.uint32))):
        raise AssertionError("C differs from scipy's (L @ L) .* L")
    log(f"C: {len(cr)} entries bitwise equal to scipy's, max {cv.max():.0f}; "
        f"plan attempts {plan.attempts}")
    profile_breakdown(lambda: triangle_count(a, mesh=mesh))
    return launches


def profile_breakdown(fn, top: int = 10) -> None:
    """Device time of one call by PyTorch operator (torch.profiler), the
    port's own kernels, and the share of the call's wall time the device
    was busy (kernels of one stream do not overlap, so their summed time is
    the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = prof.key_averages()
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    log(f"profile (one profiled call): wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%)")
    ops = sorted(((e.self_device_time_total, e.count, e.key) for e in evs
                  if e.device_type != DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    own = [(e.self_device_time_total, e.count, e.key) for e in kernels
           if "segreduce" in e.key]
    for us, n, name in ops[:top] + own:
        log(f"  {us / 1e3:9.3f} ms {n:5d}x  {name[:80]}")


def main() -> int:
    smi = setup()
    record = check_segreduce()
    record["launches"] = main_path()
    log(json.dumps({"kernels": [record]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
