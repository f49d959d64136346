"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. setup: the card's name and power limit, the torch and CUDA versions, the
   kernels' build times (one nvcc per source, all started together, from
   the sources in this checkout);
2. segreduce vs plain: the segmented-reduce kernel against its plain
   PyTorch version on the card, over tags, dtypes, id orders and sizes;
2b. semiring_matmul vs plain: the dense-tile kernel against its plain
   version over its four algebras and types, ragged shapes and NaN/inf,
   with times at 2048^3 beside the bound and torch.matmul;
3. tricount: masked triangle counting of an R-MAT graph (Graph500
   parameters, scale 15, edge factor 16, seed 0) through
   ``DistSpMat.from_global_coo`` -> ``triangle_count`` -> planner ->
   ``spgemm_2d`` on a 1x1 grid, held against scipy;
4. dense local SpGEMM: ``plan_local_spgemm`` -> ``spgemm_auto`` ->
   ``spgemm_dense`` on R-MAT scale 11, edge factor 64 (a 2048 x 2048 tile,
   the dense accumulator's largest) under four semirings, held against
   scipy, the port's ESC path and the plain oracle;
5. local SpMV/SpMSpV on phase 3's tile: ``spmv_row``/``spmv_col`` and
   ``plan_local_spmspv`` -> ``spmspv_auto`` at three frontier densities,
   held against scipy.

The two lines before the last are a JSON object with one record per kernel
and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# phase 4: the dense accumulator's full width (m * n = dense_tile_limit)
DENSE_SCALE, DENSE_EDGE_FACTOR = 11, 64
EXPECTED_DENSE = dict(nnz_a=130_560, nnz_c=2_893_522, max_c=1_310)

KERNELS = ("segreduce", "semiring_matmul")


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
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        list(pool.map(_build.load, KERNELS))
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(KERNELS)} kernels")
    for name in KERNELS:
        info = _build.build_info[name]
        log(f"  {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or ("spill" in line
                                       and " 0 bytes spill" not in line):
                log("    ptxas:", line.strip())
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
# phase 2b: semiring_matmul kernel vs plain
# --------------------------------------------------------------------------

SMM_MAIN = (2048, 2048, 2048)        # (M, K, N) of phase 4's dense tile


def _smm_operands(kind, m, k, n, dtype, seed, integers=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "or_and":
        return (torch.rand(m, k, generator=g, device="cuda") < 0.2,
                torch.rand(k, n, generator=g, device="cuda") < 0.2)
    if integers or not dtype.is_floating_point:
        return (torch.randint(-4, 5, (m, k), generator=g, device="cuda")
                .to(dtype),
                torch.randint(-4, 5, (k, n), generator=g, device="cuda")
                .to(dtype))
    return (torch.randn(m, k, generator=g, device="cuda", dtype=dtype),
            torch.randn(k, n, generator=g, device="cuda", dtype=dtype))


def _smm_compare(got, want, a, b, exact):
    """Max abs error; raises unless bitwise equal (up to NaN payloads) where
    ``exact``, else within the bound of any summation order,
    2 K u (|A| @ |B|) (u = 2^-24 for the f32 accumulator), plus one bf16
    rounding (2^-8 |want|) for a bf16 output; u = 2^-53 for f64."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    if exact:
        if got.dtype.is_floating_point:
            same = ((got == want) & (got.signbit() == want.signbit())) | \
                (got.isnan() & want.isnan())
        else:
            same = got == want
        if not bool(same.all()):
            raise AssertionError(f"{int((~same).sum())} entries differ")
        return 0.0
    k = a.shape[1]
    u = 2.0 ** -53 if got.dtype == torch.float64 else 2.0 ** -24
    bound = 2 * k * u * (a.double().abs() @ b.double().abs())
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * want.double().abs()
    err = (got.double() - want.double()).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"beyond the summation-order bound: max err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _smm_bound(kind, m, k, n, itemsize, sm_count, clock_hz):
    """Least time of C = A (+).(x) B at (m, k, n): operations at the card's
    rate for them (SM count x lanes x clock: plus_times one FMA a step on
    128 FP32 lanes, min_plus/max_min two non-fused operations a step on
    the same lanes, or_and one 32-bit logic op (LOP3: acc | a & b) per 32
    steps on 64 integer lanes, as a bit-packed K axis needs), or bytes
    (A and B read once, C written once) at 3.35 TB/s."""
    steps = m * k * n
    ops, lanes = {"plus_times": (1, 128), "min_plus": (2, 128),
                  "max_min": (2, 128), "or_and": (1 / 32, 64)}[kind]
    t_ops = steps * ops / (sm_count * lanes * clock_hz) * 1e3
    out_size = 1 if kind == "or_and" else itemsize
    nbytes = (m * k + k * n) * itemsize + m * n * out_size
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def check_semiring_matmul() -> dict:
    from repro_torch.kernels import semiring_matmul as smm

    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    shapes = (SMM_MAIN, (1000, 777, 1531), (1, 1, 1), (130, 17, 65),
              (5, 0, 7))
    # (kind, dtype, shape, integer-valued float operands)
    cases = []
    for shape in shapes:
        cases += [("plus_times", f32, shape, True),
                  ("plus_times", f32, shape, False),
                  ("min_plus", f32, shape, False),
                  ("max_min", f32, shape, False),
                  ("or_and", b8, shape, False)]
    for shape in shapes[:2]:
        cases += [("plus_times", bf16, shape, False),
                  ("plus_times", i32, shape, False),
                  ("plus_times", i64, shape, False),
                  ("plus_times", f64, shape, False),
                  ("min_plus", f64, shape, False),
                  ("max_min", f64, shape, False)]
    max_err = 0.0
    for i, (kind, dtype, (m, k, n), integers) in enumerate(cases):
        a, b = _smm_operands(kind, m, k, n, dtype, seed=100 + i,
                             integers=integers)
        got = smm.semiring_matmul(a, b, kind)
        want = smm.semiring_matmul_plain(a, b, kind)
        torch.cuda.synchronize()
        exact = kind != "plus_times" or integers or not dtype.is_floating_point
        try:
            err = _smm_compare(got, want, a, b, exact)
        except AssertionError as e:
            raise AssertionError(f"semiring_matmul {kind} {dtype} "
                                 f"{(m, k, n)}: {e}") from e
        max_err = max(max_err, err)
    # NaN and inf: min/max must propagate NaN as torch.minimum/maximum do,
    # and inf + (-inf) is NaN under min_plus
    for kind in ("min_plus", "max_min"):
        for dtype in (f32, f64):
            a, b = _smm_operands(kind, 1000, 777, 1531, dtype, seed=7)
            a[3, 5] = float("nan")
            a[7, :] = float("inf")
            b[:, 2] = -float("inf")
            b[4, 9] = float("nan")
            got = smm.semiring_matmul(a, b, kind)
            want = smm.semiring_matmul_plain(a, b, kind)
            if not bool(want.isnan().any()):
                raise AssertionError("the NaN case holds no NaN")
            _smm_compare(got, want, a, b, exact=True)
            cases.append((kind, dtype, (1000, 777, 1531), "nan/inf"))
    log(f"semiring_matmul: {len(cases)} cases match the plain version "
        f"(min_plus/max_min/or_and/integer sums bitwise; max abs err of "
        f"random f32/bf16/f64 sums {max_err:.3g}, within 2 K u |A||B|)")

    # times at phase 4's shape, 2048^3, by kind, beside the bound
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    clock_hz = clock_mhz * 1e6
    log(f"bound: {sm_count} SMs at a max SM clock of {clock_mhz:.0f} MHz "
        f"(nvidia-smi); FP32 lanes 128/SM/clock -> "
        f"{sm_count * 128 * 2 * clock_hz / 1e12:.1f} TFLOP/s FMA (data-sheet "
        f"{F32_FLOPS / 1e12:.0f}); HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32} (torch.matmul in full f32)")
    m, k, n = SMM_MAIN
    times = {}
    for kind in ("plus_times", "min_plus", "max_min", "or_and"):
        dtype = b8 if kind == "or_and" else f32
        a, b = _smm_operands(kind, m, k, n, dtype, seed=1)
        ms = cuda_time_ms(lambda: smm.semiring_matmul(a, b, kind), iters=20)
        plain_ms = cuda_time_ms(
            lambda: smm.semiring_matmul_plain(a, b, kind), iters=5, warmup=1)
        library_ms = cuda_time_ms(lambda: torch.matmul(a, b), iters=20) \
            if kind == "plus_times" else None
        bound, by, t_ops, t_bytes = _smm_bound(kind, m, k, n, a.element_size(),
                                               sm_count, clock_hz)
        times[kind] = (ms, plain_ms, library_ms, bound, by)
        lib = f", torch.matmul {library_ms:.4f} ms" if library_ms else ""
        log(f"semiring_matmul {kind} {m}x{k}x{n} {dtype}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms{lib}; bound {bound:.4f} ms by {by} "
            f"(operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), "
            f"{100 * bound / ms:.1f}% of it")
    ms, plain_ms, library_ms, bound, by = times["plus_times"]
    return {"name": "semiring_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/semiring_matmul.cu",
            "replaces": "src/repro/kernels/semiring_matmul.py:58",
            "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


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


def main_path():
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
    return launches, a


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
           if any(name in e.key for name in KERNELS)]
    for us, n, name in ops[:top] + own:
        log(f"  {us / 1e3:9.3f} ms {n:5d}x  {name[:80]}")


# --------------------------------------------------------------------------
# phase 4: dense-accumulator local SpGEMM (R-MAT scale 11, ef 64)
# --------------------------------------------------------------------------

def _wall(fn):
    """Host-clock seconds of a warm ``fn()`` that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_tile(x, y) -> bool:
    """Two COO tiles equal bitwise: nnz, coordinates and values."""
    k = int(x.nnz)
    if k != int(y.nnz):
        return False
    return (torch.equal(x.row[:k], y.row[:k])
            and torch.equal(x.col[:k], y.col[:k])
            and torch.equal(x.val[:k].view(torch.uint8),
                            y.val[:k].view(torch.uint8)))


def dense_path() -> int:
    """Phase 4; returns the semiring_matmul launches of the four measured
    ``spgemm_auto`` calls (each must launch it exactly once)."""
    import scipy.sparse as sp
    from repro_torch.core import semiring as S
    from repro_torch.core.dist import DistSpMat
    from repro_torch.core.local_spgemm import spgemm_auto, spgemm_esc
    from repro_torch.core.plan import plan_local_spgemm
    from repro_torch.io.rmat import rmat_coo
    from repro_torch.kernels import segreduce
    from repro_torch.kernels import semiring_matmul as smm

    shape, rows, cols, vals = rmat_coo(DENSE_SCALE, DENSE_EDGE_FACTOR,
                                       seed=RMAT_SEED, symmetrize=True,
                                       drop_self_loops=True)
    a = DistSpMat.from_global_coo(shape, rows, cols, vals, (1, 1),
                                  device="cuda").tile()     # row-sorted
    nnz = int(a.nnz)
    ref = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    ref2 = (ref @ ref).tocoo()
    log(f"R-MAT scale {DENSE_SCALE} ef {DENSE_EDGE_FACTOR}: {shape[0]} "
        f"vertices, nnz(A) {nnz} (tile cap {a.cap}, order {a.order}); "
        f"scipy A@A nnz {ref2.nnz}, max {ref2.data.max():.0f}")
    if (nnz, ref2.nnz, int(ref2.data.max())) != tuple(EXPECTED_DENSE.values()):
        raise AssertionError(f"graph differs from {EXPECTED_DENSE}")
    plan = plan_local_spgemm(a, a)
    log(f"plan_local_spgemm: {plan}")
    if plan.algo != "dense":
        raise AssertionError(f"planner took {plan.algo}, not dense")
    caps = dict(prod_cap=plan.prod_cap, out_cap=plan.out_cap)
    auto = dict(caps, algo=plan.algo)     # the plan's pick: no ratio read

    # the weighted semirings get integer weights 1..64 in entry order
    w = torch.zeros(a.cap, dtype=torch.float32, device="cuda")
    w[:nnz] = torch.as_tensor(np.random.default_rng(1).integers(
        1, 65, nnz).astype(np.float32), device="cuda")
    tiles = {"ARITHMETIC": a,
             "BOOLEAN": dataclasses.replace(a, val=a.val != 0),
             "MIN_PLUS": dataclasses.replace(a, val=w),
             "MAX_MIN": dataclasses.replace(a, val=w)}
    total = 0
    for name, t in tiles.items():
        sr = getattr(S, name)
        spgemm_auto(t, t, sr, **auto)                 # warm-up
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        before = smm.launches
        (c, ok), wall = _wall(lambda: spgemm_auto(t, t, sr, **auto))
        launched = smm.launches - before
        peak = torch.cuda.max_memory_allocated() - live
        total += launched
        if launched != 1:
            raise AssertionError(f"{name}: spgemm_auto launched "
                                 f"semiring_matmul {launched} times")
        if not bool(ok):
            raise AssertionError(f"{name}: spgemm_auto overflowed")
        seg_before = segreduce.launches
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        (e, eok), esc_wall = _wall(lambda: spgemm_esc(t, t, sr, **caps))
        esc_peak = torch.cuda.max_memory_allocated() - live
        if not bool(eok):
            raise AssertionError(f"{name}: spgemm_esc overflowed")
        if not _same_tile(c, e):
            raise AssertionError(f"{name}: dense and ESC results differ")
        k = int(c.nnz)
        r, cc, v = (x[:k].cpu().numpy() for x in (c.row, c.col, c.val))
        want = np.lexsort((ref2.col, ref2.row))
        if not (np.array_equal(r, ref2.row[want])
                and np.array_equal(cc, ref2.col[want])):
            raise AssertionError(f"{name}: pattern differs from scipy's")
        if name == "ARITHMETIC" and not np.array_equal(
                v.view(np.uint32), ref2.data[want].astype(np.float32)
                .view(np.uint32)):
            raise AssertionError("ARITHMETIC: values differ from scipy's")
        if name == "BOOLEAN" and not bool(v.all()):
            raise AssertionError("BOOLEAN: a stored entry is False")
        if name in ("MIN_PLUS", "MAX_MIN"):
            # the entries both paths visited, against the plain oracle on
            # the densified tiles
            kind = S._kernel_kind(sr)
            zero = sr.add.identity
            dense = smm.semiring_matmul_plain(t.to_dense(zero),
                                              t.to_dense(zero), kind)
            if not torch.equal(dense[c.row[:k].long(), c.col[:k].long()],
                               c.val[:k]):
                raise AssertionError(f"{name}: values differ from the "
                                     f"plain oracle")
            if int((dense != zero).sum()) != k:
                raise AssertionError(f"{name}: pattern differs from the "
                                     f"plain oracle")
        log(f"{name}: nnz(C) {k} bitwise equal to "
            f"{'scipy and ' if name == 'ARITHMETIC' else ''}the ESC path"
            f"{' and the plain oracle' if name in ('MIN_PLUS', 'MAX_MIN') else ''}"
            f"; spgemm_auto (dense) {wall * 1e3:.3f} ms warm, "
            f"1 semiring_matmul launch, {peak / 2**30:.3f} GiB above live "
            f"memory; spgemm_esc {esc_wall * 1e3:.3f} ms warm, "
            f"{segreduce.launches - seg_before} segreduce launches, "
            f"{esc_peak / 2**30:.3f} GiB above live memory")
    profile_breakdown(lambda: spgemm_auto(a, a, S.ARITHMETIC, **auto))
    return total


# --------------------------------------------------------------------------
# phase 5: local SpMV / SpMSpV on phase 3's tile
# --------------------------------------------------------------------------

def spmv_path(dist_a) -> int:
    """Phase 5; returns the segreduce launches of its measured calls."""
    import scipy.sparse as sp
    from repro_torch.core import semiring as S
    from repro_torch.core.plan import plan_local_spmspv
    from repro_torch.core.spmv_local import (spmspv_auto, spmv_col, spmv_row,
                                             spvec_to_dense)
    from repro_torch.kernels import segreduce

    a = dist_a.tile()
    m, n = a.shape
    k = int(a.nnz)
    r, c, v = (x[:k].cpu().numpy() for x in (a.row, a.col, a.val))
    ref = sp.csr_matrix((v, (r, c)), shape=(m, n))
    rng = np.random.default_rng(2)
    x = rng.integers(1, 9, n).astype(np.float32)
    want = ref @ x
    total = 0
    for fn in (spmv_row, spmv_col):
        xt = torch.as_tensor(x, device="cuda")
        fn(a, xt, S.ARITHMETIC)
        before = segreduce.launches
        y, wall = _wall(lambda: fn(a, xt, S.ARITHMETIC))
        launched = segreduce.launches - before
        total += launched
        if launched < 1:
            raise AssertionError(f"{fn.__name__} launched no segreduce")
        if not np.array_equal(y.cpu().numpy().view(np.uint32),
                              want.astype(np.float32).view(np.uint32)):
            raise AssertionError(f"{fn.__name__} differs from scipy's A @ x")
        log(f"{fn.__name__}: y bitwise equal to scipy's A @ x, "
            f"{wall * 1e3:.3f} ms warm, {launched} segreduce launches")
    ab = dataclasses.replace(a, val=a.val != 0)
    for density, expect in ((0.001, "sort"), (0.02, "bucket"),
                            (0.2, "spa")):
        f = round(density * n)
        idx = np.sort(rng.choice(n, f, replace=False)).astype(np.int32)
        xv = rng.integers(1, 9, f).astype(np.float32)
        xd = np.zeros(n, np.float32)
        xd[idx] = xv
        for name, tile, vals in (("ARITHMETIC", a, xv),
                                 ("BOOLEAN", ab, xv != 0)):
            sr = getattr(S, name)
            plan = plan_local_spmspv(tile, f)
            if plan.variant != expect:
                raise AssertionError(f"density {density}: planner took "
                                     f"{plan.variant}, not {expect}")
            xi_t = torch.as_tensor(idx, device="cuda")
            xv_t = torch.as_tensor(vals, device="cuda")
            caps = dict(prod_cap=plan.prod_cap, out_cap=plan.out_cap)
            spmspv_auto(tile, xi_t, xv_t, f, sr, **caps)
            before = segreduce.launches
            ((yi, yv, ynnz), ok), wall = _wall(
                lambda: spmspv_auto(tile, xi_t, xv_t, f, sr, **caps))
            if not bool(ok):
                raise AssertionError(f"spmspv {name} density {density} "
                                     f"overflows the planner's caps {caps}")
            launched = segreduce.launches - before
            total += launched
            y = spvec_to_dense(yi, yv, m, zero=sr.add.identity).cpu().numpy()
            ref_y = ref @ xd
            if name == "ARITHMETIC":
                same = np.array_equal(y.view(np.uint32),
                                      ref_y.astype(np.float32)
                                      .view(np.uint32))
            else:
                same = np.array_equal(y, ref_y > 0)
            if not same or launched < 1:
                raise AssertionError(f"spmspv {name} density {density}: "
                                     f"differs from scipy or no launch")
            log(f"spmspv_auto {name} density {density} (f={f}): variant "
                f"{plan.variant}, nnz(y) {int(ynnz)} bitwise equal to scipy, "
                f"{wall * 1e3:.3f} ms warm, {launched} segreduce launches, "
                f"caps {caps}")
    return total


def main() -> int:
    smi = setup()
    seg_record = check_segreduce()
    smm_record = check_semiring_matmul()
    from repro_torch.kernels import segreduce
    from repro_torch.kernels import semiring_matmul as smm
    # each path runs with the launch counts set to 0 just before it and
    # read just after; the records keep phases 3 and 4 (their kernel's path)
    segreduce.launches = smm.launches = 0
    seg_record["launches"], dist_a = main_path()
    segreduce.launches = smm.launches = 0
    smm_record["launches"] = dense_path()
    if segreduce.launches < 1:
        raise AssertionError("phase 4's ESC cross-check launched no "
                             "segreduce")
    segreduce.launches = smm.launches = 0
    if spmv_path(dist_a) < 1 or smm.launches:
        raise AssertionError("phase 5 launched no segreduce, or a matmul")
    log(json.dumps({"kernels": [seg_record, smm_record]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
