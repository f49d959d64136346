"""Dense-tile semiring matmul: the Hopper kernel and its plain version.

Replaces ``repro/kernels/semiring_matmul.py::semiring_matmul``, the TPU
kernel of the dense-accumulator local SpGEMM: the (i, j) slot of the dense
output tile is the paper's hash bucket. ``core.semiring.dense_semiring_matmul``
hands every semiring whose parts name one of the four algebras here (its
``_kernel_kind``), so ``local_spgemm.spgemm_dense`` runs on this kernel.

``semiring_matmul`` is the wrapper. A tensor on the CPU goes to
``semiring_matmul_plain``; a CUDA tensor launches a kernel in
``csrc/semiring_matmul.cu`` or raises. Output types follow the Pallas
wrapper: ``promote_types(a, b)``, and bool for ``or_and``; mixed inputs are
cast to the output type first. The kernels take f32/f64 for the three
arithmetic algebras, bf16 (accumulated in f32, rounded once) and i32/i64
for ``plus_times``, and bool for ``or_and``; anything else raises a
``TypeError`` on either device. Integer ``min_plus``/``max_min`` is refused:
they have no +-inf identity (the TPU kernel fills its int accumulator with
inf cast to int). f32 takes a pipelined 128 x 128-tile kernel on the CUDA
cores (FMA, or one min/max instruction a combine), bool a kernel that packs
K into 32-bit words while staging, and the other types the first 64 x 64
design; all are bound by operations (8.6e9 semiring steps against 48 MiB of
operands at 2048^3); see the source's note.

min and max propagate NaN, as ``torch.minimum``/``torch.maximum`` do, and
order -0 below +0 (IEEE 754-2019 minimum/maximum): a tie of the two zeros
gives -0 under min and +0 under max whatever the order of k, on both
devices.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import refuse_grad

KINDS = ("plus_times", "min_plus", "max_min", "or_and")
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}
# dtype -> code in semiring_matmul.cu
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
               torch.int32: 3, torch.int64: 4, torch.bool: 5}
# the types each algebra takes (its output type, after the cast)
_TAKES = {"plus_times": (torch.float32, torch.float64, torch.bfloat16,
                         torch.int32, torch.int64),
          "min_plus": (torch.float32, torch.float64),
          "max_min": (torch.float32, torch.float64),
          "or_and": (torch.bool,)}
# the accumulator's start: the algebra's identity
_IDENTITY = {"plus_times": 0, "min_plus": math.inf, "max_min": -math.inf,
             "or_and": False}
# elements of one (m, k-chunk, n) intermediate of the plain version: 2^27
# (512 MiB in f32) keeps the oracle at 2048^3 within a few GiB on the card
_PLAIN_CHUNK_ELEMS = 1 << 27

# kernel launches since the last reset (the plain path never counts)
launches = 0

_fn = None


def out_dtype(kind: str, a_dtype: torch.dtype,
              b_dtype: torch.dtype) -> torch.dtype:
    """The Pallas wrapper's output type: bool for or_and, else promotion."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "or_and":
        return torch.bool
    return torch.promote_types(a_dtype, b_dtype)


def _check(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.dtype:
    out = out_dtype(kind, a.dtype, b.dtype)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"semiring_matmul needs (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("a and b lie on different devices")
    if out not in _TAKES[kind]:
        raise TypeError(f"{kind} takes {list(_TAKES[kind])}, not {out}")
    return out


# min and max of floats with -0 below +0 (what min.NaN / max.NaN do on the
# card), so that a tie of the zeros does not hang on the order of operands
def _minimum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    out = torch.minimum(x, y)
    return torch.where((out == 0) & (x.signbit() | y.signbit()),
                       out.new_full((), -0.0), out)


def _maximum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    out = torch.maximum(x, y)
    return torch.where((out == 0) & ~(x.signbit() & y.signbit()),
                       out.new_full((), 0.0), out)


def _amin(t: torch.Tensor, dim: int) -> torch.Tensor:
    out = t.amin(dim)
    neg = ((t == 0) & t.signbit()).any(dim)
    return torch.where((out == 0) & neg, out.new_full((), -0.0), out)


def _amax(t: torch.Tensor, dim: int) -> torch.Tensor:
    out = t.amax(dim)
    pos = ((t == 0) & ~t.signbit()).any(dim)
    return torch.where((out == 0) & pos, out.new_full((), 0.0), out)


def semiring_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                          kind: str = "plus_times") -> torch.Tensor:
    """The plain PyTorch version (``repro/kernels/ref.py``'s oracle).

    Float ``plus_times`` is ``a @ b`` (bf16 through an f32 product rounded
    once, as the kernel does); integer ``plus_times`` and the other three
    algebras are a K-chunked broadcast-reduce, each chunk an (M, kc, N)
    intermediate of at most 2^27 elements. min and max order -0 below +0,
    as the kernels do, so the zeros' signs do not hang on the order of k.
    """
    out = _check(a, b, kind)
    a, b = a.to(out), b.to(out)
    if kind == "plus_times" and out.is_floating_point:
        if out == torch.bfloat16:
            return (a.float() @ b.float()).to(out)
        return a @ b
    m, k = a.shape
    n = b.shape[1]
    acc = torch.full((m, n), _IDENTITY[kind], dtype=out,
                     device=a.device)
    kc = max(1, min(k, _PLAIN_CHUNK_ELEMS // max(m * n, 1)))
    for k0 in range(0, k, kc):
        ac = a[:, k0:k0 + kc, None]
        bc = b[None, k0:k0 + kc, :]
        if kind == "plus_times":            # integers: wraps like the kernel
            acc += (ac * bc).sum(dim=1, dtype=out)
        elif kind == "min_plus":
            acc = _minimum(acc, _amin(ac + bc, 1))
        elif kind == "max_min":
            acc = _maximum(acc, _amax(_minimum(ac, bc), 1))
        else:
            acc |= (ac & bc).any(dim=1)
    return acc


def _launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            kind: str) -> None:
    global _fn, launches
    if _fn is None:
        from ._build import load
        fn = load("semiring_matmul").semiring_matmul_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    m, k = a.shape
    n = b.shape[1]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
              _KIND_CODE[kind], _DTYPE_CODE[c.dtype], stream)
    if err != 0:
        raise RuntimeError(f"semiring_matmul kernel launch failed ({kind}, "
                           f"{c.dtype}, {m}x{k}x{n}): error {err}")
    launches += 1


def semiring_matmul(a: torch.Tensor, b: torch.Tensor,
                    kind: str = "plus_times") -> torch.Tensor:
    """C = A ⊕.⊗ B for A (M, K), B (K, N) under one of ``KINDS``.

    CPU tensors take the plain version; a CUDA tensor launches the kernel or
    raises. Any M, N and K; K = 0 gives the algebra's identity.
    """
    out = _check(a, b, kind)
    if a.device.type == "cpu":
        return semiring_matmul_plain(a, b, kind)
    if a.device.type != "cuda":
        raise ValueError(f"semiring_matmul runs on cpu or cuda, not "
                         f"{a.device}")
    refuse_grad("semiring_matmul", "nothing differentiates a semiring "
                "product, in either package", a, b)
    if max(a.shape[0], a.shape[1], b.shape[1]) >= 2**31:
        raise ValueError("semiring_matmul takes dimensions below 2^31")
    a = a.to(out).contiguous()
    b = b.to(out).contiguous()
    c = torch.empty((a.shape[0], b.shape[1]), dtype=out, device=a.device)
    if c.numel():
        _launch(a, b, c, kind)
    return c
