"""Mamba2 SSD intra-chunk contraction: the Hopper kernel and its plain version.

Replaces ``repro/kernels/ssd_chunk.py::ssd_chunk``, the TPU kernel of the
state-space-duality scan (``repro/models/layers.py`` runs its pure-JAX twin
inside ``ssd_chunked``; the port's ``models.layers.ssd_chunked`` calls this
module, so every mamba prefill runs on the kernel in ``csrc/ssd_chunk.cu``).

For each pair (g, h) of a (batch * chunk) index g and a head h, with
``cA = cumsum(dt * A[h])`` over the chunk's q positions:

    y[g, i, h, p]  = sum_{k <= i} (C_i . B_k) exp(cA_i - cA_k) dt_k x[g, k, h, p]
    st[g, h, p, n] = sum_k x[g, k, h, p] exp(cA_last - cA_k) dt_k B[g, k, n]

``ssd_chunk`` is the wrapper. A tensor on the CPU goes to
``ssd_chunk_plain``; a CUDA tensor launches a kernel or raises. Inputs:
xc (G, q, H, P), dtc (G, q, H), A (H,), Bc and Cc (G, q, N); x, B and C in
float32 or bfloat16, all three alike; dt and A in float32 or bfloat16 each.
Any q from 1 to 256, any H, and P and N up to 256. Outputs are float32
always, as the Pallas kernel's: y (G, q, H, P) and st (G, H, P, N).

Two kernels (``route`` says which an input takes): bf16 x, B and C with
P = 64, N a multiple of 8 up to 128 and q up to 128 (mamba2's prefill) run
on the tensor cores, wgmma fed by TMA; everything else, float32 inputs
among them, runs float32 FMA on the CUDA cores.

Numerics follow the Pallas kernel, which casts every input to float32: the
cumsum, the scores C . B, the decay and both products in float32. On the
tensor cores the scores are bf16 x bf16 products, exact in float32; the
float32 operand of the other two products (w, and x times the decay) is
split into three bf16 terms that carry its 24 bits, each multiplied exactly
and summed in float32. Above the diagonal ``cA_i - cA_k`` is positive and
its exp may overflow; those entries are selected away (``where(i >= k, exp,
0)``, as the reference), never multiplied by a 0/1 mask, so no ``0 * inf``
reaches a sum.
"""
from __future__ import annotations

import ctypes

import torch

from . import refuse_grad

# dtype -> code in ssd_chunk.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256
MAX_DIM = 256

# kernel launches since the last reset (the plain path never counts)
launches = 0

_fn = None
_route_fn = None


def _check(xc, dtc, A, Bc, Cc) -> None:
    if xc.dim() != 4 or dtc.dim() != 3 or A.dim() != 1 or Bc.dim() != 3 \
            or Cc.dim() != 3:
        raise ValueError("ssd_chunk takes xc (G, q, H, P), dtc (G, q, H), "
                         "A (H,), Bc and Cc (G, q, N)")
    G, q, H, P = xc.shape
    N = Bc.shape[2]
    if tuple(dtc.shape) != (G, q, H) or tuple(A.shape) != (H,) or \
            tuple(Bc.shape) != (G, q, N) or tuple(Cc.shape) != (G, q, N):
        raise ValueError(f"xc {tuple(xc.shape)}, dtc {tuple(dtc.shape)}, A "
                         f"{tuple(A.shape)}, Bc {tuple(Bc.shape)} and Cc "
                         f"{tuple(Cc.shape)} do not fit together")
    if xc.dtype not in _DTYPE_CODE or Bc.dtype != xc.dtype or \
            Cc.dtype != xc.dtype:
        raise TypeError(f"ssd_chunk takes x, B and C in float32 or bfloat16 "
                        f"alike, got {xc.dtype}, {Bc.dtype}, {Cc.dtype}")
    if dtc.dtype not in _DTYPE_CODE or A.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssd_chunk takes dt and A in float32 or bfloat16, "
                        f"got {dtc.dtype}, {A.dtype}")
    if len({t.device for t in (xc, dtc, A, Bc, Cc)}) != 1:
        raise ValueError("ssd_chunk's inputs lie on different devices")


def ssd_chunk_plain(xc, dtc, A, Bc, Cc):
    """The plain PyTorch version: ``repro/kernels/ref.py``'s
    ``ssd_chunk_diag`` over the batch dimension G at once, in float32 as
    the Pallas kernel computes."""
    _check(xc, dtc, A, Bc, Cc)
    q = xc.shape[1]
    x, dt, B, C = xc.float(), dtc.float(), Bc.float(), Cc.float()
    cA = torch.cumsum(dt * A.float(), dim=1)                 # (G, q, H)
    seg = cA[:, :, None, :] - cA[:, None, :, :]              # (G, q, k, H)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    L = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
    scores = C @ B.transpose(1, 2)                           # (G, q, k)
    w = scores[..., None] * L * dt[:, None, :, :]            # (G, q, k, H)
    y = torch.einsum("gqkh,gkhp->gqhp", w, x)
    decay_last = torch.exp(cA[:, -1:, :] - cA) * dt          # (G, k, H)
    xw = x * decay_last[..., None]                           # (G, k, H, P)
    st = torch.einsum("gkhp,gkn->ghpn", xw, B)
    return y, st


def _lib():
    global _fn, _route_fn
    if _fn is None:
        from ._build import load
        lib = load("ssd_chunk")
        fn = lib.ssd_chunk_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        route_fn = lib.ssd_chunk_route
        route_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        route_fn.restype = ctypes.c_int
        _fn, _route_fn = fn, route_fn
    return _fn


def route(xc, dtc, A, Bc, Cc) -> str:
    """Which version ``ssd_chunk`` runs for these inputs: "plain" on the
    CPU; on the GPU "wgmma" (the tensor-core kernel) or "fma" (the float32
    FMA kernel), as ``csrc/ssd_chunk.cu`` decides."""
    _check(xc, dtc, A, Bc, Cc)
    if xc.device.type == "cpu":
        return "plain"
    _lib()
    xc, Bc, Cc = (t.contiguous() for t in (xc, Bc, Cc))
    q, P, N = xc.shape[1], xc.shape[3], Bc.shape[2]
    return "wgmma" if _route_fn(xc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                                q, P, N, _DTYPE_CODE[xc.dtype]) else "fma"


def _launch(xc, dtc, A, Bc, Cc, y, st) -> None:
    global launches
    fn = _lib()
    G, q, H, P = xc.shape
    N = Bc.shape[2]
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    err = fn(xc.data_ptr(), dtc.data_ptr(), A.data_ptr(), Bc.data_ptr(),
              Cc.data_ptr(), y.data_ptr(), st.data_ptr(), G, q, H, P, N,
              _DTYPE_CODE[xc.dtype], _DTYPE_CODE[dtc.dtype],
              _DTYPE_CODE[A.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed (x {xc.dtype} "
                           f"{tuple(xc.shape)}, dt {dtc.dtype}, A {A.dtype}, "
                           f"N {N}): error {err}")
    launches += 1


def ssd_chunk(xc, dtc, A, Bc, Cc):
    """Intra-chunk SSD over all (batch * chunk, head) pairs.

    CPU tensors take the plain version; a CUDA tensor launches the kernel or
    raises. Returns (y (G, q, H, P), states (G, H, P, N)), float32.
    """
    _check(xc, dtc, A, Bc, Cc)
    if xc.device.type == "cpu":
        return ssd_chunk_plain(xc, dtc, A, Bc, Cc)
    if xc.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cpu or cuda, not {xc.device}")
    refuse_grad("ssd_chunk", "its backward waits for the SSD backward slice, "
                "ROADMAP queue 1", xc, dtc, A, Bc, Cc)
    G, q, H, P = xc.shape
    N = Bc.shape[2]
    if not 1 <= q <= MAX_CHUNK or max(P, N) > MAX_DIM:
        raise ValueError(f"ssd_chunk takes chunks of 1 to {MAX_CHUNK} and P, "
                         f"N up to {MAX_DIM}; got q {q}, P {P}, N {N}")
    if G * H >= 2**31:
        raise ValueError(f"ssd_chunk takes G * H below 2^31, got {G * H}")
    xc, dtc, A, Bc, Cc = (t.contiguous() for t in (xc, dtc, A, Bc, Cc))
    y = torch.empty((G, q, H, P), dtype=torch.float32, device=xc.device)
    st = torch.empty((G, H, P, N), dtype=torch.float32, device=xc.device)
    if y.numel() or st.numel():
        _launch(xc, dtc, A, Bc, Cc, y, st)
    return y, st
