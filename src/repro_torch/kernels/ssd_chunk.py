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

Gradients: on a CUDA tensor that needs one (grad mode on, an input that
requires grad) the wrapper goes through ``SsdChunk``, an autograd Function
whose forward launches the same kernel and whose backward launches
``csrc/ssd_chunk_bwd.cu`` (dx, ddt, dA, dB, dC, each in its input's type;
``backward_launches`` counts its calls, ``backward_route_launches`` them by
route). The backward has the forward's two routes, and ``backward_route``
names the one an input takes: "wgmma" for the forward's tensor-core domain
(bf16 x, B, C with P = 64, N a multiple of 8 up to 128, q up to 128: mamba2's
and jamba's training), wgmma fed by TMA with the float32 operands split into
two bf16 terms; "fma" for the rest (float32 FMA on the CUDA cores). The TPU
kernel has none: the JAX package differentiates its pure twin.
``ssd_chunk_backward_plain`` is the formula written out, which the kernels
are held against; on the CPU autograd runs through the plain version.

Numerics follow the Pallas kernel, which casts every input to float32: the
cumsum, the scores C . B, the decay and both products in float32. On the
tensor cores the scores are bf16 x bf16 products, exact in float32; the
float32 operand of the other two products (w, and x times the decay) is
split into three bf16 terms that carry its 24 bits, each multiplied exactly
and summed in float32. Above the diagonal ``cA_i - cA_k`` is positive and
its exp may overflow; those entries are selected away before the exp
(``exp(where(i >= k, seg, -inf))``), never multiplied by a 0/1 mask, so no
``0 * inf`` reaches a sum, nor a gradient: the reference's ``where(i >= k,
exp(seg), 0)`` gives the same forward, but its backward multiplies the
where's zero cotangent by ``exp(seg) = inf`` and gives NaN gradients of dt
and A once a segment overflows (ROADMAP §3, defect 8 of the reference).
"""
from __future__ import annotations

import ctypes
import math

import torch

# dtype -> code in ssd_chunk.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256
MAX_DIM = 256

# kernel launches since the last reset (the plain path never counts): the
# forward kernel's, and the backward's (one a call of its four launches),
# also by the backward's route
launches = 0
backward_launches = 0
backward_route_launches = {"wgmma": 0, "fma": 0}

_fn = _route_fn = None
_bwd_fn = _bwd_route_fn = _bwd_scratch_fn = None


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
    x, dt, B, C = xc.float(), dtc.float(), Bc.float(), Cc.float()
    cA, L = _decay(dt, A)
    scores = C @ B.transpose(1, 2)                           # (G, q, k)
    w = scores[..., None] * L * dt[:, None, :, :]            # (G, q, k, H)
    y = torch.einsum("gqkh,gkhp->gqhp", w, x)
    decay_last = torch.exp(cA[:, -1:, :] - cA) * dt          # (G, k, H)
    xw = x * decay_last[..., None]                           # (G, k, H, P)
    st = torch.einsum("gkhp,gkn->ghpn", xw, B)
    return y, st


def _decay(dt, A):
    """cA = cumsum(dt A) (G, q, H) and L = exp(cA_i - cA_k) where i >= k,
    else 0 (G, q, k, H), float32. The entries above the diagonal, where the
    exp may overflow, are selected away before it, so autograd never
    multiplies a zero cotangent by inf."""
    q = dt.shape[1]
    cA = torch.cumsum(dt * A.float(), dim=1)
    seg = cA[:, :, None, :] - cA[:, None, :, :]
    causal = torch.ones(q, q, dtype=torch.bool, device=dt.device).tril()
    L = torch.exp(torch.where(causal[None, :, :, None], seg, -math.inf))
    return cA, L


def ssd_chunk_backward_plain(xc, dtc, A, Bc, Cc, dy, dst):
    """(dx, ddt, dA, dB, dC) of ``ssd_chunk`` for the cotangents dy (G, q,
    H, P) of y and dst (G, H, P, N) of the states: the formula written out
    in float32 (``csrc/ssd_chunk_bwd.cu`` states it), each gradient in its
    input's type. B and C are shared by the heads, so dS sums over them; dA
    sums over every (g, k)."""
    _check(xc, dtc, A, Bc, Cc)
    x, dt, B, C = xc.float(), dtc.float(), Bc.float(), Cc.float()
    a = A.float()
    dy, dst = dy.float(), dst.float()
    cA, L = _decay(dt, A)                                    # L (G, i, k, H)
    S = C @ B.transpose(1, 2)                                # (G, i, k)
    SL = S[..., None] * L
    W = SL * dt[:, None, :, :]
    E = torch.exp(cA[:, -1:, :] - cA)                        # (G, k, H)
    dec = E * dt
    dW = torch.einsum("gihp,gkhp->gikh", dy, x)
    U = torch.einsum("gkn,ghpn->gkhp", B, dst)
    dx = torch.einsum("gikh,gihp->gkhp", W, dy) + dec[..., None] * U
    ddec = (x * U).sum(-1)                                   # (G, k, H)
    dS = (dW * L * dt[:, None, :, :]).sum(-1)                # (G, i, k)
    dC = dS @ B
    dB = dS.transpose(1, 2) @ C + torch.einsum("gkh,gkhp,ghpn->gkn", dec, x,
                                               dst)
    M = dW * W
    dcA = M.sum(2) - M.sum(1) - ddec * dec                   # (G, i, H)
    dcA[:, -1] += (ddec * dec).sum(1)
    R = torch.flip(torch.cumsum(torch.flip(dcA, [1]), dim=1), [1])
    ddt = (dW * SL).sum(1) + ddec * E + a * R
    dA = (dt * R).sum((0, 1))
    return (dx.to(xc.dtype), ddt.to(dtc.dtype), dA.to(A.dtype),
            dB.to(Bc.dtype), dC.to(Cc.dtype))


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


def _bwd_lib():
    global _bwd_fn, _bwd_route_fn, _bwd_scratch_fn
    if _bwd_fn is None:
        from ._build import load
        lib = load("ssd_chunk_bwd")
        fn = lib.ssd_chunk_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        route_fn = lib.ssd_chunk_bwd_route
        route_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        route_fn.restype = ctypes.c_int
        scratch_fn = lib.ssd_chunk_bwd_scratch
        scratch_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        scratch_fn.restype = ctypes.c_longlong
        _bwd_fn, _bwd_route_fn, _bwd_scratch_fn = fn, route_fn, scratch_fn
    return _bwd_fn


def _ask_route(route_fn, xc, Bc, Cc) -> str:
    xc, Bc, Cc = (t.contiguous() for t in (xc, Bc, Cc))
    q, P, N = xc.shape[1], xc.shape[3], Bc.shape[2]
    return "wgmma" if route_fn(xc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                               q, P, N, _DTYPE_CODE[xc.dtype]) else "fma"


def route(xc, dtc, A, Bc, Cc) -> str:
    """Which version ``ssd_chunk`` runs for these inputs: "plain" on the
    CPU; on the GPU "wgmma" (the tensor-core kernel) or "fma" (the float32
    FMA kernel), as ``csrc/ssd_chunk.cu`` decides."""
    _check(xc, dtc, A, Bc, Cc)
    if xc.device.type == "cpu":
        return "plain"
    _lib()
    return _ask_route(_route_fn, xc, Bc, Cc)


def backward_route(xc, dtc, A, Bc, Cc) -> str:
    """Which version the gradient of ``ssd_chunk`` runs for these inputs:
    "plain" on the CPU (autograd through the plain version); on the GPU
    "wgmma" (the tensor-core kernel, in the forward's wgmma domain) or
    "fma" (the float32 FMA kernels), as ``csrc/ssd_chunk_bwd.cu`` decides."""
    _check(xc, dtc, A, Bc, Cc)
    if xc.device.type == "cpu":
        return "plain"
    _bwd_lib()
    return _ask_route(_bwd_route_fn, xc, Bc, Cc)


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


def _launch_backward(xc, dtc, A, Bc, Cc, dy, dst, grads) -> None:
    """The backward kernel on contiguous inputs and float32 cotangents,
    writing ``grads`` (dx, ddt, dA, dB, dC)."""
    global backward_launches
    fn = _bwd_lib()
    G, q, H, P = xc.shape
    N = Bc.shape[2]
    which = _ask_route(_bwd_route_fn, xc, Bc, Cc)
    scratch = torch.empty(int(_bwd_scratch_fn(
        xc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), G, q, H, P, N,
        _DTYPE_CODE[xc.dtype])), dtype=torch.float32, device=xc.device)
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    err = fn(xc.data_ptr(), dtc.data_ptr(), A.data_ptr(), Bc.data_ptr(),
             Cc.data_ptr(), dy.data_ptr(), dst.data_ptr(),
             *(t.data_ptr() for t in grads), scratch.data_ptr(), G, q, H, P,
             N, _DTYPE_CODE[xc.dtype], _DTYPE_CODE[dtc.dtype],
             _DTYPE_CODE[A.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk backward launch failed (x {xc.dtype} "
                           f"{tuple(xc.shape)}, dt {dtc.dtype}, A {A.dtype}, "
                           f"N {N}, {which} route): error {err}")
    backward_launches += 1
    backward_route_launches[which] += 1


def ssd_chunk_backward(xc, dtc, A, Bc, Cc, dy, dst):
    """(dx, ddt, dA, dB, dC) on the backward kernel for CUDA tensors (raises
    where it cannot launch), each in its input's type; the cotangents dy
    (G, q, H, P) and dst (G, H, P, N) are taken in float32."""
    _check(xc, dtc, A, Bc, Cc)
    G, q, H, P = xc.shape
    N = Bc.shape[2]
    if tuple(dy.shape) != (G, q, H, P) or tuple(dst.shape) != (G, H, P, N):
        raise ValueError(f"dy {tuple(dy.shape)} and dst {tuple(dst.shape)} "
                         f"do not fit x {tuple(xc.shape)} and N {N}")
    if xc.device.type != "cuda":
        raise ValueError(f"the ssd_chunk backward kernel runs on cuda, not "
                         f"{xc.device}")
    xc, dtc, A, Bc, Cc = (t.contiguous() for t in (xc, dtc, A, Bc, Cc))
    # TMA takes the cotangents on 16 bytes: a view that is not gets a copy
    dy, dst = (t.to(device=xc.device, dtype=torch.float32).contiguous()
               for t in (dy, dst))
    dy, dst = (t.clone() if t.data_ptr() % 16 else t for t in (dy, dst))
    grads = tuple(torch.empty_like(t) for t in (xc, dtc, A, Bc, Cc))
    if xc.numel() and N:
        _launch_backward(xc, dtc, A, Bc, Cc, dy, dst, grads)
    else:                    # no P or no N: every term of every sum is 0
        for t in grads:
            t.zero_()
    return grads


class SsdChunk(torch.autograd.Function):
    """``ssd_chunk`` on the kernels with its gradient: the forward kernel
    writes y and the states, the backward kernel gives the five gradients
    from the saved inputs."""

    @staticmethod
    def forward(ctx, xc, dtc, A, Bc, Cc):
        y, st = _forward(xc, dtc, A, Bc, Cc)
        ctx.save_for_backward(xc, dtc, A, Bc, Cc)
        return y, st

    @staticmethod
    def backward(ctx, dy, dst):
        return ssd_chunk_backward(*ctx.saved_tensors, dy, dst)


def _forward(xc, dtc, A, Bc, Cc):
    G, q, H, P = xc.shape
    N = Bc.shape[2]
    y = torch.empty((G, q, H, P), dtype=torch.float32, device=xc.device)
    st = torch.empty((G, H, P, N), dtype=torch.float32, device=xc.device)
    if y.numel() or st.numel():
        _launch(xc, dtc, A, Bc, Cc, y, st)
    return y, st


def ssd_chunk(xc, dtc, A, Bc, Cc):
    """Intra-chunk SSD over all (batch * chunk, head) pairs.

    CPU tensors take the plain version; a CUDA tensor launches the kernel or
    raises, through ``SsdChunk`` when a gradient is needed. Returns (y (G,
    q, H, P), states (G, H, P, N)), float32.
    """
    _check(xc, dtc, A, Bc, Cc)
    if xc.device.type == "cpu":
        return ssd_chunk_plain(xc, dtc, A, Bc, Cc)
    if xc.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cpu or cuda, not {xc.device}")
    G, q, H, P = xc.shape
    N = Bc.shape[2]
    if not 1 <= q <= MAX_CHUNK or max(P, N) > MAX_DIM:
        raise ValueError(f"ssd_chunk takes chunks of 1 to {MAX_CHUNK} and P, "
                         f"N up to {MAX_DIM}; got q {q}, P {P}, N {N}")
    if G * H >= 2**31:
        raise ValueError(f"ssd_chunk takes G * H below 2^31, got {G * H}")
    xc, dtc, A, Bc, Cc = (t.contiguous() for t in (xc, dtc, A, Bc, Cc))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, dtc, A, Bc, Cc)):
        return SsdChunk.apply(xc, dtc, A, Bc, Cc)
    return _forward(xc, dtc, A, Bc, Cc)
