"""Online-softmax attention: the Hopper kernel and its plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention``, the TPU
kernel that ``repro/models/layers.py`` leaves to its pure-JAX twin
``_chunked_attention``. The port's ``models.layers.attention`` calls this
module for every attention without a cache, so the model's prefill runs on
the kernel in ``csrc/flash_attention.cu``.

``flash_attention`` is the wrapper. A tensor on the CPU goes to
``flash_attention_plain``; a CUDA tensor launches the kernel or raises. The
kernel takes wider inputs than the Pallas one, which asks ``S`` to divide
its blocks and KV heads repeated for GQA:

- q (B, S, H, d), k (B, Skv, KVH, d), v (B, Skv, KVH, dv) with KVH | H:
  query head h reads KV head ``h // (H // KVH)`` (``jnp.repeat``'s order),
  nothing is repeated in memory;
- any S and Skv, d and dv up to 256; float32 or bfloat16, all three alike;
- causal or not. The causal mask is aligned at the bottom right, as
  ``layers.attention``'s ``tril(k=Skv - S)``: query i sees keys
  j <= i + Skv - S. A query that sees no key gives zeros (the online
  softmax's ``acc / max(l, 1e-30)``).

Gradients: on a CUDA tensor that needs one (grad mode on, an input that
requires grad) the wrapper goes through ``FlashAttention``, an autograd
Function whose forward launches the same kernel and also writes the row
log-sum-exp ``lse`` (B, H, S) float32, and whose backward launches
``csrc/flash_attention_bwd.cu`` (dQ, dK, dV; ``backward_launches`` counts
its calls). The TPU kernel has none: the JAX package differentiates its
pure twin. ``flash_attention_backward_plain`` is the materialised formula
the kernel is held against.

Numerics follow the Pallas kernel: scores, running max, denominator and
accumulator in float32, ``p`` rounded to v's type before the PV product,
the output divided by ``max(l, 1e-30)`` and rounded once to q's type.

Routes (``route`` and ``backward_route`` say which a call takes):

- forward: bf16 with d and dv multiples of 8, 64 <= d <= 192 and
  64 <= dv <= 128 (every registry head: MLA's d = 192 / dv = 128 and
  hubert's d = 80 included) runs on Hopper's tensor cores, wgmma fed by
  TMA, 128 query rows a block; head dims between 64-column boxes load
  their missing columns as TMA's zeros. What bounds it is the tensor
  cores' rate; the softmax between the two products is what it does not
  hide (40-43 % of the bound at the main-path shapes, PERF.md §6 row 4).
- backward: bf16 with d == dv a multiple of 8 in 64..128 runs two
  wgmma kernels (dK/dV a key tile with the GQA group inside the block, dQ a
  query tile), P and dS passed as register operands, no atomics.
- everything else (float32, MLA's backward, other head dims, rows not on
  16 bytes) runs the float32 FMA kernels. They are kernels of their own,
  chosen by type and shape in the ``.cu``, not a fallback: a refused launch
  or tensor map raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

# dtype -> code in flash_attention.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

# kernel launches since the last reset (the plain path never counts): the
# forward kernel's, and the backward's (one a call of its three launches)
launches = 0
backward_launches = 0

_fn = _route_fn = None
_bwd_fn = _bwd_route_fn = None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, S, H, d) tensors")
    B, S, H, d = q.shape
    if k.shape[:2] != v.shape[:2] or k.shape[0] != B or k.shape[2] != \
            v.shape[2] or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit together")
    kvh = k.shape[2]
    if kvh == 0 or H % kvh:
        raise ValueError(f"{kvh} KV heads do not divide {H} query heads")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 alike, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, return_lse: bool = False):
    """The plain PyTorch version: ``repro/kernels/ref.py``'s materialised
    softmax in float32, with GQA and S != Skv (rows that see no key give 0).
    With ``return_lse`` also the row log-sum-exp of the scaled scores,
    (B, H, S) float32, -inf for a row that sees no key.
    """
    _check(q, k, v)
    s, seen = _scores(q, k, causal)
    if seen is not None:
        p = torch.softmax(s, dim=-1).masked_fill(~seen.any(-1)[:, None], 0.0)
    else:
        p = torch.softmax(s, dim=-1)
    vf = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def _scores(q, k, causal):
    """Scaled scores (B, H, S, Skv) in float32, -inf where the bottom-right
    causal mask hides a key; and the mask (None when not causal)."""
    S, skv = q.shape[1], k.shape[1]
    kf = k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(q.shape[3])
    if not causal:
        return s, None
    qpos = torch.arange(S, device=q.device)[:, None] + (skv - S)
    seen = torch.arange(skv, device=q.device)[None, :] <= qpos
    return s.masked_fill(~seen, -math.inf), seen


def flash_attention_backward_plain(q, k, v, o, lse, do, *, causal=True):
    """(dq, dk, dv) of attention, materialised in float32: P = exp(s - lse)
    (0 where masked or where lse is -inf), Delta = rowsum(dO * o),
    dV = P^T dO, dS = P (dO V^T - Delta), dQ = scale dS K, dK = scale
    dS^T Q, the GQA group's heads summed onto their KV head. Each gradient
    in its input's type."""
    _check(q, k, v)
    B, S, H, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    rep = H // kvh
    s, _ = _scores(q, k, causal)
    lse = lse.float()[..., None]
    p = torch.where(torch.isinf(s) | torch.isinf(lse), 0.0,
                    torch.exp(s - lse))
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]  # (B,H,S,1)
    vf = v.float().repeat_interleave(rep, dim=2)
    kf = k.float().repeat_interleave(rep, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta) / math.sqrt(d)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dvv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    skv = k.shape[1]
    dk = dk.reshape(B, skv, kvh, rep, d).sum(3)
    dvv = dvv.reshape(B, skv, kvh, rep, dv).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def _bind(name: str, n_ptr: int):
    """``<name>_launch`` (``n_ptr`` pointers, then seven ints, the scale,
    causal, the dtype code and the stream) and ``<name>_route`` of the
    library built from ``csrc/<name>.cu``."""
    from ._build import load
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    route_fn = getattr(lib, f"{name}_route")
    route_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    route_fn.restype = ctypes.c_int
    return fn, route_fn


def _lib():
    global _fn, _route_fn
    if _fn is None:
        _fn, _route_fn = _bind("flash_attention", 5)
    return _fn


def _bwd_lib():
    global _bwd_fn, _bwd_route_fn
    if _bwd_fn is None:
        _bwd_fn, _bwd_route_fn = _bind("flash_attention_bwd", 10)
    return _bwd_fn


def _ask_route(route_fn, q, k, v) -> str:
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return "wgmma" if route_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               q.shape[3], v.shape[3], k.shape[1],
                               _DTYPE_CODE[q.dtype]) else "fma"


def route(q, k, v) -> str:
    """Which version ``flash_attention`` runs for these inputs: "plain" on
    the CPU; on the GPU "wgmma" (the tensor-core kernel) or "fma" (the
    float32 FMA kernel), as ``csrc/flash_attention.cu`` decides."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return "plain"
    _lib()
    return _ask_route(_route_fn, q, k, v)


def backward_route(q, k, v) -> str:
    """Which version the gradient of ``flash_attention`` runs for these
    inputs: "plain" on the CPU (autograd through the plain version); on the
    GPU "wgmma" or "fma", as ``csrc/flash_attention_bwd.cu`` decides."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return "plain"
    _bwd_lib()
    return _ask_route(_bwd_route_fn, q, k, v)


def _launch(q, k, v, o, causal: bool, lse=None) -> None:
    global launches
    fn = _lib()
    B, S, H, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(),
             B, S, skv, H, kvh, d, dv, 1.0 / math.sqrt(d), int(causal),
             _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({q.dtype}, "
                           f"q {tuple(q.shape)}, k {tuple(k.shape)}, causal "
                           f"{causal}): error {err}")
    launches += 1


def _launch_backward(q, k, v, o, lse, do, dq, dk, dv, causal: bool) -> None:
    global backward_launches
    fn = _bwd_lib()
    B, S, H, d = q.shape
    skv, kvh, dvd = k.shape[1], k.shape[2], v.shape[3]
    if do.data_ptr() % 16:             # TMA reads rows from 16-byte bases
        do = do.clone()
    # scratch of the kernels: Delta and lse * log2 e, (B, H, S) each with the
    # rows padded to whole 128-row tiles
    scratch = torch.empty(2 * B * H * (-(-S // 128) * 128),
                          dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), do.data_ptr(), scratch.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, skv, H,
             kvh, d, dvd, 1.0 / math.sqrt(d), int(causal),
             _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed "
                           f"({q.dtype}, q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, causal {causal}): error {err}")
    backward_launches += 1


class FlashAttention(torch.autograd.Function):
    """Attention on the kernels with its gradient: the forward kernel writes
    o and lse, the backward kernel gives dq, dk and dv from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        B, S, H, _ = q.shape
        o = torch.empty((B, S, H, v.shape[3]), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        if o.numel():
            _launch(q, k, v, o, causal, lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if q.numel() and k.numel():
            _launch_backward(q, k, v, o, lse, do.contiguous(), dq, dk, dv,
                             ctx.causal)
        else:
            for t in (dq, dk, dv):
                t.zero_()
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, S, H, d) over k, v (B, Skv, KVH, d|dv).

    CPU tensors take the plain version; a CUDA tensor launches the kernel or
    raises, through ``FlashAttention`` when a gradient is needed. Returns
    (B, S, H, dv) in q's type.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if max(q.shape[3], v.shape[3]) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {q.shape[3]} and {v.shape[3]}")
    if q.shape[0] * q.shape[2] > 65535 or max(q.shape[1], k.shape[1]) >= 2**30:
        raise ValueError("flash_attention takes B * H <= 65535 and sequences "
                         "below 2^30")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    B, S, H, _ = q.shape
    o = torch.empty((B, S, H, v.shape[3]), dtype=q.dtype, device=q.device)
    if o.numel():
        _launch(q, k, v, o, causal)
    return o
