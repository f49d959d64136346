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

Numerics follow the Pallas kernel: scores, running max, denominator and
accumulator in float32, ``p`` rounded to v's type before the PV product,
the output divided by ``max(l, 1e-30)`` and rounded once to q's type.
bf16 with d == dv in {64, 128} (the models' heads) runs on Hopper's tensor
cores (wgmma fed by TMA, 128 query rows a block); float32, other head dims
and MLA's d != dv run a float32 FMA kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

# dtype -> code in flash_attention.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

# kernel launches since the last reset (the plain path never counts)
launches = 0

_fn = None


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
                          *, causal: bool = True) -> torch.Tensor:
    """The plain PyTorch version: ``repro/kernels/ref.py``'s materialised
    softmax in float32, with GQA and S != Skv (rows that see no key give 0).
    """
    _check(q, k, v)
    B, S, H, d = q.shape
    skv = k.shape[1]
    rep = H // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (skv - S)
        seen = torch.arange(skv, device=q.device)[None, :] <= qpos
        s = s.masked_fill(~seen, -math.inf)
        p = torch.softmax(s, dim=-1).masked_fill(~seen.any(-1)[:, None], 0.0)
    else:
        p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _launch(q, k, v, o, causal: bool) -> None:
    global _fn, launches
    if _fn is None:
        from ._build import load
        fn = load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    B, S, H, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              B, S, skv, H, kvh, d, dv, 1.0 / math.sqrt(d), int(causal),
              _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({q.dtype}, "
                           f"q {tuple(q.shape)}, k {tuple(k.shape)}, causal "
                           f"{causal}): error {err}")
    launches += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, S, H, d) over k, v (B, Skv, KVH, d|dv).

    CPU tensors take the plain version; a CUDA tensor launches the kernel or
    raises. Returns (B, S, H, dv) in q's type.
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
    B, S, H, _ = q.shape
    o = torch.empty((B, S, H, v.shape[3]), dtype=q.dtype, device=q.device)
    if o.numel():
        _launch(q, k, v, o, causal)
    return o
