"""Blocked-ELL sparse x dense product: the Hopper kernel and its plain version.

Replaces ``repro/kernels/bsr_spmm.py::bsr_spmm``, the TPU kernel of the SpMM
offload and of the MoE experts: a block-diagonal A makes it a grouped
matmul. The port's ``models.layers._expert_ffn`` runs each expert product
through here, one call per weight matrix.

Format: block-row r of A stores K dense (bm x bk) blocks ``block_vals[r, t]``
with block-column ids ``block_cols[r, t]``; an id of -1 is padding and
contributes zero. ``y = A @ x`` for x of (n_cols, n), n_cols a multiple of
bk; y is (R * bm, n) in ``promote_types(block_vals, x)``.

``bsr_spmm`` is the wrapper. A tensor on the CPU goes to ``bsr_spmm_plain``;
a CUDA tensor launches the kernel in ``csrc/bsr_spmm.cu`` or raises. The
kernel takes any bm, bk and n (the Pallas kernel asks n to divide its
tile), float32 or bfloat16 (mixed inputs are cast to the output type
first), and sums in float32 with one rounding at the store. An id past x's
last block reads the last block, as ``ref.bsr_spmm``'s clip does. bf16
with bk and n multiples of 8 (the experts' shapes) runs on Hopper's tensor
cores (wgmma fed by TMA; a tile shaped for bm <= 64 at decode); float32 and
other bf16 shapes run a float32 FMA kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

# dtype -> code in bsr_spmm.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (the plain path never counts)
launches = 0

_fn = None


def _check(block_cols: torch.Tensor, block_vals: torch.Tensor,
           x: torch.Tensor) -> torch.dtype:
    if block_vals.dim() != 4 or block_cols.dim() != 2 or x.dim() != 2 or \
            tuple(block_cols.shape) != tuple(block_vals.shape[:2]):
        raise ValueError(f"bsr_spmm takes block_cols (R, K), block_vals "
                         f"(R, K, bm, bk) and x (n_cols, n); got "
                         f"{tuple(block_cols.shape)}, "
                         f"{tuple(block_vals.shape)}, {tuple(x.shape)}")
    bk = block_vals.shape[3]
    if bk == 0 or x.shape[0] % bk or x.shape[0] == 0:
        raise ValueError(f"x has {x.shape[0]} rows, not a positive multiple "
                         f"of bk = {bk}")
    if block_cols.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"block_cols must be int32 or int64, not "
                        f"{block_cols.dtype}")
    out = torch.promote_types(block_vals.dtype, x.dtype)
    if out not in _DTYPE_CODE:
        raise TypeError(f"bsr_spmm takes float32 or bfloat16, not {out}")
    if not (block_cols.device == block_vals.device == x.device):
        raise ValueError("block_cols, block_vals and x lie on different "
                         "devices")
    return out


def bsr_spmm_plain(block_cols: torch.Tensor, block_vals: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``repro/kernels/ref.py``'s loop over the K
    stored blocks of every row, summed in float32 and rounded once."""
    out = _check(block_cols, block_vals, x)
    R, K, bm, bk = block_vals.shape
    n = x.shape[1]
    nblk = x.shape[0] // bk
    xb = x.reshape(nblk, bk, n)
    y = torch.zeros((R, bm, n), dtype=torch.float32, device=x.device)
    for t in range(K):
        cols = block_cols[:, t].long()
        xs = xb[cols.clamp(0, nblk - 1)].float()              # (R, bk, n)
        contrib = torch.bmm(block_vals[:, t].float(), xs)
        y += torch.where((cols >= 0)[:, None, None], contrib, 0.0)
    return y.to(out).reshape(R * bm, n)


def _launch(cols, vals, x, y) -> None:
    global _fn, launches
    if _fn is None:
        from ._build import load
        fn = load("bsr_spmm").bsr_spmm_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    R, K, bm, bk = vals.shape
    n = x.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
              R, K, bm, bk, n, x.shape[0] // bk, _DTYPE_CODE[y.dtype], stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed ({y.dtype}, "
                           f"R={R} K={K} bm={bm} bk={bk} n={n}): error {err}")
    launches += 1


def bsr_spmm(block_cols: torch.Tensor, block_vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for A in blocked-ELL form. Returns (R * bm, n).

    CPU tensors take the plain version; a CUDA tensor launches the kernel or
    raises.
    """
    out = _check(block_cols, block_vals, x)
    if x.device.type == "cpu":
        return bsr_spmm_plain(block_cols, block_vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm runs on cpu or cuda, not {x.device}")
    R, K, bm, bk = block_vals.shape
    if max(R, bm, bk, x.shape[0], x.shape[1]) >= 2**31 or \
            -(-bm // 64) > 65535 or R > 65535:
        raise ValueError(f"bsr_spmm takes R <= 65535, bm <= 64 * 65535 and "
                         f"dimensions below 2^31, got {tuple(block_vals.shape)}"
                         f" and {tuple(x.shape)}")
    cols = block_cols.to(torch.int32).contiguous()
    vals = block_vals.to(out).contiguous()
    x = x.to(out).contiguous()
    y = torch.empty((R * bm, x.shape[1]), dtype=out, device=x.device)
    if y.numel():
        _launch(cols, vals, x, y)
    return y


def to_blocked_ell(dense: np.ndarray, bm: int, bk: int,
                   max_blocks: int | None = None):
    """Host helper: dense (M, N) -> (block_cols, block_vals) in numpy
    (own copy of ``repro/kernels/bsr_spmm.py::to_blocked_ell``)."""
    M, N = dense.shape
    if M % bm or N % bk:
        raise ValueError(f"({M}, {N}) is not a multiple of ({bm}, {bk})")
    R, C = M // bm, N // bk
    blocks = dense.reshape(R, bm, C, bk).transpose(0, 2, 1, 3)
    nz = blocks.any(axis=(2, 3))
    K = max_blocks or max(int(nz.sum(1).max()), 1)
    cols = np.full((R, K), -1, np.int32)
    vals = np.zeros((R, K, bm, bk), dense.dtype)
    for r in range(R):
        js = np.nonzero(nz[r])[0][:K]
        cols[r, :len(js)] = js
        vals[r, :len(js)] = blocks[r, js]
    return cols, vals
