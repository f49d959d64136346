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

Gradients: on a CUDA tensor that needs one the wrapper goes through
``BsrSpmm``, an autograd Function whose backward is two more blocked-ELL
products on the same kernel (the TPU kernel has none: the JAX package
differentiates its einsum twin). For ``y = A @ x``:
``dvals[r, t] = dy[r] @ x[c]^T`` (c = ``block_cols[r, t]``) is R * K
block-rows of one block ``dy[r]`` with id c over x's blocks transposed;
``dx[c] = sum over (r, t) naming c of vals[r, t]^T @ dy[r]`` is A^T in
blocked-ELL form, a block-row per column block, its width the most pairs
that name one block (one host read a backward call), over dy. An id of -1
gives no gradient, an id past x's last block sends its gradient to the last
block, and a column block that no pair names gets zeros.
``bsr_spmm_backward_plain`` is the loop the products are held against.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

# dtype -> code in bsr_spmm.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (the plain path never counts); the
# gradients' products count in both
launches = 0
backward_launches = 0

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


def _kernel_product(cols, vals, x, out) -> torch.Tensor:
    """The kernel's y = A @ x, its operands cast to ``out``."""
    R, K, bm, bk = vals.shape
    if max(R, bm, bk, x.shape[0], x.shape[1]) >= 2**31 or \
            -(-bm // 64) > 65535 or R > 65535:
        raise ValueError(f"bsr_spmm takes R <= 65535, bm <= 64 * 65535 and "
                         f"dimensions below 2^31, got {tuple(vals.shape)}"
                         f" and {tuple(x.shape)}")
    cols = cols.to(torch.int32).contiguous()
    vals = vals.to(out).contiguous()
    x = x.to(out).contiguous()
    y = torch.empty((R * bm, x.shape[1]), dtype=out, device=x.device)
    if y.numel():
        _launch(cols, vals, x, y)
    return y


def _transposed(block_cols, block_vals, nblk):
    """A^T in blocked-ELL form: (cols (nblk, K'), vals (nblk, K', bk, bm)),
    block-row c holding vals[r, t]^T with id r for every (r, t) whose id,
    clipped to the last block, is c, in ascending (r, t); -1 and zeros pad.
    K' is read on the host: the one read of a backward call. Padding
    entries go to a block-row past the last, dropped at the end."""
    R, K, bm, bk = block_vals.shape
    flat = block_cols.reshape(-1).long()
    col = torch.where(flat >= 0, flat.clamp(max=nblk - 1), nblk)
    col, entry = torch.sort(col, stable=True)
    count = torch.bincount(col, minlength=nblk + 1)
    width = int(count[:nblk].max())
    start = torch.cumsum(count, 0) - count
    real = col < nblk
    slot = torch.where(real, torch.arange(R * K, device=flat.device)
                       - start[col], 0)
    cols_t = torch.full((nblk + 1, max(width, 1)), -1, dtype=torch.int32,
                        device=flat.device)
    cols_t[col, slot] = torch.where(real, entry // K, -1).to(torch.int32)
    vals_t = torch.zeros((nblk + 1, max(width, 1), bk, bm),
                         dtype=block_vals.dtype, device=flat.device)
    vals_t[col, slot] = block_vals.reshape(R * K, bm, bk)[entry] \
        .transpose(1, 2)
    return cols_t[:nblk, :width], vals_t[:nblk, :width]


def _backward_products(cols, vals, x, dy, need_vals, need_x):
    """(dvals, dx) of y = A @ x from dy on the kernel (None where not
    needed), in the kernel's output type."""
    global backward_launches
    R, K, bm, bk = vals.shape
    n = x.shape[1]
    nblk = x.shape[0] // bk
    out = dy.dtype
    dvals = dx = None
    if need_vals:
        # R * K block-rows of one block dy[r] (bm x n) named c, over x's
        # blocks transposed: (nblk * n, bk)
        dyv = dy.reshape(R, 1, bm, n).expand(R, K, bm, n) \
            .reshape(R * K, 1, bm, n)
        xt = x.reshape(nblk, bk, n).transpose(1, 2).reshape(nblk * n, bk)
        dvals = _kernel_product(cols.reshape(R * K, 1), dyv, xt, out) \
            .reshape(R, K, bm, bk)
        backward_launches += 1
    if need_x:
        cols_t, vals_t = _transposed(cols, vals, nblk)
        if cols_t.shape[1] == 0:
            dx = torch.zeros((nblk * bk, n), dtype=out, device=dy.device)
        else:
            dx = _kernel_product(cols_t, vals_t, dy, out)
            backward_launches += 1
    return dvals, dx


def bsr_spmm_backward_plain(block_cols, block_vals, x, dy):
    """(dvals, dx) of y = A @ x: the loop over the K stored blocks of every
    row, in float32, each gradient in its input's type. An id of -1 gives
    none; an id past x's last block sends its gradient to the last block;
    a column block no (r, t) names gets zeros."""
    _check(block_cols, block_vals, x)
    R, K, bm, bk = block_vals.shape
    n = x.shape[1]
    nblk = x.shape[0] // bk
    xb = x.reshape(nblk, bk, n).float()
    dyb = dy.reshape(R, bm, n).float()
    dvals = torch.zeros((R, K, bm, bk), dtype=torch.float32, device=x.device)
    dx = torch.zeros((nblk, bk, n), dtype=torch.float32, device=x.device)
    for t in range(K):
        cols = block_cols[:, t].long()
        real = cols >= 0
        c = cols.clamp(0, nblk - 1)
        dvals[:, t] = torch.where(real[:, None, None],
                                  torch.bmm(dyb, xb[c].transpose(1, 2)), 0.0)
        part = torch.bmm(block_vals[:, t].float().transpose(1, 2), dyb)
        dx.index_add_(0, c[real], part[real])
    return dvals.to(block_vals.dtype), dx.reshape(nblk * bk, n).to(x.dtype)


class BsrSpmm(torch.autograd.Function):
    """y = A @ x on the kernel, with both gradients on the kernel too."""

    @staticmethod
    def forward(ctx, block_cols, block_vals, x):
        out = torch.promote_types(block_vals.dtype, x.dtype)
        ctx.save_for_backward(block_cols, block_vals, x)
        return _kernel_product(block_cols, block_vals, x, out)

    @staticmethod
    def backward(ctx, dy):
        cols, vals, x = ctx.saved_tensors
        out = dy.dtype
        dvals, dx = _backward_products(
            cols, vals.to(out), x.to(out), dy.contiguous(),
            ctx.needs_input_grad[1], ctx.needs_input_grad[2])
        return (None, None if dvals is None else dvals.to(vals.dtype),
                None if dx is None else dx.to(x.dtype))


def bsr_spmm(block_cols: torch.Tensor, block_vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for A in blocked-ELL form. Returns (R * bm, n).

    CPU tensors take the plain version; a CUDA tensor launches the kernel or
    raises, through ``BsrSpmm`` when a gradient is needed.
    """
    out = _check(block_cols, block_vals, x)
    if x.device.type == "cpu":
        return bsr_spmm_plain(block_cols, block_vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and (block_vals.requires_grad
                                    or x.requires_grad):
        return BsrSpmm.apply(block_cols, block_vals, x)
    return _kernel_product(block_cols, block_vals, x, out)


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
