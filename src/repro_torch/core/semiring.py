"""Generalized semiring support (CombBLAS 2.0 §1 "User-Defined Operations").

A semiring here is ``(add-monoid, mul)`` where the add monoid carries its
identity (the sparse "zero": entries equal to it are *not stored*) and an
optional ``tag`` naming a reduction the segmented-reduce kernel implements.
Heterogeneous algebras are supported directly: ``mul`` may accept two
different dtypes and produce a third; the add monoid only ever sees the
output type.

Any torch callable works as ``add``/``mul``; tagged monoids additionally get
the segmented-reduce kernel (``kernels/segreduce.py``) on the GPU, and the
four algebras of the dense-tile kernel (``kernels/semiring_matmul.py``) get
it in ``dense_semiring_matmul``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..kernels import segreduce as _segreduce
from ..kernels import semiring_matmul as _smm

_FAST_TAGS = ("sum", "min", "max")


@dataclasses.dataclass(frozen=True)
class Monoid:
    """Associative, commutative binary op with identity.

    ``tag`` ∈ {'sum','min','max',None}: names a reduction the segmented
    reduce implements natively. ``None`` selects the generic sorted
    segmented-scan path, which accepts *any* associative torch op.
    """

    op: Callable[[Any, Any], Any]
    identity: Any
    tag: str | None = None
    name: str = "monoid"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Monoid({self.name}, tag={self.tag})"


@dataclasses.dataclass(frozen=True)
class Semiring:
    """``add`` is a Monoid over the output set; ``mul`` maps (a, b) -> c.

    ``add.identity`` must annihilate ``mul`` (mul(zero, x) == zero) for
    implicit sparse zeros to be correct — the classical GraphBLAS contract.
    """

    add: Monoid
    mul: Callable[[Any, Any], Any]
    name: str = "semiring"

    def out_dtype(self, a_dtype, b_dtype) -> torch.dtype:
        """Result dtype of ``mul`` under torch promotion (heterogeneous OK),
        from 0-d tensors on the meta device — nothing is computed."""
        a = torch.empty((), dtype=a_dtype, device="meta")
        b = torch.empty((), dtype=b_dtype, device="meta")
        return self.mul(a, b).dtype

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Semiring({self.name})"


# --------------------------------------------------------------------------
# Standard monoids / semirings
# --------------------------------------------------------------------------

PLUS = Monoid(torch.add, 0, "sum", "plus")
MIN = Monoid(torch.minimum, math.inf, "min", "min")
MAX = Monoid(torch.maximum, -math.inf, "max", "max")
MIN_INT = Monoid(torch.minimum, 2**31 - 1, "min", "min_int")
MAX_INT = Monoid(torch.maximum, -(2**31) + 1, "max", "max_int")
LOR = Monoid(torch.logical_or, False, "max", "lor")  # or == max over bool
LAND = Monoid(torch.logical_and, True, "min", "land")
TIMES_MONOID = Monoid(torch.mul, 1, None, "times")


def _select2nd(a, b):
    del a
    return b


ARITHMETIC = Semiring(PLUS, torch.mul, "plus_times")
BOOLEAN = Semiring(LOR, torch.logical_and, "lor_land")
MIN_PLUS = Semiring(MIN, torch.add, "min_plus")          # tropical / shortest path
MAX_PLUS = Semiring(MAX, torch.add, "max_plus")
MAX_MIN = Semiring(MAX, torch.minimum, "max_min")        # bottleneck paths
MIN_MAX = Semiring(MIN, torch.maximum, "min_max")
MIN_SELECT2ND = Semiring(MIN, _select2nd, "min_select2nd")      # BFS parents
MAX_SELECT2ND = Semiring(MAX, _select2nd, "max_select2nd")
MIN_INT_SELECT2ND = Semiring(MIN_INT, _select2nd, "min_int_select2nd")
PLUS_FIRST = Semiring(PLUS, lambda a, b: a, "plus_first")
PLUS_SECOND = Semiring(PLUS, _select2nd, "plus_second")
PLUS_PAIR = Semiring(PLUS, lambda a, b: torch.ones_like(a), "plus_pair")


def semiring(add_op, add_identity, mul_op, *, tag=None, name="user") -> Semiring:
    """Construct a user-defined semiring from plain callables."""
    return Semiring(Monoid(add_op, add_identity, tag, name + "_add"), mul_op, name)


# --------------------------------------------------------------------------
# Segment reduction under an arbitrary monoid
# --------------------------------------------------------------------------

def _segmented_scan_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                           num_segments: int, monoid: Monoid) -> torch.Tensor:
    """Generic path: values sorted by ``seg_ids``. O(n log n) inclusive scan.

    combine((k1,v1),(k2,v2)) = (k2, add(v1,v2) if k1==k2 else v2) is
    associative when the sequence is sorted by key; a Hillis-Steele scan
    applies it at distances 1, 2, 4, ..., and the running value at the last
    slot of each segment is the segment reduction.
    """
    n = seg_ids.shape[0]
    scanned = values
    d = 1
    while d < n:
        same = seg_ids[:-d] == seg_ids[d:]
        if values.dim() > 1:
            same = same.reshape(same.shape + (1,) * (values.dim() - 1))
        right = scanned[d:]
        comb = torch.where(same, monoid.op(scanned[:-d], right), right)
        scanned = torch.cat([scanned[:d], comb.to(scanned.dtype)])
        d *= 2
    nxt = torch.cat([seg_ids[1:], seg_ids.new_full((1,), -1)])
    is_last = seg_ids != nxt
    s = int(num_segments)
    out = torch.full((s + 1,) + tuple(values.shape[1:]), monoid.identity,
                     dtype=values.dtype, device=values.device)
    # write each segment's last scanned value; out-of-range ids are dropped
    tgt = torch.where(is_last & (seg_ids >= 0) & (seg_ids < s),
                      seg_ids.long(), s)
    out[tgt] = scanned
    return out[:s]


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, monoid: Monoid, *,
                   sorted_ids: bool = False) -> torch.Tensor:
    """Reduce ``values`` by ``seg_ids`` under ``monoid``.

    ids >= num_segments (padding) are dropped. Tagged monoids go to
    ``kernels/segreduce.segment_reduce`` (the Hopper kernel for CUDA
    tensors, its plain version for CPU tensors), with the ``sorted_ids``
    promise that picks its sorted route; the generic path requires (and if
    needed performs) a sort.
    """
    if monoid.tag in _FAST_TAGS:
        return _segreduce.segment_reduce(
            values, seg_ids, num_segments, monoid.tag,
            identity=None if monoid.tag == "sum" else monoid.identity,
            sorted_ids=sorted_ids)
    if not sorted_ids:
        order = torch.argsort(seg_ids, stable=True)
        seg_ids = seg_ids[order]
        values = values[order]
    return _segmented_scan_reduce(values, seg_ids, num_segments, monoid)


def scatter_onto_identity(values: torch.Tensor, seg_ids: torch.Tensor,
                          num_segments: int, monoid: Monoid) -> torch.Tensor:
    """JAX's ``full(identity).at[ids].add/min/max(values, mode='drop')`` for
    a tagged monoid, on the segmented-reduce kernel.

    ``segment_reduce`` reduces the touched values alone; the JAX scatter
    combines them onto the identity. The two differ only where a value lies
    beyond a declared identity that is not the dtype extreme (a value below
    ``MAX_INT``'s -(2^31)+1), so the identity is combined in afterwards.
    ids outside ``[0, num_segments)`` are dropped; the ids need not be sorted.
    """
    out = segment_reduce(values, seg_ids, num_segments, monoid)
    return monoid.op(torch.tensor(monoid.identity, dtype=out.dtype,
                                  device=out.device), out)


# --------------------------------------------------------------------------
# Dense semiring contraction (the dense-accumulator SpGEMM's multiply)
# --------------------------------------------------------------------------

def _kernel_kind(sr: Semiring) -> str | None:
    """The dense-tile kernel's algebra for ``sr``, read from its parts (never
    its name), or None when no kernel algebra matches."""
    add = sr.add
    if add.tag == "sum" and add.identity == 0 and sr.mul is torch.mul:
        return "plus_times"
    if (add.tag == "min" and add.op is torch.minimum
            and add.identity == math.inf and sr.mul is torch.add):
        return "min_plus"
    if (add.tag == "max" and add.op is torch.maximum
            and add.identity == -math.inf and sr.mul is torch.minimum):
        return "max_min"
    if (add.tag == "max" and add.op is torch.logical_or
            and add.identity is False and sr.mul is torch.logical_and):
        return "or_and"
    return None


def dense_semiring_matmul(a: torch.Tensor, b: torch.Tensor, sr: Semiring,
                          k_chunk: int = 512) -> torch.Tensor:
    """C[i,j] = add_k mul(A[i,k], B[k,j]) for dense A (m,k), B (k,n).

    The four kernel algebras (``_kernel_kind``) go to
    ``kernels/semiring_matmul.semiring_matmul``: the Hopper kernel for CUDA
    tensors, its plain version for CPU tensors. Every other semiring
    (MAX_PLUS, MIN_MAX, the select2nd and pair semirings, user semirings)
    runs the k-chunked broadcast-reduce below on either device, as torch
    ops: it is the JAX package's own pure-JAX path, which no TPU kernel
    covers either, not a fallback of the kernel. Its peak memory is
    m*n*k_chunk elements.
    """
    kind = _kernel_kind(sr)
    if kind is not None:
        return _smm.semiring_matmul(a, b, kind)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    out_dtype = sr.out_dtype(a.dtype, b.dtype)
    ident = torch.tensor(sr.add.identity, dtype=out_dtype, device=a.device)
    nchunk = max(1, -(-k // k_chunk))
    kp = nchunk * k_chunk
    # zero padding to whole chunks; its products are masked to the identity
    a_p = torch.cat([a, a.new_zeros((m, kp - k))], 1)
    b_p = torch.cat([b, b.new_zeros((kp - k, n))], 0)
    kc_pow2 = 1 << max(0, math.ceil(math.log2(k_chunk)))
    out = torch.full((m, n), sr.add.identity, dtype=out_dtype,
                     device=a.device)
    for idx in range(nchunk):
        lo = idx * k_chunk
        prod = sr.mul(a_p[:, lo:lo + k_chunk, None],
                      b_p[None, lo:lo + k_chunk, :]).to(out_dtype)
        kk = lo + torch.arange(k_chunk, device=a.device)
        red = torch.where((kk < k)[None, :, None], prod, ident)
        red = red.expand(m, k_chunk, n)
        if kc_pow2 != k_chunk:
            red = torch.cat([red, ident.expand(m, kc_pow2 - k_chunk, n)], 1)
        # log-depth pairwise tree over the chunk axis
        while red.shape[1] > 1:
            half = red.shape[1] // 2
            red = sr.add.op(red[:, :half, :], red[:, half:, :])
        out = sr.add.op(out, red[:, 0, :])
    return out


def dense_semiring_matvec(a: torch.Tensor, x: torch.Tensor,
                          sr: Semiring) -> torch.Tensor:
    """y[i] = add_k mul(A[i,k], x[k]): ``dense_semiring_matmul`` of ``x`` as
    one column, so the kernel algebras run on the dense-tile kernel."""
    return dense_semiring_matmul(a, x[:, None], sr)[:, 0]
