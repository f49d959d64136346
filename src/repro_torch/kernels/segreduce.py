"""Segmented semiring reduce: the Hopper kernel and its plain version.

Replaces ``repro/kernels/segreduce.py::segment_reduce_pallas``, the one TPU
kernel on the SpGEMM path: the merge engine's run reduction
(``merge._reduce_runs``, ``merge._kv_dedup_window``) and ``COO.reduce`` end
in a segmented reduction of a value stream by segment id, which
``core.semiring.segment_reduce`` hands to ``segment_reduce`` here for every
tagged monoid.

``segment_reduce`` is the wrapper. A tensor on the CPU goes to
``segment_reduce_plain`` (``scatter_reduce_`` plus a touch count); a CUDA
tensor launches the kernel in ``csrc/segreduce.cu`` or raises. The kernel
takes every input the plain version takes on the card: scalar or vector
values (rows reduced element by element), f32/f64/i32/i64/bool, a bool sum
as a logical or. It is bound by memory (a scalar f32 sum moves 8 B per input
and 4 B per segment: ~60 us at N = S = 2^24 on an H100), and this version
makes it right for any id order, not fast: each element combines into its
segment with an atomic, and min/max segments that nothing touched take the
monoid's declared identity here, after the launch, from a touch count the
kernel keeps only when such an identity is given.
"""
from __future__ import annotations

import ctypes
import math

import torch

TAGS = ("sum", "min", "max")
_TAG_CODE = {"sum": 0, "min": 1, "max": 2}
# dtype -> (code in segreduce.cu, ctypes type of the accumulator fill)
_DTYPES = {torch.float32: (0, ctypes.c_float),
           torch.float64: (1, ctypes.c_double),
           torch.int32: (2, ctypes.c_int32),
           torch.int64: (3, ctypes.c_int64),
           torch.bool: (4, ctypes.c_bool)}

# kernel launches since the last reset (the plain path never counts)
launches = 0

_fn = None


def _extreme(tag: str, dtype: torch.dtype):
    """Accumulator fill: 0 for sum, the dtype extreme for min/max."""
    if tag == "sum":
        return False if dtype == torch.bool else 0
    if dtype == torch.bool:
        return tag != "max"                   # lor: False, land: True
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return info.max if tag == "min" else info.min
    return math.inf if tag == "min" else -math.inf


def _check(values, seg_ids, tag):
    if tag not in TAGS:
        raise ValueError(f"tag must be one of {TAGS}, got {tag!r}")
    if seg_ids.dim() != 1 or seg_ids.shape[0] != values.shape[0]:
        raise ValueError(f"seg_ids {tuple(seg_ids.shape)} do not match "
                         f"values {tuple(values.shape)}")
    if seg_ids.device != values.device:
        raise ValueError("values and seg_ids lie on different devices")


def _identity(tag: str, identity, like: torch.Tensor):
    """The declared identity as a 0-d tensor of ``like``'s type, or None
    when nothing is substituted (a sum, or no identity). Raises, as the JAX
    package does, when the identity does not fit the type (inf on ints)."""
    if tag == "sum" or identity is None:
        return None
    return torch.as_tensor(identity, dtype=like.dtype, device=like.device)


def _substitute_identity(out, touched, ident):
    """Untouched min/max segments hold ``ident`` (the monoid's declared
    identity, which may differ from the dtype extreme: MAX_INT's -(2^31)+1);
    with no identity they keep the accumulator fill, and untouched sum
    segments keep 0."""
    if ident is None:
        return out
    hit = touched > 0
    if out.dim() > 1:
        hit = hit.reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(hit, out, ident)


def segment_reduce_plain(values: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int, tag: str, *, identity=None):
    """The plain PyTorch version: ``scatter_reduce_`` plus a touch count.

    Takes any value shape ``(N, *vdims)`` and any device. ids outside
    ``[0, S)`` are dropped (sent to a spare slot past the end). A bool sum
    is a logical or.
    """
    _check(values, seg_ids, tag)
    ident = _identity(tag, identity, values)
    s = int(num_segments)
    dev = values.device
    keep = (seg_ids >= 0) & (seg_ids < s)
    idx = torch.where(keep, seg_ids.long(), s)
    touched = torch.zeros(s + 1, dtype=torch.int32, device=dev).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))[:s]
    # scatter_reduce_ has no bool on CUDA: reduce bools as 0/1 int32 (the
    # fill keeps the bool extreme) and convert back
    is_bool = values.dtype == torch.bool
    vals = values.to(torch.int32) if is_bool else values
    out = torch.full((s + 1,) + tuple(values.shape[1:]),
                     _extreme(tag, values.dtype), dtype=vals.dtype, device=dev)
    if vals.dim() > 1:
        idx = idx.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[tag]
    out = out.scatter_reduce_(0, idx, vals, reduce, include_self=True)[:s]
    if is_bool:
        out = out.bool()
    return _substitute_identity(out, touched, ident)


def _launch(values, seg_ids, s, tag, count_touches):
    """One launch of the kernel over ``values`` (N, D) contiguous and int32
    ids; the touch count is kept only when ``count_touches``."""
    global _fn, launches
    if _fn is None:
        from ._build import load
        fn = load("segreduce").segreduce_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    code, ctype = _DTYPES[values.dtype]
    n, d = values.shape
    out = torch.empty((s, d), dtype=values.dtype, device=values.device)
    touched = (torch.empty(s, dtype=torch.int32, device=values.device)
               if count_touches else None)
    fill = ctype(_extreme(tag, values.dtype))
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _fn(values.data_ptr(), seg_ids.data_ptr(), n, d, out.data_ptr(),
              None if touched is None else touched.data_ptr(), s,
              _TAG_CODE[tag], code, ctypes.addressof(fill), stream)
    if err != 0:
        raise RuntimeError(f"segreduce kernel launch failed: CUDA error {err}")
    launches += 1
    return out, touched


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, tag: str, *, identity=None):
    """Segmented reduce of ``values`` (N, *vdims) by ``seg_ids`` (N,).

    ids outside ``[0, num_segments)`` are dropped; untouched segments hold
    ``identity`` for min/max (the dtype extreme when it is None) and 0 for
    sum — what ``repro``'s ``segment_reduce_pallas`` returns for scalars.
    The ids need not be sorted. CPU tensors take the plain version; a CUDA
    tensor launches the kernel or raises.
    """
    _check(values, seg_ids, tag)
    if values.device.type == "cpu":
        return segment_reduce_plain(values, seg_ids, num_segments, tag,
                                    identity=identity)
    if values.device.type != "cuda":
        raise ValueError(f"segreduce runs on cpu or cuda, not {values.device}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"the segreduce kernel takes {list(_DTYPES)}, "
                        f"not {values.dtype}")
    ident = _identity(tag, identity, values)
    if values.dtype == torch.bool and tag == "sum":
        tag = "max"                     # a bool sum is a logical or
    s = int(num_segments)
    if seg_ids.dtype != torch.int32:
        # the kernel reads int32 ids; out-of-range ids must stay out of range
        keep = (seg_ids >= 0) & (seg_ids < s)
        seg_ids = torch.where(keep, seg_ids, -1).to(torch.int32)
    vdims = tuple(values.shape[1:])
    rows = values.reshape(values.shape[0], math.prod(vdims)).contiguous()
    out, touched = _launch(rows, seg_ids.contiguous(), s, tag,
                           count_touches=ident is not None)
    return _substitute_identity(out.reshape((s,) + vdims), touched, ident)
