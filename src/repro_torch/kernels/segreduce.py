"""Segmented semiring reduce: the Hopper kernel and its plain version.

Replaces ``repro/kernels/segreduce.py::segment_reduce_pallas``, the one TPU
kernel on the SpGEMM path: the merge engine's run reduction
(``merge._reduce_runs``, ``merge._kv_dedup_window``) and ``COO.reduce`` end
in a segmented reduction of a value stream by segment id, which
``core.semiring.segment_reduce`` hands to ``segment_reduce`` here for every
tagged monoid.

``segment_reduce`` is the wrapper. A tensor on the CPU goes to
``segment_reduce_plain`` (``scatter_reduce_`` plus a touch count); a CUDA
tensor launches a kernel of ``csrc/segreduce.cu`` or raises. ``route()``
names which:

- ``"sorted"``: scalar values whose caller promises non-decreasing ids
  (``sorted_ids=True``; every merge-engine call does). An atomic-free
  segmented reduce over the runs of equal ids that reads each in-range
  input once, skips the padding tail unread, writes each output slot once
  (untouched slots take the declared identity in the same pass) and gives
  the same bits from launch to launch. A descent in the ids sets a device
  flag that ``descents()`` reads, without a host sync on the launch.
- ``"atomic"``: any id order and vector values (rows of D elements): an
  init pass, then one atomic per element; min/max segments that nothing
  touched take the declared identity after the launch, from a touch count.

Both take f32/f64/i32/i64/bool values, a bool sum as a logical or. The
kernel is bound by memory (a scalar f32 sum moves 8 B per input and 4 B per
segment: ~60 us at N = S = 2^24 on an H100).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import refuse_grad

TAGS = ("sum", "min", "max")
_TAG_CODE = {"sum": 0, "min": 1, "max": 2}
# dtype -> (code in segreduce.cu, ctypes type of the accumulator fill)
_DTYPES = {torch.float32: (0, ctypes.c_float),
           torch.float64: (1, ctypes.c_double),
           torch.int32: (2, ctypes.c_int32),
           torch.int64: (3, ctypes.c_int64),
           torch.bool: (4, ctypes.c_bool)}

# kernel launches since the last reset, in all and by route (the plain path
# never counts)
launches = 0
route_launches = {"sorted": 0, "atomic": 0}

_fn = None
_sorted_fns = None
_descent_flags: dict[torch.device, torch.Tensor] = {}


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


def _check_sorted(seg_ids: torch.Tensor, s: int):
    """Raise unless ``seg_ids``, clamped to [-1, S], never descend: the
    promise a caller makes with ``sorted_ids=True``."""
    c = seg_ids.clamp(-1, s)
    if c.numel() > 1 and bool((c[1:] < c[:-1]).any()):
        at = int(torch.nonzero(c[1:] < c[:-1])[0, 0])
        raise ValueError(f"sorted_ids=True, but seg_ids descend at {at}: "
                         f"{int(c[at])} then {int(c[at + 1])}")


def route(dtype: torch.dtype, d: int, sorted_ids: bool) -> str:
    """The kernel a CUDA call takes: ``"sorted"`` for scalar values
    (``d == 1``, the product of the value dims) with ``sorted_ids``, else
    ``"atomic"``."""
    if dtype not in _DTYPES:
        raise TypeError(f"the segreduce kernel takes {list(_DTYPES)}, "
                        f"not {dtype}")
    return "sorted" if sorted_ids and d == 1 else "atomic"


def _narrow_ids(seg_ids: torch.Tensor, s: int, sorted_route: bool):
    """The int32 ids the kernel reads. Out-of-range ids stay out of range:
    the sorted route clamps them (< 0 to -1, >= S to S), which keeps a
    sorted stream sorted; the atomic route maps them to -1."""
    if seg_ids.dtype == torch.int32:
        return seg_ids
    if sorted_route:
        return seg_ids.clamp(-1, s).to(torch.int32)
    keep = (seg_ids >= 0) & (seg_ids < s)
    return torch.where(keep, seg_ids, -1).to(torch.int32)


def segment_reduce_plain(values: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int, tag: str, *, identity=None,
                         sorted_ids: bool = False):
    """The plain PyTorch version: ``scatter_reduce_`` plus a touch count.

    Takes any value shape ``(N, *vdims)`` and any device. ids outside
    ``[0, S)`` are dropped (sent to a spare slot past the end). A bool sum
    is a logical or. With ``sorted_ids`` it raises ``ValueError`` when the
    ids, clamped to [-1, S], descend; the values are the same either way.
    """
    _check(values, seg_ids, tag)
    if sorted_ids:
        _check_sorted(seg_ids, int(num_segments))
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
    """One launch of the atomic kernel over ``values`` (N, D) contiguous and
    int32 ids; the touch count is kept only when ``count_touches``."""
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
    route_launches["atomic"] += 1
    return out, touched


def _descent_flag(device: torch.device) -> torch.Tensor:
    flag = _descent_flags.get(device)
    if flag is None:
        flag = _descent_flags[device] = torch.zeros(1, dtype=torch.int32,
                                                    device=device)
    return flag


def descents() -> int:
    """1 when a sorted-route launch since the last ``reset_descents()`` saw
    its ids descend (a caller broke its ``sorted_ids`` promise), else 0.
    Reads the device flags, so it synchronizes; the launches never do."""
    return max((int(f.item()) for f in _descent_flags.values()), default=0)


def reset_descents() -> None:
    for flag in _descent_flags.values():
        flag.zero_()


def _gap_value(tag: str, identity, dtype: torch.dtype):
    """What a sorted-route slot that no id names holds: the declared
    identity for min/max (the dtype extreme when it is None), 0 for a sum.
    Converted on the host, so a Python identity costs no device sync; an
    identity that does not fit the type raises, as in ``_identity``."""
    if tag == "sum" or identity is None:
        return _extreme(tag, dtype)
    return torch.as_tensor(identity, dtype=dtype, device="cpu").item()


def _launch_sorted(values, seg_ids, s, tag, gap):
    """One launch of the sorted route over scalar ``values`` (N,)
    contiguous and int32 ids that do not descend once clamped to [-1, S];
    slots that no id names take ``gap``."""
    global _sorted_fns, launches
    if _sorted_fns is None:
        from ._build import load
        lib = load("segreduce")
        fn = lib.segreduce_sorted_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size = lib.segreduce_sorted_scratch_bytes
        size.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        size.restype = ctypes.c_longlong
        _sorted_fns = fn, size
    fn, size = _sorted_fns
    code, ctype = _DTYPES[values.dtype]
    n = values.shape[0]
    dev = values.device
    out = torch.empty(s, dtype=values.dtype, device=dev)
    if s == 0:
        return out
    scratch = torch.empty(size(n, s, code), dtype=torch.uint8, device=dev)
    ident = ctype(_extreme(tag, values.dtype))
    gap = ctype(gap)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(values.data_ptr(), seg_ids.data_ptr(), n, s, out.data_ptr(),
             scratch.data_ptr(), _TAG_CODE[tag], code, ctypes.addressof(ident),
             ctypes.addressof(gap), _descent_flag(dev).data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segreduce kernel launch failed: CUDA error {err}")
    launches += 1
    route_launches["sorted"] += 1
    return out


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, tag: str, *, identity=None,
                   sorted_ids: bool = False):
    """Segmented reduce of ``values`` (N, *vdims) by ``seg_ids`` (N,).

    ids outside ``[0, num_segments)`` are dropped; untouched segments hold
    ``identity`` for min/max (the dtype extreme when it is None) and 0 for
    sum — what ``repro``'s ``segment_reduce_pallas`` returns for scalars.
    ``sorted_ids`` promises that the ids, clamped to [-1, num_segments],
    never descend: scalar values then take the sorted route (see
    ``route``); the plain version raises when the promise is broken. CPU
    tensors take the plain version; a CUDA tensor launches a kernel or
    raises.
    """
    _check(values, seg_ids, tag)
    if values.device.type == "cpu":
        return segment_reduce_plain(values, seg_ids, num_segments, tag,
                                    identity=identity, sorted_ids=sorted_ids)
    if values.device.type != "cuda":
        raise ValueError(f"segreduce runs on cpu or cuda, not {values.device}")
    refuse_grad("segreduce", "nothing differentiates a segmented reduce, "
                "in either package", values)
    vdims = tuple(values.shape[1:])
    which = route(values.dtype, math.prod(vdims), sorted_ids)
    s = int(num_segments)
    if which == "sorted":
        if s > 2**31 - 2:
            raise ValueError(f"the sorted route takes fewer than 2^31 - 1 "
                             f"segments (int32 ids), not {s}")
        gap = _gap_value(tag, identity, values.dtype)
        if values.dtype == torch.bool and tag == "sum":
            tag = "max"                 # a bool sum is a logical or
        ids = _narrow_ids(seg_ids, s, sorted_route=True).contiguous()
        out = _launch_sorted(values.reshape(-1).contiguous(), ids, s, tag,
                             gap)
        return out.reshape((s,) + vdims)
    ident = _identity(tag, identity, values)
    if values.dtype == torch.bool and tag == "sum":
        tag = "max"                     # a bool sum is a logical or
    rows = values.reshape(values.shape[0], math.prod(vdims)).contiguous()
    out, touched = _launch(rows, _narrow_ids(seg_ids, s, False).contiguous(),
                           s, tag, count_touches=ident is not None)
    return _substitute_identity(out.reshape((s,) + vdims), touched, ident)
