"""Output masks for SpGEMM — GraphBLAS C⟨M⟩ semantics, pushed down.

CombBLAS 2.0's application wins (masked triangle counting, HipMCL pruning)
come from discarding non-mask products *during* the multiply, not after it:

  **MaskSpec** — the user-facing description of an output mask:
    - *structural*  keep C entries whose (row, col) is stored in a mask
                    matrix M (tile-aligned with C — no communication);
    - *vector*      keep SpMSpV output rows whose entry of a dense vector
                    (piece-aligned with y) satisfies ``pred``;
    - *complement*  keep entries NOT stored in M;
    - *pred*        sub-select which stored M entries count as members;
    - *val_pred*    a predicate over the OUTPUT values, applied in the
                    merge pipeline's final compaction (fused select).

  **LocalMask** — the per-tile representation: the mask tile's (row, col)
  pairs packed into ONE sorted integer key array (the merge engine's
  ``pack_keys``), plus an optional ``allow`` payload for value-predicate
  sub-selection. Membership of a candidate is one ``searchsorted`` against
  the mask keys — O(log nnz(M)) per candidate, no densification.

Expanded products are filtered against the LocalMask *before any merge
stage*, so the planner can size ``out_cap`` (and every stage compaction)
from the mask-intersected estimate instead of the full nnz(C).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .coo import COO, SENTINEL, _vmask
from .dist import DistSpMat, DistSpMat3D, DistVec, grid_sum
from .merge import _unpack, key_dtype, pack_keys


@dataclasses.dataclass(frozen=True)
class LocalMask:
    """Sorted packed-key view of one mask tile.

    ``keys`` are ascending with dtype-max padding (the pack_keys contract);
    ``allow`` (optional) marks which mask entries count as members, aligned
    with ``keys``. ``complement`` flips membership for live candidates.
    ``order`` records the key packing ('row'/'col'); probes pack candidates
    with the SAME order.
    """

    keys: torch.Tensor                # (mask_cap,) sorted packed keys
    allow: Optional[torch.Tensor]     # (mask_cap,) bool or None
    complement: bool = False
    order: str = "row"


def local_mask(tile: COO, *, pred: Callable | None = None,
               complement: bool = False, order: str = "row") -> LocalMask:
    """Build a LocalMask from a canonical (deduplicated) mask tile.

    Row-sorted tiles (the §4.3 invariant) pack for free; untagged tiles pay
    one packed argsort of the mask — never of the products it will filter.
    """
    if key_dtype(tile.shape) is None:
        raise ValueError(
            "masked kernels need a packable tile key space "
            f"(shape {tile.shape}); increase the process grid "
            "(paper §1, 32-bit local indices)")
    t = tile if tile.order == order else tile.sort(order)
    keys = pack_keys(t.row, t.col, t.shape, order)
    allow = None
    if pred is not None:
        allow = torch.as_tensor(pred(t.val)).reshape(t.cap, -1).all(dim=-1) \
            & t.mask()
    return LocalMask(keys, allow, complement, order)


def mask_member(keys: torch.Tensor, m: LocalMask) -> torch.Tensor:
    """Vectorized sorted-membership probe.

    ``keys``: packed candidate keys (dtype-max = padding). Returns the KEEP
    flags under the mask semantics: padding is never kept; live candidates
    keep iff stored-and-allowed in the mask (xor complement).
    """
    kmax = torch.iinfo(keys.dtype).max
    mk = m.keys.to(keys.dtype)
    pos = torch.searchsorted(mk, keys)
    posc = pos.clamp(0, mk.shape[0] - 1)
    live = keys != kmax
    hit = (mk[posc] == keys) & live
    if m.allow is not None:
        hit = hit & m.allow[posc]
    return (live & ~hit) if m.complement else hit


def filter_products(rows, cols, vals, shape, m: LocalMask, identity):
    """Drop expanded products failing the mask (pre-merge pushdown).

    Dropped entries become canonical padding in place (SENTINEL coords,
    identity value) — downstream dedup/kv compaction already treats them as
    slack. Candidate keys pack with the MASK's order.
    """
    keep = mask_member(pack_keys(rows, cols, shape, m.order), m)
    return (torch.where(keep, rows, SENTINEL),
            torch.where(keep, cols, SENTINEL),
            torch.where(_vmask(keep, vals.shape[1:]), vals,
                        torch.tensor(identity, dtype=vals.dtype,
                                     device=vals.device)))


def filter_tile(c: COO, m: LocalMask, identity) -> COO:
    """Post-hoc mask application to a merged tile (the postfilter form of
    ``filter_products``). Stable compaction keeps the tile's order tag."""
    keep = mask_member(pack_keys(c.row, c.col, c.shape, m.order), m)
    return c.prune(lambda _v: keep, fill=identity)


def mask_dense(m: LocalMask, shape) -> torch.Tensor:
    """Dense boolean member matrix (the dense-accumulator path's view)."""
    rows, cols = shape
    valid = m.keys != torch.iinfo(m.keys.dtype).max
    if m.allow is not None:
        valid = valid & m.allow
    row, col = _unpack(m.keys, shape, m.order)
    lin = torch.where(valid, row.long() * cols + col.long(), rows * cols)
    mem = torch.zeros(rows * cols + 1, dtype=torch.bool, device=m.keys.device)
    mem[lin] = True                       # non-members land in a spare slot
    mem = mem[:-1].reshape(rows, cols)
    return ~mem if m.complement else mem


def apply_val_pred(c: COO, val_pred: Callable | None, identity) -> COO:
    """Fused output-value select: drop merged entries failing ``val_pred``.

    Runs after duplicate fusion (values are final) and before the caller's
    capacity clamp — the merge pipeline's last compaction stage.
    """
    if val_pred is None:
        return c
    keep = torch.as_tensor(val_pred(c.val)).reshape(c.cap, -1).all(dim=-1)
    return c.prune(lambda _v: keep, fill=identity)


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Output mask for a distributed multiply. Build via the constructors
    below (``structural`` / ``complement_of`` / ``vector_mask`` /
    ``value_mask``); at most one pattern operand (or none, for a pure value
    mask) may be set, and it must be tile/piece-aligned with the output —
    masks never communicate.
    """

    mat: DistSpMat | None = None      # SpGEMM 2D pattern operand
    mat3: DistSpMat3D | None = None   # SpGEMM 3D pattern operand ('csub')
    vec: DistVec | None = None        # SpMSpV row-membership operand
    complement: bool = False
    pred: Callable | None = None      # over mask operand values
    val_pred: Callable | None = None  # over OUTPUT values (fused select)

    def __post_init__(self):
        operands = sum(x is not None for x in (self.mat, self.mat3, self.vec))
        if operands > 1:
            raise ValueError("MaskSpec takes at most one pattern operand")
        if operands == 0 and self.val_pred is None:
            raise ValueError("empty MaskSpec: no pattern operand, no val_pred")
        if self.vec is not None and self.pred is None:
            raise ValueError(
                "dense-vector masks need pred to define membership")

    def local(self, tile: COO) -> LocalMask:
        """LocalMask over one (already localized) mask tile."""
        return local_mask(tile, pred=self.pred, complement=self.complement)


def structural(m: DistSpMat | DistSpMat3D, *, complement: bool = False,
               pred: Callable | None = None,
               val_pred: Callable | None = None) -> MaskSpec:
    """Keep output entries stored in ``m`` (complement: NOT stored)."""
    if isinstance(m, DistSpMat3D):
        return MaskSpec(mat3=m, complement=complement, pred=pred,
                        val_pred=val_pred)
    return MaskSpec(mat=m, complement=complement, pred=pred,
                    val_pred=val_pred)


def complement_of(m: DistSpMat | DistSpMat3D, *,
                  pred: Callable | None = None,
                  val_pred: Callable | None = None) -> MaskSpec:
    return structural(m, complement=True, pred=pred, val_pred=val_pred)


def vector_mask(v: DistVec, pred: Callable, *,
                complement: bool = False) -> MaskSpec:
    """SpMSpV row mask: keep output rows where ``pred(v[row])`` (xor
    complement). ``v`` must be piece-aligned with the output vector
    (layout 'row' on the matrix grid): BFS passes visited levels here."""
    return MaskSpec(vec=v, complement=complement, pred=pred)


def value_mask(val_pred: Callable) -> MaskSpec:
    """Pure output-value mask (fused GraphBLAS select, e.g. HipMCL prune)."""
    return MaskSpec(val_pred=val_pred)


def mask_allowed_count(mask: MaskSpec) -> int | None:
    """Host-side count of mask-admissible output slots (planner input):
    the admissible rows of a vector mask over the whole grid, padding
    slots included as JAX counts them; None for pattern masks
    (``plan_spgemm`` accounts those per tile). Reads one scalar back from
    the device, the same on every rank."""
    if mask.vec is None:
        return None
    member = torch.as_tensor(mask.pred(mask.vec.data))
    if mask.complement:
        member = ~member
    return int(grid_sum(member.to(torch.int64), mask.vec.grid))
