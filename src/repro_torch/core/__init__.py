"""repro_torch.core — CombBLAS 2.0 primitives in PyTorch.

Layering (as in ``repro.core``):
  semiring      generalized (add, mul) algebra + segment reductions
  coo           capacity-padded local sparse tiles (SpMat analogue)
  merge         sort-free merge engine: packed-key dedup, kv stage pipeline
  local_spgemm  ESC and dense-accumulator local multiply, hybrid (§4.1)
  spmv_local    local SpMV / SpMSpV variants (§4.2-4.3)
  comm          the process grid's collectives over torch.distributed
                (one process a grid position)
  dist          SpParMat / FullyDist[Sp]Vec containers, process grid
                (§2.1-2.2), the 3D container DistSpMat3D (§3.2)
  mask          output masks (GraphBLAS C⟨M⟩) + membership probes (§4.7)
  matops        tile-local matrix helpers for the apps
  spgemm        2D SUMMA, 3D communication-avoiding SpGEMM (§3.2),
                batched SpGEMM (§7.2), int8 wire compression
  spmv          distributed SpMV / SpMSpV (§3.1)
  spmm          distributed SpMM (1.5D and 2D)
  assign        distributed vector assign / extract (§3.3)
  plan          capacity planner + variant rules of thumb (§5, §7), local
                planners

The JAX package's ``shard_map`` and sharding helpers (``specs_of``,
``shard_put``) have no counterpart: every grid position is a process
(``comm``), and each holds its own shard.
"""
from . import merge, semiring
from .coo import COO, SENTINEL, column_range, ewise_intersect, ewise_union
from .merge import (dedup_sorted, merge_capped, merge_sorted, merge_tree,
                    pack_keys)
from .dist import DistSpMat, DistSpMat3D, DistSpVec, DistVec, make_grid
from .local_spgemm import (compression_ratio, spgemm_auto, spgemm_dense,
                           spgemm_esc, spgemm_flops)
from .mask import (LocalMask, MaskSpec, complement_of, local_mask,
                   mask_member, structural, value_mask, vector_mask)
from .semiring import (ARITHMETIC, BOOLEAN, MAX_MIN, MAX_PLUS, MIN_PLUS,
                       MIN_SELECT2ND, Monoid, Semiring, segment_reduce,
                       semiring as make_semiring)
from .spgemm import spgemm_2d, spgemm_2d_batched, spgemm_3d
from .spmm import local_spmm, spmm_15d, spmm_2d
from .assign import assign, extract
from .spmv import (spmspv, spmv, spmv_iter, transpose_layout,
                   transpose_spvec_layout)
from .spmv_local import (SPMSPV_VARIANTS, spmspv_auto, spmv_col, spmv_row,
                         spvec_from_dense, spvec_to_dense)
from .plan import (LocalSpGEMMPlan, LocalSpMSpVPlan, SpGEMMPlan, SpMSpVPlan,
                   plan_local_spgemm, plan_local_spmspv, plan_spgemm,
                   plan_spmspv, spmspv_variant_for_density, spmv_variant)
from .plan import spgemm as spgemm_planned
from .plan import spmspv as spmspv_planned
