"""repro_torch.core — CombBLAS 2.0 primitives in PyTorch.

Layering (as in ``repro.core``):
  semiring      generalized (add, mul) algebra + segment reductions
  coo           capacity-padded local sparse tiles (SpMat analogue)
  merge         sort-free merge engine: packed-key dedup, kv stage pipeline
  local_spgemm  ESC and dense-accumulator local multiply, hybrid (§4.1)
  spmv_local    local SpMV / SpMSpV variants (§4.2-4.3)
  dist          SpParMat container and its process grid (§2.1)
  mask          output masks (GraphBLAS C⟨M⟩) + membership probes (§4.7)
  matops        tile-local matrix helpers for the apps
  spgemm        2D SUMMA on the 1x1 grid (§3.2)
  plan          capacity planner + variant rules of thumb (§5, §7), local
                planners
"""
