"""Distributed SpMM: sparse × tall-skinny dense (paper §1 "1.5D SpMM", [16]).

The dense matrix X (n × k, k small) uses the *superimposed* vector
distribution (a DistVec whose elements are rows of X, ``vdims=(k,)``). The
A-stationary 1.5D algorithm, as in ``repro.core.spmm``, communicates only
the two dense matrices (X gather + Y reduce-scatter), never the sparse one:

  1. all-gather X pieces along 'row'  → X block x_j      (nb, k)
  2. local SpMM (row-sorted products + row-segment reduce)
  3. psum_scatter partial Y along 'col' → Y pieces, layout 'row'

This slice runs the 1x1 grid, where the all-gathers and the reduce-scatter
over axes of size 1 are the identity: each is written as such, with a
comment naming the JAX call.
"""
from __future__ import annotations

import torch

from .coo import COO
from .dist import DistSpMat, DistVec, Grid
from .semiring import ARITHMETIC, Semiring, segment_reduce


def local_spmm(a: COO, x: torch.Tensor, sr: Semiring = ARITHMETIC) \
        -> torch.Tensor:
    """Y[i, :] = ⊕_j mul(A[i,j], X[j, :]) for dense X (nb, k).

    The row-sorted products reduce with ``sorted_ids=True``, as in JAX.
    Their values are rows of k, so on the card a tagged monoid takes the
    segreduce kernel's atomic route: its sorted route takes scalar values
    only (``kernels/segreduce.py::route``).
    """
    sa = a.sort("row")
    xr = x[sa.col.long().clamp(0, x.shape[0] - 1)]        # (cap, k)
    prod = sr.mul(sa.val[:, None], xr)
    ids = torch.where(sa.mask(), sa.row, a.shape[0])
    return segment_reduce(prod, ids, a.shape[0], sr.add, sorted_ids=True)


def spmm_15d(a: DistSpMat, x: DistVec, sr: Semiring = ARITHMETIC, *,
             mesh: Grid) -> DistVec:
    """Y = A X, X a DistVec with vdims=(k,) in layout 'col'; Y is layout
    'row'."""
    del mesh
    assert x.layout == "col"
    # all_gather of the X pieces along 'row': the identity on 1x1
    xj = x.data.reshape((-1,) + tuple(x.data.shape[3:]))      # (nb, k)
    y_part = local_spmm(a.tile(), xj, sr)                     # (mb, k)
    # psum_scatter (tagged sums) or all_gather + add.op along 'col': the
    # identity on 1x1
    return DistVec(y_part[None, None], a.shape[0], a.grid, "row")


def spmm_2d(a: DistSpMat, x: torch.Tensor, sr: Semiring = ARITHMETIC, *,
            mesh: Grid) -> torch.Tensor:
    """True-2D SpMM: X 2D-block distributed (the paper's "true 2D
    distribution ... for other dense matrices").

    X: (nb·pc, k), split P('col', 'row'): device (i, j) owns X's row block
    j restricted to k-panel i. The panels are all-gathered along 'row' and
    partial Y is reduce-scattered along 'col'. Output: (mb·pc, k), Y rows
    in 'row' layout.
    """
    del mesh
    pr, pc = a.grid
    k = x.shape[1]
    assert k % pr == 0, "k must divide the process-row count"
    assert x.shape[0] == a.nb * pc, (x.shape, a.nb, pc)
    # all_gather of the k-panels along 'row' (axis 1): the identity on 1x1
    y_part = local_spmm(a.tile(), x, sr)                      # (mb, k)
    # psum_scatter (tagged sums) or all_gather + add.op along 'col': the
    # identity on 1x1
    return y_part
