"""Distributed SpMM: sparse × tall-skinny dense (paper §1 "1.5D SpMM", [16]).

The dense matrix X (n × k, k small) uses the *superimposed* vector
distribution (a DistVec whose elements are rows of X, ``vdims=(k,)``). The
A-stationary 1.5D algorithm, as in ``repro.core.spmm``, communicates only
the two dense matrices (X gather + Y reduce-scatter), never the sparse one:

  1. all-gather X pieces along 'row'  → X block x_j      (nb, k)
  2. local SpMM (row-sorted products + row-segment reduce)
  3. psum_scatter partial Y along 'col' → Y pieces, layout 'row'

The gathers and the reduce-scatter are ``core/comm.py``'s; over axes of
size 1 (the 1x1 grid) they are the identity.
"""
from __future__ import annotations

import torch

from . import comm
from .coo import COO
from .dist import DistSpMat, DistVec, Grid
from .matops import reduce_over
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
    g = comm.of(a.grid)
    xj = comm.all_gather(x.data.reshape((-1,) + tuple(x.data.shape[3:])),
                         g, "row", tiled=True)                # (nb, k)
    y_part = local_spmm(a.tile(), xj, sr)                     # (mb, k)
    # psum_scatter (tagged sums) or all_gather + add.op along 'col'
    y = reduce_over(y_part, sr.add, g, "col")
    return DistVec(y[None, None], a.shape[0], a.grid, "row")


def spmm_2d(a: DistSpMat, x: torch.Tensor, sr: Semiring = ARITHMETIC, *,
            mesh: Grid) -> torch.Tensor:
    """True-2D SpMM: X 2D-block distributed (the paper's "true 2D
    distribution ... for other dense matrices").

    X: (nb·pc, k), split P('col', 'row'): rank (i, j) holds its shard,
    X's row block j restricted to k-panel i, ``x`` of shape (nb, k/pr).
    The panels are all-gathered along 'row' and partial Y is
    reduce-scattered along 'col'. Returns this rank's shard of Y
    (mb·pc, k) split P(('row', 'col'), None): rows block i·pc + j, of
    shape (mb/pc, k).
    """
    del mesh
    pr, pc = a.grid
    g = comm.of(a.grid)
    assert x.shape[0] == a.nb, (x.shape, a.nb)
    # the k-panels of block j, gathered along 'row' into (nb, k)
    panels = comm.all_gather(x, g, "row")                     # (pr, nb, k/pr)
    xj = panels.permute(1, 0, 2).reshape(x.shape[0], -1)
    y_part = local_spmm(a.tile(), xj, sr)                     # (mb, k)
    # psum_scatter (tagged sums) or all_gather + add.op along 'col'
    return reduce_over(y_part, sr.add, g, "col")
