"""Triangle counting through the port's whole slice, against the JAX package.

R-MAT scale 9 (Graph500 parameters, edge factor 16, seed 0), symmetrized
without self loops, assembled once by ``repro`` on a 1x1 grid with a random
permutation; the port starts from the same tiles (``DistSpMat.from_numpy``).
Both run ``triangle_count`` with no cap arguments, so both planners size,
overflow-check and merge on their own. Counts are integers; C's entries are
small integers in float32, so C must match bitwise.
"""
import dataclasses

import numpy as np
import pytest

from repro.apps import triangle_count as j_triangle_count
from repro.core import plan as JP
from repro.core import semiring as jsr
from repro.core.dist import DistSpMat as JDist, make_grid as j_make_grid
from repro.core.mask import structural as j_structural
from repro.core.matops import (mat_apply_local as j_apply,
                               mat_select_lower as j_lower)
from repro.io import rmat_coo as j_rmat_coo
from repro_torch.apps.tricount import triangle_count as t_triangle_count
from repro_torch.core import plan as TP
from repro_torch.core import semiring as tsr
from repro_torch.core.dist import DistSpMat as TDist, make_grid as t_make_grid
from repro_torch.core.mask import structural as t_structural
from repro_torch.core.matops import (mat_apply_local as t_apply,
                                     mat_nnz, mat_select_lower as t_lower)
from repro_torch.io.rmat import rmat_coo as t_rmat_coo
from repro_torch.obs import recorder

from torch_parity import CPU, assert_dist_equal, jax_reference, np_of

SCALE9_TRIANGLES = 29_131


@pytest.fixture(scope="module")
def graph():
    shape, r, c, v = j_rmat_coo(9, 16, seed=0, symmetrize=True,
                                drop_self_loops=True)
    with jax_reference():
        jmesh = j_make_grid(1, 1)
        ja = JDist.from_global_coo(shape, r, c, v, (1, 1), mesh=jmesh,
                                   random_permute=True)
        ta = TDist.from_numpy(np_of(ja.row), np_of(ja.col), np_of(ja.val),
                              np_of(ja.nnz), ja.shape, ja.grid, ja.order, CPU)
        yield (shape, r, c, v), (jmesh, ja), (t_make_grid(1, 1, device="cpu"),
                                              ta)


def test_rmat_copy_matches(graph):
    (shape, r, c, v), _, _ = graph
    tshape, tr, tc, tv = t_rmat_coo(9, 16, seed=0, symmetrize=True,
                                    drop_self_loops=True)
    assert tshape == shape
    for got, want in ((tr, r), (tc, c), (tv, v)):
        np.testing.assert_array_equal(got, want)


def test_assembly_matches(graph):
    """The port's own host assembly builds JAX's tiles from the same COO."""
    (shape, r, c, v), (_, ja), (tmesh, _) = graph
    ta = TDist.from_global_coo(shape, r, c, v, (1, 1), mesh=tmesh,
                               random_permute=True)
    assert_dist_equal(ta, ja, exact=True)
    for got, want in zip(ta.to_global_coo(), ja.to_global_coo()):
        np.testing.assert_array_equal(got, want)


def test_triangle_count(graph):
    _, (jmesh, ja), (tmesh, ta) = graph
    want = j_triangle_count(ja, mesh=jmesh)
    with recorder.capture() as rec:
        got = t_triangle_count(ta, mesh=tmesh)
        spans = rec.snapshot()["spans"]
        plans = rec.events("plan.spgemm")
    assert got == want == SCALE9_TRIANGLES
    assert len(plans) == 1
    assert {"tricount", "spgemm2d", "spgemm2d.execute"} <= set(spans)


def test_masked_product_and_plan(graph):
    """C = (L·L)⟨L⟩ and the planner's decisions, field by field."""
    _, (jmesh, ja), (tmesh, ta) = graph
    jl = j_lower(j_apply(ja, lambda t: t.apply(lambda x: x * 0 + 1),
                         mesh=jmesh), mesh=jmesh)
    tl = t_lower(t_apply(ta, lambda t: t.apply(lambda x: x * 0 + 1),
                         mesh=tmesh), mesh=tmesh)
    assert_dist_equal(tl, jl, exact=True)
    jc, jp = JP.spgemm(jl, jl, jsr.ARITHMETIC, mesh=jmesh,
                       mask=j_structural(jl))
    tc, tp = TP.spgemm(tl, tl, tsr.ARITHMETIC, mesh=tmesh,
                       mask=t_structural(tl))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert_dist_equal(tc, jc, exact=True)
    assert int(mat_nnz(tc)) == int(np.sum(np_of(jc.nnz)))
    assert tc.to_dense().sum() == SCALE9_TRIANGLES
