"""Parity of the port's remaining local tile ops with the JAX package.

``COO.transpose``, ``scale_rows``/``scale_cols``, ``ewise_union``,
``ewise_intersect`` (and its 32-bit key guard), the merge path
(``merge_sorted`` with its legacy concat branch, ``merge_capped``,
``merge_tree`` over 3 and 4 tiles with its pre-clamp ``ok``), the post-hoc
``filter_tile``, and the mask constructors with ``MaskSpec``'s checks and
``mask_allowed_count``. Same numpy tiles through both packages; index
structure, ``nnz``, ``ok`` and order tags bitwise, min/max and bool values
bitwise, f32 sums within ``SUM_RTOL``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import coo as JC
from repro.core import mask as JK
from repro.core import merge as JM
from repro.core import semiring as jsr
from repro.core.dist import DistSpMat as JDist, DistVec as JVec
from repro_torch.core import coo as TC
from repro_torch.core import mask as TK
from repro_torch.core import merge as TM
from repro_torch.core import semiring as tsr
from repro_torch.core.dist import DistSpMat as TDist, DistVec as TVec

from torch_parity import (CPU, assert_coo_equal, assert_values, coo_pair,
                          jit_ref, np_of, rand_entries)

SHAPE = (24, 24)
MONOIDS = {"plus": (jsr.PLUS, tsr.PLUS, 0.0),
           "min": (jsr.MIN, tsr.MIN, np.inf),
           "lor": (jsr.LOR, tsr.LOR, False)}


def tile_pair(seed, cap=None, order="none", monoid="plus", shape=SHAPE,
              k=60):
    """A canonical tile in both packages (``cap`` defaults to k + 36);
    ``order`` 'row'/'col' dedups it (through the JAX package) and tags it
    so."""
    jm, _, fill = MONOIDS[monoid]
    cap = cap or k + 36
    r, c, v = rand_entries(n=min(shape), k=k, seed=seed)
    if monoid == "lor":
        v = v > 0.6
    j, _ = coo_pair(shape, r, c, v, cap=cap, fill=fill)
    if order != "none":
        j = jit_ref(JM.dedup, dict(add=jm, order=order), j)
    return j, TC.COO.from_numpy(np_of(j.row), np_of(j.col), np_of(j.val),
                                np_of(j.nnz), j.shape, j.order, CPU)


@pytest.mark.parametrize("order", ["none", "row", "col"])
def test_transpose(order):
    j, t = tile_pair(1, order=order)
    got, want = t.transpose(), j.transpose()
    assert got.shape == (SHAPE[1], SHAPE[0])
    assert_coo_equal(got, want, exact=True)


@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_scale(axis):
    j, t = tile_pair(2, order="row")
    d = (np.random.default_rng(3).random(SHAPE[0]) + 0.5).astype(np.float32)
    want = getattr(j, "scale_" + axis)(jnp.asarray(d))
    got = getattr(t, "scale_" + axis)(torch.as_tensor(d))
    assert_coo_equal(got, want, exact=True)       # one product per entry
    got = getattr(t, "scale_" + axis)(torch.as_tensor(d), torch.maximum)
    want = getattr(j, "scale_" + axis)(jnp.asarray(d), jnp.maximum)
    assert_coo_equal(got, want, exact=True)


@pytest.mark.parametrize("monoid", sorted(MONOIDS))
@pytest.mark.parametrize("orders", [("none", "none"), ("row", "none"),
                                    ("row", "row")])
@pytest.mark.parametrize("cap", [None, 64])
def test_ewise_union(monoid, orders, cap):
    jm, tm, _ = MONOIDS[monoid]
    ja, ta = tile_pair(4, order=orders[0], monoid=monoid)
    jb, tb = tile_pair(5, cap=80, order=orders[1], monoid=monoid, k=50)
    want = jit_ref(JC.ewise_union, dict(add=jm, cap=cap), ja, jb)
    got = TC.ewise_union(ta, tb, tm, cap)
    assert_coo_equal(got, want, exact=monoid != "plus")


@pytest.mark.parametrize("out_cap", [None, 16])
def test_ewise_intersect(out_cap):
    ja, ta = tile_pair(6, order="row", k=120)
    jb, tb = tile_pair(7, k=120)
    want = jit_ref(JC.ewise_intersect,
                   dict(mul=jnp.multiply, out_cap=out_cap), ja, jb)
    got = TC.ewise_intersect(ta, tb, torch.mul, out_cap)
    assert int(got.nnz) > 0 and got.order == "row"
    assert_coo_equal(got, want, exact=True)


def test_ewise_intersect_key_guard():
    shape = (1 << 16, 1 << 16)
    ja, ta = tile_pair(8, shape=shape)
    with pytest.raises(ValueError, match="32-bit key space"):
        JC.ewise_intersect(ja, ja, jnp.multiply)
    with pytest.raises(ValueError, match="32-bit key space"):
        TC.ewise_intersect(ta, ta, torch.mul)


@pytest.mark.parametrize("monoid", sorted(MONOIDS))
@pytest.mark.parametrize("order", ["row", "col"])
def test_merge_sorted(monoid, order):
    jm, tm, _ = MONOIDS[monoid]
    ja, ta = tile_pair(9, order=order, monoid=monoid)
    jb, tb = tile_pair(10, cap=72, monoid=monoid)          # untagged
    want = jit_ref(JM.merge_sorted, dict(add=jm, order=order), ja, jb)
    got = TM.merge_sorted(ta, tb, tm, order)
    assert got.cap == ta.cap + tb.cap
    assert_coo_equal(got, want, exact=monoid != "plus")


@pytest.mark.parametrize("shape", [(1 << 20, 1 << 20), (1 << 32, 1 << 32)])
def test_merge_sorted_wide_keys(shape):
    """Above the 32-bit key space the JAX package (no x64) takes the legacy
    concat-and-sort; the port packs int64 keys below 2^63 and takes the same
    legacy concat above it. Both give the same tile."""
    assert TM.key_dtype(shape) == (torch.int64 if shape[0] < 1 << 32
                                   else None)
    assert JM.key_dtype(shape) is None
    ja, ta = tile_pair(11, shape=shape)
    jb, tb = tile_pair(12, cap=72, shape=shape)
    want = JM.merge_sorted(ja, jb, jsr.MIN)
    assert_coo_equal(TM.merge_sorted(ta, tb, tsr.MIN), want, exact=True)


@pytest.mark.parametrize("cap", [32, 256])
def test_merge_capped(cap):
    ja, ta = tile_pair(13, order="row")
    jb, tb = tile_pair(14, cap=72, order="row")
    jc, jok = jit_ref(JM.merge_capped, dict(add=jsr.PLUS, cap=cap), ja, jb)
    tc, tok = TM.merge_capped(ta, tb, tsr.PLUS, cap)
    assert bool(tok) == bool(jok) == (cap == 256)
    assert_coo_equal(tc, jc)


@pytest.mark.parametrize("ntiles", [3, 4])
@pytest.mark.parametrize("out_cap", [48, 100, 512])
def test_merge_tree(ntiles, out_cap):
    """Every level clamps to min(capL + capR, out_cap), and ``ok`` is the
    pre-clamp check of each level: 48 and 100 overflow, 512 fits."""
    pairs = [tile_pair(20 + i, cap=64, order="row", k=40)
             for i in range(ntiles)]
    jc, jok = JM.merge_tree([j for j, _ in pairs], jsr.PLUS, out_cap)
    tc, tok = TM.merge_tree([t for _, t in pairs], tsr.PLUS, out_cap)
    assert bool(tok) == bool(jok) == (out_cap == 512)
    assert tc.cap == out_cap
    assert_coo_equal(tc, jc)


def test_merge_tree_ok_clamps_before_the_root():
    """An intermediate merge that overflows ``out_cap`` turns ``ok`` false
    even when the root would fit after the clamp."""
    pairs = [tile_pair(30 + i, cap=64, order="row", k=40) for i in range(3)]
    counts = [int(np_of(j.nnz)) for j, _ in pairs]
    first = int(TM.merge_sorted(pairs[0][1], pairs[1][1], tsr.PLUS).nnz)
    out_cap = first - 1
    assert max(counts) <= out_cap
    jc, jok = JM.merge_tree([j for j, _ in pairs], jsr.PLUS, out_cap)
    tc, tok = TM.merge_tree([t for _, t in pairs], tsr.PLUS, out_cap)
    assert not bool(tok) and not bool(jok)
    assert_coo_equal(tc, jc)


@pytest.mark.parametrize("complement", [False, True])
@pytest.mark.parametrize("pred", [False, True])
def test_filter_tile(complement, pred):
    jc, tc = tile_pair(40, order="row", k=120)
    jm_tile, tm_tile = tile_pair(41, order="row", k=150)
    jp = (lambda v: v > 0.8) if pred else None
    tp = (lambda v: v > 0.8) if pred else None
    jl = JK.local_mask(jm_tile, pred=jp, complement=complement)
    tl = TK.local_mask(tm_tile, pred=tp, complement=complement)
    want = JK.filter_tile(jc, jl, 0.0)
    got = TK.filter_tile(tc, tl, 0.0)
    assert got.order == "row"
    assert_coo_equal(got, want, exact=True)


def _mats():
    r, c, v = rand_entries(n=16, k=30, seed=50)
    key = np.unique(r * 16 + c)
    r, c = key // 16, key % 16
    j = JDist.from_global_coo((16, 16), r, c, np.ones(len(r), np.float32),
                              (1, 1))
    t = TDist.from_numpy(np_of(j.row), np_of(j.col), np_of(j.val),
                         np_of(j.nnz), j.shape, j.grid, j.order, CPU)
    return j, t


def test_mask_constructors_and_checks():
    jmat, tmat = _mats()
    lv = np.array([-1, 0, 2, -1, 5, -1, -1, 1, 0], np.int32)
    jv = JVec.from_global(lv, (1, 1), layout="row")
    tv = TVec.from_global(lv, (1, 1), layout="row", device="cpu")
    pred = lambda x: x >= 0
    for jmask, tmask in (
            (JK.complement_of(jmat), TK.complement_of(tmat)),
            (JK.value_mask(pred), TK.value_mask(pred)),
            (JK.vector_mask(jv, pred), TK.vector_mask(tv, pred)),
            (JK.vector_mask(jv, pred, complement=True),
             TK.vector_mask(tv, pred, complement=True))):
        assert tmask.complement == jmask.complement
        assert (tmask.mat is None) == (jmask.mat is None)
        assert (tmask.vec is None) == (jmask.vec is None)
        assert tmask.val_pred is jmask.val_pred
        assert TK.mask_allowed_count(tmask) == JK.mask_allowed_count(jmask)
    assert TK.mask_allowed_count(TK.vector_mask(tv, pred)) == 5
    assert TK.mask_allowed_count(TK.vector_mask(tv, pred,
                                                complement=True)) == 4
    for make in (lambda K, m, v: K.MaskSpec(mat=m, vec=v, pred=pred),
                 lambda K, m, v: K.MaskSpec(),
                 lambda K, m, v: K.MaskSpec(vec=v)):
        msgs = []
        for K, m, v in ((JK, jmat, jv), (TK, tmat, tv)):
            with pytest.raises(ValueError) as err:
                make(K, m, v)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
