"""Parity of the port's dense-accumulator local SpGEMM path.

``COO.from_dense``/``to_dense_add``, ``mask_dense``, ``spgemm_dense``,
``spgemm_auto`` and ``plan_local_spgemm`` against the JAX package on the
same tiles (JAX tiles handed over verbatim with ``COO.from_numpy``). Values
are small integers, so every semiring's result is exact and compared
bitwise, padding included; so are the ``ok`` flags and plans.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from repro.core import local_spgemm as JL
from repro.core import plan as JP
from repro.core import semiring as jsr
from repro.core.coo import COO as JCOO
from repro.core.mask import local_mask as j_local_mask
from repro.core.mask import mask_dense as j_mask_dense
from repro.io.rmat import rmat_coo as j_rmat_coo
from repro_torch.core import local_spgemm as TL
from repro_torch.core import plan as TP
from repro_torch.core import semiring as tsr
from repro_torch.core.coo import COO as TCOO
from repro_torch.core.mask import local_mask as t_local_mask
from repro_torch.core.mask import mask_dense as t_mask_dense
from repro_torch.io.rmat import rmat_coo as t_rmat_coo

from torch_parity import assert_coo_equal, coo_from_jax, jit_ref, np_of

SEMIRINGS = ("ARITHMETIC", "MIN_PLUS", "MAX_MIN", "BOOLEAN")


def tile_pair(n=20, density=0.25, seed=0, boolean=False, cap=None):
    """A deduplicated row-sorted tile with weights 1..4 (or True), both
    packages."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, n)) < density,
                     rng.integers(1, 5, (n, n)), 0).astype(np.float32)
    r, c = np.nonzero(dense)
    v = dense[r, c] > 0 if boolean else dense[r, c]
    j = JCOO.from_entries((n, n), r, c, v, cap=cap or len(r) + 8,
                          fill=False if boolean else 0.0, order="row")
    return j, coo_from_jax(j)


# --------------------------------------------------------------------------
# COO.from_dense / to_dense_add
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [8, 64])          # truncating, padded
@pytest.mark.parametrize("vdims", [(), (2,)])
def test_from_dense_row(cap, vdims):
    rng = np.random.default_rng(1)
    dense = np.where(rng.random((6, 9) + vdims) < 0.4,
                     rng.integers(1, 5, (6, 9) + vdims), 0).astype(np.float32)
    want = jit_ref(JCOO.from_dense, dict(cap=cap, order="row"),
                   jnp.asarray(dense))
    got = TCOO.from_dense(torch.as_tensor(dense), cap, order="row")
    assert_coo_equal(got, want, exact=True)


@pytest.mark.parametrize("cap", [8, 64])
def test_from_dense_col_sorts_its_entries(cap):
    # JAX tags its row-major entries 'col' (a defect of the reference); the
    # port returns the same entries sorted col-major
    rng = np.random.default_rng(2)
    dense = np.where(rng.random((7, 5)) < 0.5, rng.integers(1, 5, (7, 5)),
                     0).astype(np.float32)
    want = jit_ref(JCOO.from_dense, dict(cap=cap, order="col"),
                   jnp.asarray(dense))
    got = TCOO.from_dense(torch.as_tensor(dense), cap, order="col")
    assert got.order == want.order == "col"
    k = int(want.nnz)
    assert int(got.nnz) == k
    wr, wc, wv = (np_of(x)[:k] for x in (want.row, want.col, want.val))
    perm = np.lexsort((wr, wc))
    np.testing.assert_array_equal(np_of(got.row)[:k], wr[perm])
    np.testing.assert_array_equal(np_of(got.col)[:k], wc[perm])
    np.testing.assert_array_equal(np_of(got.val)[:k], wv[perm])
    for f in ("row", "col", "val"):          # padding as JAX pads
        np.testing.assert_array_equal(np_of(getattr(got, f))[k:],
                                      np_of(getattr(want, f))[k:])


@pytest.mark.parametrize("name,dtype,extreme", [
    ("PLUS", np.float32, None), ("MIN", np.float32, None),
    ("MAX", np.float32, None), ("MIN_INT", np.int32, 2**31 - 1),
    ("MAX_INT", np.int32, -(2**31)), ("TIMES_MONOID", np.float32, None)])
def test_to_dense_add(name, dtype, extreme):
    # duplicates everywhere; MIN_INT/MAX_INT get values beyond their
    # declared identity, which JAX's identity-filled scatter absorbs
    rng = np.random.default_rng(3)
    r, c = rng.integers(0, 6, 40), rng.integers(0, 5, 40)
    v = rng.integers(1, 4, 40).astype(dtype)
    if extreme is not None:
        v[:3] = extreme
        r[0], c[0] = r[5], c[5]            # one of them on a shared entry
    j = JCOO.from_entries((6, 5), r, c, v, cap=48)
    want = jit_ref(JCOO.to_dense_add, dict(add=getattr(jsr, name)), j)
    got = coo_from_jax(j).to_dense_add(getattr(tsr, name))
    np.testing.assert_array_equal(np_of(got), np_of(want))
    assert np_of(got).dtype == np_of(want).dtype


# --------------------------------------------------------------------------
# mask_dense
# --------------------------------------------------------------------------

def _gt1(v):
    return v > 1


@pytest.mark.parametrize("kw", [{}, {"complement": True}, {"pred": _gt1},
                                {"pred": _gt1, "complement": True},
                                {"order": "col"}])
def test_mask_dense(kw):
    jm, tm = tile_pair(n=12, seed=4)
    want = j_mask_dense(j_local_mask(jm, **kw), jm.shape)
    got = t_mask_dense(t_local_mask(tm, **kw), tm.shape)
    np.testing.assert_array_equal(np_of(got), np_of(want))


# --------------------------------------------------------------------------
# spgemm_dense / spgemm_auto
# --------------------------------------------------------------------------

VAL_PRED = {"ARITHMETIC": lambda v: v > 6, "MIN_PLUS": lambda v: v < 5,
            "MAX_MIN": lambda v: v > 2, "BOOLEAN": lambda v: v}


def operands(name, seed):
    boolean = name == "BOOLEAN"
    ja, ta = tile_pair(seed=seed, boolean=boolean)
    jb, tb = tile_pair(seed=seed + 1, boolean=boolean)
    jm, tm = tile_pair(seed=seed + 2, density=0.4)
    return ja, ta, jb, tb, j_local_mask(jm), t_local_mask(tm)


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pred", [False, True])
def test_spgemm_dense(name, masked, pred):
    ja, ta, jb, tb, jm, tm = operands(name, seed=5)
    vp = VAL_PRED[name] if pred else None
    want, jok = jit_ref(JL.spgemm_dense, dict(sr=getattr(jsr, name),
                                              out_cap=512, val_pred=vp),
                        ja, jb, mask=jm if masked else None)
    got, tok = TL.spgemm_dense(ta, tb, getattr(tsr, name), out_cap=512,
                               val_pred=vp, mask=tm if masked else None)
    assert bool(tok) == bool(jok)
    assert_coo_equal(got, want, exact=True)


def test_spgemm_dense_overflow_flag():
    ja, ta, jb, tb, _, _ = operands("ARITHMETIC", seed=6)
    want, jok = jit_ref(JL.spgemm_dense, dict(sr=jsr.ARITHMETIC, out_cap=16),
                        ja, jb)
    got, tok = TL.spgemm_dense(ta, tb, tsr.ARITHMETIC, out_cap=16)
    assert not bool(jok) and not bool(tok)
    assert_coo_equal(got, want, exact=True)


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("branch", ["dense", "esc", "tile_limit"])
def test_spgemm_auto(name, branch):
    # thresholds force each branch; mask and val_pred pass through to both
    ja, ta, jb, tb, jm, tm = operands(name, seed=7)
    kw = dict(prod_cap=4096, out_cap=512, val_pred=VAL_PRED[name],
              dense_threshold={"dense": 0.0}.get(branch, 1e9),
              dense_tile_limit=1 if branch == "tile_limit" else 1 << 22)
    want, jok = jit_ref(JL.spgemm_auto, dict(sr=getattr(jsr, name), **kw),
                        ja, jb, mask=jm)
    got, tok = TL.spgemm_auto(ta, tb, getattr(tsr, name), mask=tm, **kw)
    assert bool(tok) == bool(jok)
    assert_coo_equal(got, want, exact=True)


@pytest.mark.parametrize("branch", ["dense", "esc"])
def test_spgemm_auto_takes_the_plans_algo(branch):
    # a caller's algo picks the branch as JAX's thresholds would, bitwise
    ja, ta, jb, tb, jm, tm = operands("MIN_PLUS", seed=9)
    kw = dict(prod_cap=4096, out_cap=512, val_pred=VAL_PRED["MIN_PLUS"])
    want, jok = jit_ref(JL.spgemm_auto, dict(
        sr=jsr.MIN_PLUS, dense_threshold=0.0 if branch == "dense" else 1e9,
        **kw), ja, jb, mask=jm)
    got, tok = TL.spgemm_auto(ta, tb, tsr.MIN_PLUS, mask=tm, algo=branch,
                              **kw)
    assert bool(tok) == bool(jok)
    assert_coo_equal(got, want, exact=True)
    with pytest.raises(ValueError):
        TL.spgemm_auto(ta, tb, tsr.MIN_PLUS, algo="hash", **kw)


@pytest.mark.parametrize("threshold, limit, ratio, want", [
    (0.0, 1 << 22, None, "dense"), (1e9, 1 << 22, None, "esc"),
    (0.0, 1, None, "esc"), (4.0, 1 << 22, 4.0, "dense"),
    (4.0, 1 << 22, 3.99, "esc")])
def test_local_algo(threshold, limit, ratio, want):
    # the one policy of plan_local_spgemm and spgemm_auto: >= at the
    # threshold, and the tile limit before the ratio
    _, ta = tile_pair(seed=10)
    assert TL.local_algo(ta, ta, dense_threshold=threshold,
                         dense_tile_limit=limit, ratio=ratio) == want


# --------------------------------------------------------------------------
# plan_local_spgemm, and the path end to end
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mask_nnz", [None, 40])
@pytest.mark.parametrize("density", [0.05, 0.4])
def test_plan_local_spgemm(mask_nnz, density):
    ja, ta = tile_pair(n=32, density=density, seed=8)
    want = JP.plan_local_spgemm(ja, ja, mask_nnz=mask_nnz)
    got = TP.plan_local_spgemm(ta, ta, mask_nnz=mask_nnz)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_rmat_scale8_end_to_end():
    """R-MAT scale 8, edge factor 32 (ratio ~6.4): both planners pick the
    dense accumulator; A·A matches JAX bitwise and scipy exactly."""
    shape, r, c, v = t_rmat_coo(8, 32, seed=0, symmetrize=True,
                                drop_self_loops=True)
    jshape, jr, jc, jv = j_rmat_coo(8, 32, seed=0, symmetrize=True,
                                    drop_self_loops=True)
    assert shape == jshape and np.array_equal(r, jr) and \
        np.array_equal(c, jc) and np.array_equal(v, jv)
    perm = np.lexsort((c, r))
    ja = JCOO.from_entries(shape, r[perm], c[perm], v[perm],
                           cap=len(r) + 64, order="row")
    ta = coo_from_jax(ja)
    jplan = JP.plan_local_spgemm(ja, ja)
    tplan = TP.plan_local_spgemm(ta, ta)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tplan.algo == "dense"
    caps = dict(prod_cap=tplan.prod_cap, out_cap=tplan.out_cap)
    want, jok = jit_ref(JL.spgemm_auto, dict(sr=jsr.ARITHMETIC, **caps),
                        ja, ja)
    got, tok = TL.spgemm_auto(ta, ta, tsr.ARITHMETIC, **caps)
    assert bool(tok) and bool(jok)
    assert_coo_equal(got, want, exact=True)
    ref = sp.csr_matrix((v, (r, c)), shape=shape)
    ref = (ref @ ref).tocoo()
    k = int(got.nnz)
    assert k == ref.nnz
    key = np.lexsort((ref.col, ref.row))
    np.testing.assert_array_equal(np_of(got.row)[:k], ref.row[key])
    np.testing.assert_array_equal(np_of(got.col)[:k], ref.col[key])
    np.testing.assert_array_equal(np_of(got.val)[:k], ref.data[key])
