"""Parity of the port's local SpMV / SpMSpV layer and its planner.

Every function of ``repro_torch.core.spmv_local`` and every SpMSpV variant
against ``repro.core.spmv_local`` on the same tiles and vectors (JAX tiles
handed over verbatim). Values are small integers, so all results, padding
included, and the ``ok`` flags are compared bitwise. Tagged monoids run on
the segmented reduce (its plain version here): the cases with ``MAX_INT`` /
``MIN_INT`` pin how the port combines onto a declared identity that is not
the dtype extreme, as JAX's identity-filled scatters do.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import plan as JP
from repro.core import semiring as jsr
from repro.core import spmv_local as JS
from repro.core.coo import COO as JCOO
from repro_torch.core import plan as TP
from repro_torch.core import semiring as tsr
from repro_torch.core import spmv_local as TS

from torch_parity import coo_from_jax, jit_ref, np_of

SEMIRINGS = ("ARITHMETIC", "MIN_PLUS", "MAX_MIN", "BOOLEAN")
M, N = 24, 20


def tile(seed=0, boolean=False, dtype=np.float32, order="row"):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((M, N)) < 0.3, rng.integers(1, 5, (M, N)), 0)
    r, c = np.nonzero(dense)
    v = dense[r, c] > 0 if boolean else dense[r, c].astype(dtype)
    j = JCOO.from_entries((M, N), r, c, v, cap=len(r) + 8,
                          fill=False if boolean else 0, order=order)
    if order != "row":
        j = dataclasses.replace(j, order="none")
    return j, coo_from_jax(j)


def frontier(f, seed=1, boolean=False, dtype=np.float32, cap=16):
    """A sparse x with f stored entries, padded to ``cap``."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(N, f, replace=False)).astype(np.int32)
    val = np.ones(cap, bool) if boolean else \
        rng.integers(1, 5, cap).astype(dtype)
    xi = np.concatenate([idx, np.zeros(cap - f, np.int32)])
    return xi, val, np.int32(f)


def both(*arrays):
    return ([jnp.asarray(x) for x in arrays],
            [torch.as_tensor(np.asarray(x)) for x in arrays])


def assert_same(got, want):
    for g, w in zip(got, want):
        g, w = np_of(g), np_of(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# sparse vectors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [4, 16])
def test_spvec_helpers(cap):
    x = np.asarray([0, 3, 0, 0, 5, 1, 0, 2, 0, 7], np.float32)
    (jx,), (tx,) = both(x)
    want = jit_ref(JS.spvec_from_dense, dict(cap=cap), jx)
    got = TS.spvec_from_dense(tx, cap)
    assert_same(got, want)
    assert_same([TS.spvec_to_dense(got[0], got[1], 10)],
                [JS.spvec_to_dense(want[0], want[1], 10)])
    idx = np.asarray([4, 1, 9, 9], np.int32)
    (ji, jv), (ti, tv) = both(idx, idx.astype(np.float32))
    assert_same(TS.spvec(ti, tv, 10, nnz=2), JS.spvec(ji, jv, 10, nnz=2))


# --------------------------------------------------------------------------
# SpMV
# --------------------------------------------------------------------------

def _sr(name):
    if name == "MAX_INT_SELECT2ND":      # declared identity -(2^31)+1
        return (jsr.Semiring(jsr.MAX_INT, jsr._select2nd, name),
                tsr.Semiring(tsr.MAX_INT, tsr._select2nd, name))
    if name == "MAX_GENERIC":            # an untagged monoid: the scan path
        return (jsr.semiring(jnp.maximum, -jnp.inf, jnp.add),
                tsr.semiring(torch.maximum, -math.inf, torch.add))
    return getattr(jsr, name), getattr(tsr, name)


def x_dense(name, seed=2):
    rng = np.random.default_rng(seed)
    if name == "BOOLEAN":
        return rng.random(N) < 0.5
    if name in ("MAX_INT_SELECT2ND", "MIN_INT_SELECT2ND"):
        x = rng.integers(1, 5, N).astype(np.int32)
        x[::3] = -(2**31) if name.startswith("MAX") else 2**31 - 1
        return x
    return rng.integers(1, 5, N).astype(np.float32)


@pytest.mark.parametrize("variant", ["spmv_row", "spmv_col"])
@pytest.mark.parametrize("name", SEMIRINGS + ("MAX_INT_SELECT2ND",
                                              "MIN_INT_SELECT2ND",
                                              "MAX_GENERIC"))
def test_spmv(variant, name):
    jsr_, tsr_ = _sr(name)
    dtype = np.int32 if name.endswith("INT_SELECT2ND") else np.float32
    ja, ta = tile(seed=3, boolean=name == "BOOLEAN", dtype=dtype,
                  order="none")
    (jx,), (tx,) = both(x_dense(name))
    want = jit_ref(getattr(JS, variant), dict(sr=jsr_), ja, jx)
    got = getattr(TS, variant)(ta, tx, tsr_)
    assert_same([got], [want])


# --------------------------------------------------------------------------
# SpMSpV
# --------------------------------------------------------------------------

VARIANTS = ("spmspv_sort", "spmspv_spa", "spmspv_bucket")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("masked", [False, True])
def test_spmspv(variant, name, masked):
    jsr_, tsr_ = getattr(jsr, name), getattr(tsr, name)
    boolean = name == "BOOLEAN"
    ja, ta = tile(seed=4, boolean=boolean)
    allow = np.random.default_rng(5).random(M) < 0.6
    (jxi, jxv, jxn, jal), (txi, txv, txn, tal) = both(
        *frontier(6, boolean=boolean), allow)
    caps = dict(prod_cap=256, out_cap=32)
    (want, jok) = jit_ref(getattr(JS, variant), dict(sr=jsr_, **caps),
                          ja, jxi, jxv, jxn, allow=jal if masked else None)
    (got, tok) = getattr(TS, variant)(ta, txi, txv, txn, tsr_,
                                      allow=tal if masked else None, **caps)
    assert bool(tok) == bool(jok)
    assert_same(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("caps", [dict(prod_cap=16, out_cap=32),
                                  dict(prod_cap=256, out_cap=4)])
def test_spmspv_overflow_flags(variant, caps):
    ja, ta = tile(seed=6)
    (jxi, jxv, jxn), (txi, txv, txn) = both(*frontier(8))
    (want, jok) = jit_ref(getattr(JS, variant), dict(sr=jsr.ARITHMETIC,
                                                     **caps),
                          ja, jxi, jxv, jxn)
    (got, tok) = getattr(TS, variant)(ta, txi, txv, txn, tsr.ARITHMETIC,
                                      **caps)
    assert not bool(jok) and not bool(tok)
    assert_same(got, want)


@pytest.mark.parametrize("name", ["MAX_INT", "MIN_INT", "PLUS", "LOR"])
def test_scatter_monoid_onto_declared_identity(name):
    """Touched rows hold op(identity, values), as JAX's identity-filled
    scatter gives: a value below MAX_INT's -(2^31)+1 comes back as the
    identity. MIN_INT's 2^31-1 can only be passed in int64, which JAX runs
    as int32 here, so that case is held to numpy's ``minimum.at``."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 10, 30).astype(np.int32)
    rows[-4:] = 2**31 - 1                                   # padding
    if name == "LOR":
        vals = rng.random(30) < 0.3
    else:
        vals = rng.integers(-5, 5, 30).astype(
            np.int64 if name == "MIN_INT" else np.int32)
        vals[:5] = {"MAX_INT": -(2**31), "MIN_INT": 2**31 + 7,
                    "PLUS": 0}[name]
    (jr, jv), (tr, tv) = both(rows, vals)
    got = TS._scatter_monoid(tr, tv, 12, getattr(tsr, name))
    if name == "MIN_INT":
        want = np.full(12, 2**31 - 1, np.int64)
        np.minimum.at(want, rows[:-4], vals[:-4])
    else:
        want = JS._scatter_monoid(jr, jv, 12, getattr(jsr, name))
    assert_same([got], [want])


@pytest.mark.parametrize("variant", VARIANTS)
def test_spmspv_max_int_corner(variant):
    # values below MAX_INT's identity reach the accumulators: sort reduces
    # the touched values alone (as JAX's segment_max), SPA/bucket combine
    # onto the identity (as JAX's scatter)
    jsr_, tsr_ = _sr("MAX_INT_SELECT2ND")
    ja, ta = tile(seed=8, dtype=np.int32)
    xi, xv, xn = frontier(7, dtype=np.int32)
    xv[::2] = -(2**31)
    (jxi, jxv, jxn), (txi, txv, txn) = both(xi, xv, xn)
    caps = dict(prod_cap=256, out_cap=32)
    (want, jok) = jit_ref(getattr(JS, variant), dict(sr=jsr_, **caps),
                          ja, jxi, jxv, jxn)
    (got, tok) = getattr(TS, variant)(ta, txi, txv, txn, tsr_, **caps)
    assert bool(tok) == bool(jok)
    assert_same(got, want)


@pytest.mark.parametrize("f", [1, 3, 15])     # 0.5 %, 10 % density edges
def test_spmspv_auto_and_plan(f):
    n = 200
    rng = np.random.default_rng(9)
    dense = np.where(rng.random((n, n)) < 0.05, rng.integers(1, 5, (n, n)),
                     0).astype(np.float32)
    r, c = np.nonzero(dense)
    ja = JCOO.from_entries((n, n), r, c, dense[r, c], cap=len(r) + 8,
                           order="row")
    ta = coo_from_jax(ja)
    jplan = JP.plan_local_spmspv(ja, f)
    tplan = TP.plan_local_spmspv(ta, f)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tplan.variant == TP.spmspv_variant_for_density(f / n) == \
        JP.spmspv_variant_for_density(f / n)
    idx = np.sort(rng.choice(n, f, replace=False)).astype(np.int32)
    xv = rng.integers(1, 5, f).astype(np.float32)
    (jxi, jxv, jxn), (txi, txv, txn) = both(idx, xv, np.int32(f))
    caps = dict(prod_cap=tplan.prod_cap, out_cap=tplan.out_cap)
    (want, jok) = jit_ref(JS.spmspv_auto, dict(sr=jsr.ARITHMETIC, **caps),
                          ja, jxi, jxv, jxn)
    (got, tok) = TS.spmspv_auto(ta, txi, txv, txn, tsr.ARITHMETIC, **caps)
    assert bool(tok) == bool(jok)
    assert_same(got, want)


@pytest.mark.parametrize("density", [0.001, 0.005, 0.02, 0.1, 0.3, 0.31])
def test_spmspv_variant_for_density(density):
    assert TP.spmspv_variant_for_density(density) == \
        JP.spmspv_variant_for_density(density)
