"""Parity of the port's merge engine with ``repro.core.merge``.

Same numpy tiles and product buffers through both packages: dedup (packed,
sorted fast path, legacy two-key), the kv stage pipeline with and without a
mask, ``kv_merge2`` and ``kv_tree``. The int64 key branch has no JAX
counterpart without x64, so it is held against a numpy dense oracle.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import merge as JM
from repro.core import semiring as jsr
from repro.core.mask import local_mask as j_local_mask
from repro_torch.core import merge as TM
from repro_torch.core import semiring as tsr
from repro_torch.core.coo import COO as TCOO, SENTINEL
from repro_torch.core.mask import local_mask as t_local_mask

from torch_parity import (CPU, assert_coo_equal, assert_values, coo_pair,
                          jit_ref, np_of, rand_entries)

USER = (jsr.Monoid(lambda a, b: a + b + a * b, 0.0, None, "user"),
        tsr.Monoid(lambda a, b: a + b + a * b, 0.0, None, "user"))
MONOIDS = {"plus": ((jsr.PLUS, tsr.PLUS), 0.0),
           "min": ((jsr.MIN, tsr.MIN), np.inf),
           "max": ((jsr.MAX, tsr.MAX), -np.inf),
           "user": (USER, 0.0)}


class TestDedup:
    @pytest.mark.parametrize("name", sorted(MONOIDS))
    @pytest.mark.parametrize("order", ["row", "col"])
    def test_dedup(self, name, order):
        (jm, tm), fill = MONOIDS[name]
        for seed in range(3):
            r, c, v = rand_entries(seed=seed)
            j, t = coo_pair((24, 24), r, c, v, cap=96, fill=fill)
            assert_coo_equal(TM.dedup(t, tm, order),
                             jit_ref(JM.dedup, dict(add=jm, order=order), j),
                             exact=name in ("min", "max"))

    def test_dedup_sorted_and_sort_packed(self):
        r, c, v = rand_entries(seed=11)
        j, t = coo_pair((24, 24), r, c, v, cap=80)
        js = jit_ref(JM.sort_packed, dict(order="row"), j)
        ts = TM.sort_packed(t, "row")
        assert_coo_equal(ts, js, exact=True)
        assert_coo_equal(TM.dedup_sorted(ts, tsr.PLUS),
                         jit_ref(JM.dedup_sorted, dict(add=jsr.PLUS), js))

    @pytest.mark.parametrize("name", ["plus", "min"])
    def test_legacy_two_key(self, name):
        (jm, tm), fill = MONOIDS[name]
        r, c, v = rand_entries(seed=12)
        j, t = coo_pair((24, 24), r, c, v, cap=96, fill=fill)
        want = jit_ref(JM.dedup_legacy, dict(add=jm), j)
        assert_coo_equal(TM.dedup_legacy(t, tm), want, exact=name == "min")
        # a tile whose keys cannot pack takes the two-key path in dedup
        big = TCOO(t.row, t.col, t.val, t.nnz, (2**40, 2**40), t.order)
        assert TM.key_dtype(big.shape) is None
        got = TM.dedup(big, tm)
        assert_coo_equal(TCOO(got.row, got.col, got.val, got.nnz, t.shape,
                              got.order), want, exact=name == "min")

    def test_vector_values(self):
        r, c, v = rand_entries(seed=13, vdims=(3,))
        j, t = coo_pair((24, 24), r, c, v, cap=96)
        assert_coo_equal(TM.dedup(t, tsr.PLUS),
                         jit_ref(JM.dedup, dict(add=jsr.PLUS), j))

    def test_int64_keys_vs_dense_oracle(self):
        # (m+1)(n+1) >= 2^31: int64 keys (the JAX package needs x64 here)
        shape = (70_000, 40_000)
        assert TM.key_dtype(shape) == torch.int64
        rng = np.random.default_rng(14)
        rows = rng.integers(0, 8, 200) * 9_000 + 60_000
        cols = rng.integers(0, 8, 200) * 4_999 + 1
        vals = rng.integers(1, 5, 200).astype(np.float32)
        t = TCOO.from_entries(shape, rows, cols, vals, cap=256, device=CPU)
        got = TM.dedup(t, tsr.PLUS)
        oracle = {}
        for r_, c_, v_ in zip(rows.tolist(), cols.tolist(), vals.tolist()):
            oracle[(r_, c_)] = oracle.get((r_, c_), 0.0) + v_
        keys = sorted(oracle)
        n = int(got.nnz)
        assert n == len(keys) and got.order == "row"
        np.testing.assert_array_equal(np_of(got.row[:n]), [k[0] for k in keys])
        np.testing.assert_array_equal(np_of(got.col[:n]), [k[1] for k in keys])
        np.testing.assert_array_equal(np_of(got.val[:n]),
                                      [oracle[k] for k in keys])
        assert bool((got.row[n:] == SENTINEL).all())


def _stages(q=3, prod_cap=256, n=40, seed=0):
    """Padded product buffers: live products first, then SENTINEL slack."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(q):
        k = int(rng.integers(prod_cap // 4, prod_cap))
        r = np.full(prod_cap, SENTINEL, np.int32)
        c = np.full(prod_cap, SENTINEL, np.int32)
        v = np.zeros(prod_cap, np.float32)
        r[:k] = rng.integers(0, n, k)
        c[:k] = rng.integers(0, n, k)
        v[:k] = rng.integers(1, 4, k).astype(np.float32)
        out.append((r, c, v, k))
    return out, (n, n)


def _mask_pair(shape, seed):
    """A deduplicated row-sorted mask tile in both packages."""
    r, c, v = rand_entries(n=shape[0], k=300, seed=seed)
    j, t = coo_pair(shape, r, c, v, cap=320)
    jd = jit_ref(JM.dedup, dict(add=jsr.PLUS), j)
    return j_local_mask(jd), t_local_mask(TM.dedup(t, tsr.PLUS))


class TestKvPipeline:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("cap,prod_cap", [(256, 256), (64, 512)])
    def test_kv_from_products(self, masked, cap, prod_cap):
        # cap < prod_cap / MAX_WINDOWS splits the buffer into windows, some
        # past the live prefix (skipped)
        stages, shape = _stages(q=1, prod_cap=prod_cap, seed=cap)
        (r, c, v, k), = stages
        jmask, tmask = _mask_pair(shape, seed=21) if masked else (None, None)
        want = jit_ref(JM.kv_from_products,
                       dict(shape=shape, add=jsr.PLUS, cap=cap),
                       jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
                       jnp.int32(k), mask=jmask)
        got = TM.kv_from_products(torch.as_tensor(r), torch.as_tensor(c),
                                  torch.as_tensor(v), torch.tensor(k), shape,
                                  tsr.PLUS, cap, mask=tmask)
        for g, w in zip(got[:2], want[:2]):
            assert_values(g, w)
        assert int(got[2]) == int(want[2]) and bool(got[3]) == bool(want[3])

    def test_kv_merge2_and_tree(self):
        streams = []
        for seed in (31, 32, 33):
            r, c, v = rand_entries(seed=seed)
            j, t = coo_pair((24, 24), r, c, v, cap=96)
            jd = jit_ref(JM.dedup, dict(add=jsr.PLUS), j)
            td = TM.dedup(t, tsr.PLUS)
            streams.append((
                (JM.pack_keys(jd.row, jd.col, jd.shape), jd.val, jd.nnz),
                (TM.pack_keys(td.row, td.col, td.shape), td.val, td.nnz)))
        (ja, ta), (jb, tb) = streams[0], streams[1]
        want = jit_ref(JM.kv_merge2, dict(add=jsr.PLUS, cap=150), *ja, *jb)
        got = TM.kv_merge2(*ta, *tb, tsr.PLUS, 150)
        for g, w in zip(got[:3], want[:3]):
            assert_values(g, w)
        assert bool(got[3]) == bool(want[3])
        want = jit_ref(JM.kv_tree, dict(add=jsr.PLUS, out_cap=256),
                       [s[0] for s in streams])
        got = TM.kv_tree([s[1] for s in streams], tsr.PLUS, 256)
        for g, w in zip(got[:3], want[:3]):
            assert_values(g, w)
        assert bool(got[3]) == bool(want[3])
        assert_coo_equal(
            TM.kv_to_coo(*got[:3], (24, 24), tsr.PLUS, 256),
            jit_ref(JM.kv_to_coo, dict(shape=(24, 24), add=jsr.PLUS,
                                       out_cap=256), *want[:3]))

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("stage_cap,out_cap", [(256, 512), (64, 512),
                                                   (256, 100)])
    def test_merge_stage_products(self, masked, stage_cap, out_cap):
        stages, shape = _stages(q=3, prod_cap=256, seed=stage_cap + out_cap)
        jmask, tmask = _mask_pair(shape, seed=22) if masked else (None, None)
        want, jok = jit_ref(
            JM.merge_stage_products,
            dict(shape=shape, add=jsr.PLUS, stage_cap=stage_cap,
                 out_cap=out_cap),
            [tuple(jnp.asarray(x) for x in s) for s in stages], mask=jmask)
        got, tok = TM.merge_stage_products(
            [tuple(torch.as_tensor(x) for x in s) for s in stages], shape,
            tsr.PLUS, stage_cap, out_cap, mask=tmask)
        assert bool(tok) == bool(jok)
        assert_coo_equal(got, want)

    def test_kv_empty(self):
        k, v, n = TM.kv_empty((24, 24), 16, torch.float32, tsr.MIN,
                              device=CPU)
        jk, jv, jn = JM.kv_empty((24, 24), 16, jnp.float32, jsr.MIN)
        assert_values(k, jk)
        assert_values(v, jv)
        assert int(n) == int(jn)


@pytest.mark.parametrize("name", ["plus", "min", "max"])
@pytest.mark.parametrize("distinct,cap", [(40, 64), (200, 64), (200, 256)])
def test_kv_dedup_window_reduces_onto_cap(monkeypatch, name, distinct, cap):
    # full_cap = 256 slots, nlive = 180 live keys; (200, 64) overflows the
    # window's cap (ngrp > cap: ok is false) and (200, 256) keeps full_cap
    (jm, tm), _ = MONOIDS[name]
    rng = np.random.default_rng(distinct + cap)
    kmax = np.iinfo(np.int32).max
    keys = np.full(256, kmax, np.int32)
    keys[:180] = rng.choice(distinct * 7, distinct, replace=False)[
        rng.integers(0, distinct, 180)]
    vals = rng.integers(1, 9, 256).astype(np.float32)
    segments = []
    inner = TM.segment_reduce

    def spy(values, seg_ids, num_segments, add, **kw):
        segments.append((num_segments, kw.get("sorted_ids")))
        return inner(values, seg_ids, num_segments, add, **kw)

    monkeypatch.setattr(TM, "segment_reduce", spy)
    got = TM._kv_dedup_window(torch.as_tensor(keys), torch.as_tensor(vals),
                              torch.tensor(180), tm, cap)
    want = jit_ref(JM._kv_dedup_window, dict(add=jm, cap=cap),
                   jnp.asarray(keys), jnp.asarray(vals), jnp.int32(180))
    assert segments == [(min(cap, 256), True)]
    for g, w in zip(got[:2], want[:2]):
        assert_values(g, w, exact=True)       # integer values: exact sums
    assert int(got[2]) == int(want[2])
    assert bool(got[3]) == bool(want[3])
    assert bool(got[3]) == (len(np.unique(keys[:180])) <= cap)
