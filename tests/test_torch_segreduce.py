"""Parity of the port's segmented reduce with the JAX kernel and dispatch.

On the CPU the wrapper ``repro_torch.kernels.segreduce.segment_reduce`` runs
its plain version (the Hopper kernel itself runs only on the GPU, where
``chip_smoke.py`` holds it against the plain version). Each case feeds the
same numpy inputs to ``repro.kernels.segreduce.segment_reduce_pallas``
(interpret mode) or ``repro.core.semiring.segment_reduce`` and to the port.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import semiring as jsr
from repro.kernels.segreduce import segment_reduce_pallas
from repro_torch.core import semiring as tsr
from repro_torch.kernels import segreduce

from torch_parity import assert_values

# monoid pairs (JAX, port) by name
MONOIDS = {name: (getattr(jsr, name), getattr(tsr, name))
           for name in ("PLUS", "MIN", "MAX", "MIN_INT", "MAX_INT", "LOR",
                        "LAND")}


def both(v, ids):
    return jnp.asarray(v), jnp.asarray(ids), torch.as_tensor(v), \
        torch.as_tensor(ids)


class TestVsPallas:
    """The cases of tests/test_kernels.py::TestSegReduce."""

    @pytest.mark.parametrize("tag", ["sum", "min", "max"])
    @pytest.mark.parametrize("n,s", [(1000, 300), (64, 8), (512, 512),
                                     (300, 1)])
    def test_vs_pallas(self, tag, n, s):
        rng = np.random.default_rng(0)
        ids = np.sort(rng.integers(0, s, n)).astype(np.int32)
        v = rng.standard_normal(n).astype(np.float32)
        jv, jids, tv, tids = both(v, ids)
        want = segment_reduce_pallas(jv, jids, s, tag, interpret=True)
        got = segreduce.segment_reduce(tv, tids, s, tag)
        assert_values(got, want, exact=tag != "sum")

    def test_out_of_range_ids_dropped(self):
        ids = np.asarray([0, 1, 5, 7, 9, -1], np.int32)
        v = np.ones(6, np.float32)
        jv, jids, tv, tids = both(v, ids)
        want = segment_reduce_pallas(jv, jids, 6, "sum", interpret=True)
        got = segreduce.segment_reduce(tv, tids, 6, "sum")
        assert_values(got, want, exact=True)
        np.testing.assert_array_equal(got.numpy(), [1, 1, 0, 0, 0, 1])

    @pytest.mark.parametrize("tag", ["min", "max"])
    def test_untouched_segments_hold_identity(self, tag):
        ids = np.asarray([2, 2], np.int32)
        v = np.asarray([4.0, 7.0], np.float32)
        jv, jids, tv, tids = both(v, ids)
        want = segment_reduce_pallas(jv, jids, 4, tag, interpret=True)
        got = segreduce.segment_reduce(tv, tids, 4, tag)
        assert_values(got, want, exact=True)

    @pytest.mark.parametrize("identity", [None, -(2**31) + 1])
    def test_int_dtype_and_declared_identity(self, identity):
        # MAX_INT's identity lies above the dtype extreme; a touched value
        # below it keeps its true reduction
        v = np.asarray([3, -(2**31), 5], np.int32)
        ids = np.asarray([0, 0, 2], np.int32)
        jv, jids, tv, tids = both(v, ids)
        want = segment_reduce_pallas(jv, jids, 4, "max", identity=identity,
                                     interpret=True)
        got = segreduce.segment_reduce(tv, tids, 4, "max", identity=identity)
        assert_values(got, want, exact=True)

    def test_unsorted_ids(self):
        # the port's kernel takes any id order; so does the Pallas kernel,
        # which only prunes fewer blocks
        rng = np.random.default_rng(3)
        ids = rng.integers(-5, 45, 300).astype(np.int32)
        v = rng.integers(-100, 100, 300).astype(np.int32)
        jv, jids, tv, tids = both(v, ids)
        for tag in ("sum", "min", "max"):
            want = segment_reduce_pallas(jv, jids, 40, tag, interpret=True)
            got = segreduce.segment_reduce(tv, tids, 40, tag)
            assert_values(got, want, exact=True)


class TestDispatch:
    """``core.semiring.segment_reduce`` of both packages on the same data."""

    @pytest.mark.parametrize("name", sorted(MONOIDS))
    def test_tagged_monoids(self, name):
        jm, tm = MONOIDS[name]
        rng = np.random.default_rng(4)
        ids = np.sort(rng.integers(0, 60, 200)).astype(np.int32)
        ids[-10:] = 60                           # padding ids are dropped
        if name in ("LOR", "LAND"):
            v = rng.random(200) < 0.3
        elif name.endswith("_INT"):
            v = rng.integers(-1000, 1000, 200).astype(np.int32)
        else:
            v = rng.standard_normal(200).astype(np.float32)
        jv, jids, tv, tids = both(v, ids)
        want = jsr.segment_reduce(jv, jids, 80, jm, sorted_ids=True)
        got = tsr.segment_reduce(tv, tids, 80, tm, sorted_ids=True)
        assert_values(got, want, exact=name != "PLUS")

    @pytest.mark.parametrize("sorted_ids", [True, False])
    def test_untagged_monoid_scan(self, sorted_ids):
        # a ⊕ b = a + b + a·b (identity 0): the generic segmented scan
        jm = jsr.Monoid(lambda a, b: a + b + a * b, 0.0, None, "user")
        tm = tsr.Monoid(lambda a, b: a + b + a * b, 0.0, None, "user")
        rng = np.random.default_rng(5)
        ids = rng.integers(0, 30, 100).astype(np.int32)
        if sorted_ids:
            ids = np.sort(ids)
        v = (rng.random(100) * 0.1).astype(np.float32)
        jv, jids, tv, tids = both(v, ids)
        want = jsr.segment_reduce(jv, jids, 32, jm, sorted_ids=sorted_ids)
        got = tsr.segment_reduce(tv, tids, 32, tm, sorted_ids=sorted_ids)
        # the scan combines in a tree order: the same reassociation tolerance
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    def test_vector_values(self):
        # rows reduce element by element (the kernel takes them too, as
        # rows of D elements with one touch per row)
        rng = np.random.default_rng(6)
        ids = np.sort(rng.integers(0, 40, 200)).astype(np.int32)
        v = rng.standard_normal((200, 2)).astype(np.float32)
        jv, jids, tv, tids = both(v, ids)
        for jm, tm in (MONOIDS["PLUS"], MONOIDS["MAX"], MONOIDS["MIN"]):
            want = jsr.segment_reduce(jv, jids, 40, jm, sorted_ids=True)
            got = tsr.segment_reduce(tv, tids, 40, tm, sorted_ids=True)
            assert_values(got, want, exact=tm.tag != "sum")

    def test_inputs_outside_the_pallas_contract(self):
        ids = np.asarray([0, 0, 1, 5], np.int32)
        # a bool sum is a logical or (JAX's segment_sum refuses bools)
        b = np.asarray([True, False, False, True])
        got = segreduce.segment_reduce(torch.as_tensor(b),
                                       torch.as_tensor(ids), 3, "sum")
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), [True, False, False])
        # an infinite identity does not fit int values: both packages raise
        iv, jids = np.asarray([3, 4, 1, 2], np.int32), jnp.asarray(ids)
        with pytest.raises(OverflowError):
            jsr.segment_reduce(jnp.asarray(iv), jids, 3, jsr.MIN)
        with pytest.raises(RuntimeError):
            tsr.segment_reduce(torch.as_tensor(iv), torch.as_tensor(ids), 3,
                               tsr.MIN)
        # a tensor identity is as good as a static one
        got = segreduce.segment_reduce(torch.ones(4), torch.as_tensor(ids), 3,
                                       "min", identity=torch.tensor(7.0))
        np.testing.assert_array_equal(got.numpy(), [1.0, 1.0, 7.0])

    def test_cpu_never_counts_launches(self):
        rng = np.random.default_rng(7)
        ids = torch.as_tensor(np.sort(rng.integers(0, 40, 200)), dtype=torch.int32)
        v = torch.as_tensor(rng.standard_normal(200).astype(np.float32))
        before = segreduce.launches
        via_semiring = tsr.segment_reduce(v, ids, 40, tsr.PLUS)
        plain = segreduce.segment_reduce_plain(v, ids, 40, "sum")
        assert torch.equal(via_semiring, plain)
        assert segreduce.launches == before       # the CPU runs no kernel

    def test_wrapper_checks_inputs(self):
        with pytest.raises(ValueError):
            segreduce.segment_reduce(torch.ones(3), torch.zeros(4), 2, "sum")
        with pytest.raises(ValueError):
            segreduce.segment_reduce(torch.ones(3), torch.zeros(3), 2, "prod")


@pytest.mark.parametrize("name", ["ARITHMETIC", "MIN_PLUS", "PLUS_FIRST",
                                  "PLUS_SECOND", "MAX_MIN"])
@pytest.mark.parametrize("a,b", [("float32", "float32"), ("float32", "int32"),
                                 ("int32", "float32"), ("int32", "int32")])
def test_out_dtype_matches_jax(name, a, b):
    want = getattr(jsr, name).out_dtype(jnp.dtype(a), jnp.dtype(b))
    got = getattr(tsr, name).out_dtype(getattr(torch, a), getattr(torch, b))
    assert str(got) == f"torch.{want}"
