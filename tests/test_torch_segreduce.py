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


# --------------------------------------------------------------------------
# the sorted_ids promise and the sorted route
# --------------------------------------------------------------------------

class TestSortedPromise:
    """``sorted_ids=True`` reaches the kernel wrapper, which takes the sorted
    route on the GPU; on the CPU the plain version checks the promise."""

    @pytest.mark.parametrize("sorted_ids", [True, False])
    @pytest.mark.parametrize("name", ["PLUS", "MIN_INT", "LOR"])
    def test_semiring_passes_sorted_ids(self, monkeypatch, name, sorted_ids):
        seen = []
        inner = segreduce.segment_reduce

        def spy(*args, **kw):
            seen.append(kw.get("sorted_ids"))
            return inner(*args, **kw)

        monkeypatch.setattr(tsr._segreduce, "segment_reduce", spy)
        ids = torch.tensor([0, 0, 2, 5, 5], dtype=torch.int32)
        v = torch.tensor([1, 0, 1, 1, 0]).to(
            torch.bool if name == "LOR" else torch.int32)
        tsr.segment_reduce(v, ids, 6, getattr(tsr, name),
                           sorted_ids=sorted_ids)
        assert seen == [sorted_ids]

    @pytest.mark.parametrize("tag", ["sum", "min", "max"])
    def test_plain_checks_the_promise(self, tag):
        rng = np.random.default_rng(8)
        ids = torch.as_tensor(np.sort(rng.integers(-3, 45, 300)),
                              dtype=torch.int32)
        v = torch.as_tensor(rng.standard_normal(300).astype(np.float32))
        free = segreduce.segment_reduce(v, ids, 40, tag)
        promised = segreduce.segment_reduce(v, ids, 40, tag, sorted_ids=True)
        assert torch.equal(free, promised)
        descending = ids.flip(0)
        with pytest.raises(ValueError, match="descend"):
            segreduce.segment_reduce(v, descending, 40, tag, sorted_ids=True)
        with pytest.raises(ValueError, match="descend"):
            tsr.segment_reduce(v, descending, 40, tsr.MIN, sorted_ids=True)
        # out-of-range ids past either end compare as -1 and S: a stream
        # that only descends among them keeps the promise
        ends = torch.tensor([-7, -2, 0, 3, 3, 90, 41], dtype=torch.int32)
        segreduce.segment_reduce(torch.ones(7), ends, 40, tag,
                                 sorted_ids=True)

    def test_int64_narrowing_keeps_a_sorted_stream_sorted(self):
        s = 50
        ids = torch.tensor([-2**40, -5, -1, 0, 7, 49, 50, 61, 2**40])
        narrow = segreduce._narrow_ids(ids, s, sorted_route=True)
        assert narrow.dtype == torch.int32
        assert narrow.tolist() == [-1, -1, -1, 0, 7, 49, 50, 50, 50]
        assert bool((narrow[1:] >= narrow[:-1]).all())
        # the atomic route sends every out-of-range id to -1
        atomic = segreduce._narrow_ids(ids, s, sorted_route=False)
        assert atomic.tolist() == [-1, -1, -1, 0, 7, 49, -1, -1, -1]
        # int32 ids reach the kernel as they are (it clamps in registers)
        i32 = ids[1:-1].int()
        assert segreduce._narrow_ids(i32, s, sorted_route=True) is i32
        # both narrowings drop the same ids
        v = torch.arange(9, dtype=torch.float32)
        for t in (narrow, atomic):
            got = segreduce.segment_reduce_plain(v, t, s, "sum")
            assert torch.equal(got, segreduce.segment_reduce_plain(
                v, ids, s, "sum"))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                       torch.int32, torch.int64, torch.bool])
    @pytest.mark.parametrize("d", [1, 3])
    @pytest.mark.parametrize("sorted_ids", [True, False])
    def test_route(self, dtype, d, sorted_ids):
        want = "sorted" if sorted_ids and d == 1 else "atomic"
        assert segreduce.route(dtype, d, sorted_ids) == want

    def test_route_refuses_other_dtypes(self):
        with pytest.raises(TypeError):
            segreduce.route(torch.float16, 1, True)

    @pytest.mark.parametrize("tag", ["sum", "min", "max"])
    @pytest.mark.parametrize("n,s", [(1000, 300), (64, 8), (512, 512),
                                     (300, 1)])
    def test_vs_pallas_with_the_promise(self, tag, n, s):
        # TestVsPallas's cases (sorted ids), promised
        rng = np.random.default_rng(0)
        ids = np.sort(rng.integers(0, s, n)).astype(np.int32)
        v = rng.standard_normal(n).astype(np.float32)
        jv, jids, tv, tids = both(v, ids)
        want = segment_reduce_pallas(jv, jids, s, tag, interpret=True)
        got = segreduce.segment_reduce(tv, tids, s, tag, sorted_ids=True)
        assert_values(got, want, exact=tag != "sum")


# --------------------------------------------------------------------------
# on the card: the sorted route against the plain version (chip_smoke.py
# does the full sweep and the main path's shapes)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32,
                                   torch.int64, torch.bool])
@pytest.mark.parametrize("tag", ["sum", "min", "max"])
def test_sorted_route_vs_plain_on_gpu(cuda, dtype, tag):
    rng = np.random.default_rng(9)
    ids = torch.as_tensor(np.sort(rng.integers(-40, 5200, 9000)),
                          dtype=torch.int32, device=cuda)
    if dtype == torch.bool:
        v = torch.as_tensor(rng.random(9000) < 0.5, device=cuda)
    else:
        v = torch.as_tensor(rng.integers(-50, 50, 9000), device=cuda).to(dtype)
    before = segreduce.route_launches["sorted"]
    got = segreduce.segment_reduce(v, ids, 5000, tag, sorted_ids=True)
    want = segreduce.segment_reduce_plain(v, ids, 5000, tag, sorted_ids=True)
    torch.cuda.synchronize()
    assert segreduce.route_launches["sorted"] == before + 1
    assert torch.equal(got, want)            # integer values: exact sums


@pytest.mark.gpu
def test_sorted_route_is_deterministic_and_flags_descents_on_gpu(cuda):
    rng = np.random.default_rng(10)
    ids = torch.as_tensor(np.sort(rng.integers(0, 1 << 20, 1 << 20)),
                          dtype=torch.int32, device=cuda)
    v = torch.as_tensor(rng.standard_normal(1 << 20).astype(np.float32),
                        device=cuda)
    segreduce.reset_descents()
    a = segreduce.segment_reduce(v, ids, 1 << 20, "sum", sorted_ids=True)
    b = segreduce.segment_reduce(v, ids, 1 << 20, "sum", sorted_ids=True)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert segreduce.descents() == 0
    segreduce.segment_reduce(v, ids.flip(0).contiguous(), 1 << 20, "sum",
                             sorted_ids=True)
    assert segreduce.descents() == 1
    segreduce.reset_descents()
