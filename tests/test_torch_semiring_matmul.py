"""Parity of the port's dense-tile semiring matmul and dense contraction.

On the CPU ``repro_torch.kernels.semiring_matmul.semiring_matmul`` runs its
plain version (the Hopper kernel runs only on the GPU: the ``gpu`` tests
below, and ``chip_smoke.py`` phase 2b). The same numpy inputs go to the JAX
kernel in interpret mode (as ``tests/test_kernels.py`` runs it), to its
oracle ``repro.kernels.ref.semiring_matmul`` and to the port.

Tolerances: integer-valued data, min/max and bool are compared bitwise (NaN
equal to NaN). Random float sums are held to the bound of any summation
order, |got - want| <= 2 K u (|A| @ |B|) with u the unit roundoff of the
type; bf16 results add one bf16 rounding, 2^-8 |want|.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import semiring as jsr
from repro.kernels import ref
from repro.kernels.semiring_matmul import semiring_matmul as pallas_smm
from repro_torch.core import semiring as tsr
from repro_torch.kernels import semiring_matmul as smm

from torch_parity import jit_ref, np_of

KINDS = ("plus_times", "min_plus", "max_min", "or_and")


def operands(kind, m, k, n, seed, dtype=np.float32):
    """Bools for or_and, small integers for plus_times (exact sums), normal
    floats for min_plus/max_min (min and max are exact anyway)."""
    rng = np.random.default_rng(seed)
    if kind == "or_and":
        return rng.random((m, k)) < 0.2, rng.random((k, n)) < 0.2
    if kind == "plus_times":
        return (rng.integers(-4, 5, (m, k)).astype(dtype),
                rng.integers(-4, 5, (k, n)).astype(dtype))
    return (rng.standard_normal((m, k)).astype(dtype),
            rng.standard_normal((k, n)).astype(dtype))


def port(a, b, kind):
    return np_of(smm.semiring_matmul(torch.as_tensor(a), torch.as_tensor(b),
                                     kind))


def order_bound(a, b, u):
    """2 K u (|A| @ |B|): how far two summation orders may part."""
    k = a.shape[1]
    return 2 * k * u * (np.abs(a.astype(np.float64))
                        @ np.abs(b.astype(np.float64)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 384)])
def test_plain_vs_pallas_and_ref(kind, shape):
    m, k, n = shape
    a, b = operands(kind, m, k, n, seed=m + k + n)
    want_pallas = np_of(pallas_smm(jnp.asarray(a), jnp.asarray(b), kind=kind,
                                   interpret=True))
    want_ref = np_of(ref.semiring_matmul(jnp.asarray(a), jnp.asarray(b),
                                         kind))
    got = port(a, b, kind)
    assert got.dtype == want_ref.dtype == want_pallas.dtype
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_ref)


@pytest.mark.parametrize("kind", KINDS)
def test_ragged_shape_vs_ref(kind):
    # no block divides 100 x 77 x 53: the Pallas kernel refuses it, the port
    # takes any shape
    a, b = operands(kind, 100, 77, 53, seed=5)
    want = np_of(ref.semiring_matmul(jnp.asarray(a), jnp.asarray(b), kind))
    np.testing.assert_array_equal(port(a, b, kind), want)


def test_random_float_sums_within_order_bound():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((96, 200)).astype(np.float32)
    b = rng.standard_normal((200, 64)).astype(np.float32)
    want = np_of(ref.semiring_matmul(jnp.asarray(a), jnp.asarray(b),
                                     "plus_times"))
    got = port(a, b, "plus_times")
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= order_bound(a, b, 2.0 ** -24))


def test_bf16_plus_times():
    # the kernel (and its plain version) accumulate in f32 and round once;
    # the JAX reference multiplies in bf16: one bf16 rounding apart
    rng = np.random.default_rng(7)
    a = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal((96, 32)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(ref.semiring_matmul(ja, jb, "plus_times"), np.float32)
    ta = torch.as_tensor(a).to(torch.bfloat16)
    tb = torch.as_tensor(b).to(torch.bfloat16)
    got = smm.semiring_matmul(ta, tb, "plus_times")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    an, bn = np.asarray(ja, np.float32), np.asarray(jb, np.float32)
    tol = order_bound(an, bn, 2.0 ** -24) + 2.0 ** -8 * np.abs(want)
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_wide_and_integer_plus_times(dtype):
    a, b = operands("plus_times", 40, 33, 21, seed=8, dtype=dtype)
    got = port(a, b, "plus_times")
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, a @ b)


@pytest.mark.parametrize("kind", ["min_plus", "max_min"])
def test_nan_and_inf_propagate_like_jnp(kind):
    a, b = operands(kind, 24, 20, 16, seed=9)
    a[3, 5] = np.nan
    a[7, :] = np.inf
    b[:, 2] = -np.inf                       # inf + (-inf) = nan in min_plus
    b[4, 9] = np.nan
    want = np_of(ref.semiring_matmul(jnp.asarray(a), jnp.asarray(b), kind))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(port(a, b, kind), want)
    # f64 (JAX runs without x64 here): numpy's min/max propagate NaN too
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    with np.errstate(invalid="ignore"):     # inf + (-inf), on purpose
        if kind == "min_plus":
            want64 = np.min(a64[:, :, None] + b64[None], axis=1)
        else:
            want64 = np.max(np.minimum(a64[:, :, None], b64[None]), axis=1)
    np.testing.assert_array_equal(port(a64, b64, kind), want64)


def signed_zeros(kind, m, k, n, seed, dtype=np.float32):
    """Operands of 0, -0, 1 and 2 (min_plus) or 0, -0, -1 and -2 (max_min):
    most results tie +0 and -0 terms ((-0) + (-0) is the only -0 sum,
    min(+0, -0) is -0)."""
    rng = np.random.default_rng(seed)
    vals = np.array([0.0, -0.0, 1.0, 2.0], dtype)
    if kind == "max_min":
        vals = -vals
    return (vals[rng.integers(0, 4, (m, k))], vals[rng.integers(0, 4, (k, n))])


def same_bits(got, want):
    """Equal values and equal signs of zero."""
    return bool(((got == want) & (got.signbit() == want.signbit())).all())


@pytest.mark.parametrize("kind,zero", [("min_plus", -0.0), ("max_min", 0.0)])
def test_signed_zero_ties_do_not_hang_on_the_order_of_k(kind, zero):
    # -0 orders below +0 (min.NaN / max.NaN on the card): a tie of the two
    # zeros gives -0 under min and +0 under max, whichever comes first
    # terms +0 and -0: (+0) + (+0) and (-0) + (-0); min(+0, +0), min(-0, +0)
    a = torch.tensor([[0.0, -0.0]])
    b = torch.tensor([[0.0], [-0.0 if kind == "min_plus" else 0.0]])
    want = torch.tensor([[zero]])
    for k_order in ([0, 1], [1, 0]):
        got = smm.semiring_matmul(a[:, k_order], b[k_order], kind)
        assert same_bits(got, want)
    a, b = (torch.as_tensor(x) for x in signed_zeros(kind, 9, 17, 7, seed=3))
    got = smm.semiring_matmul(a, b, kind)
    flipped = smm.semiring_matmul(a.flip(1), b.flip(0), kind)
    assert same_bits(got, flipped)
    zeros = got == 0
    assert bool((zeros & got.signbit()).any()) and \
        bool((zeros & ~got.signbit()).any())


@pytest.mark.parametrize("kind", KINDS)
def test_empty_contraction_gives_identity(kind):
    a, b = operands(kind, 3, 0, 4, seed=10)
    ident = {"plus_times": 0.0, "min_plus": math.inf, "max_min": -math.inf,
             "or_and": False}[kind]
    got = port(a, b, kind)
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got, np.full((3, 4), ident, got.dtype))


def test_types_and_shapes_refused():
    i = torch.ones((4, 4), dtype=torch.int32)
    for kind in ("min_plus", "max_min"):    # no +-inf identity for ints
        with pytest.raises(TypeError, match=kind):
            smm.semiring_matmul(i, i, kind)
    with pytest.raises(TypeError):
        smm.semiring_matmul(i.half(), i.half(), "plus_times")
    with pytest.raises(ValueError, match="kind"):
        smm.semiring_matmul(i, i, "max_plus")
    with pytest.raises(ValueError, match="K"):
        smm.semiring_matmul(i, torch.ones((3, 4), dtype=torch.int32))


def test_mixed_inputs_cast_to_output_type():
    a = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    b = torch.ones((3, 2), dtype=torch.float64)
    got = smm.semiring_matmul(a, b, "plus_times")
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), [[3, 3], [12, 12]])
    assert smm.semiring_matmul(a, a.T, "or_and").dtype == torch.bool


def test_cpu_never_counts_launches():
    before = smm.launches
    port(*operands("min_plus", 8, 8, 8, seed=11), "min_plus")
    assert smm.launches == before


# --------------------------------------------------------------------------
# core/semiring: kernel algebra by parts, dense contraction
# --------------------------------------------------------------------------

STANDARD = ("ARITHMETIC", "BOOLEAN", "MIN_PLUS", "MAX_PLUS", "MAX_MIN",
            "MIN_MAX", "MIN_SELECT2ND", "MAX_SELECT2ND", "MIN_INT_SELECT2ND",
            "PLUS_FIRST", "PLUS_SECOND", "PLUS_PAIR")
KERNEL_KIND = {"ARITHMETIC": "plus_times", "BOOLEAN": "or_and",
               "MIN_PLUS": "min_plus", "MAX_MIN": "max_min"}


@pytest.mark.parametrize("name", STANDARD)
def test_kernel_kind_by_parts(name):
    assert tsr._kernel_kind(getattr(tsr, name)) == KERNEL_KIND.get(name)


def test_kernel_kind_ignores_names():
    renamed = tsr.semiring(torch.minimum, math.inf, torch.add, tag="min",
                           name="anything")
    assert tsr._kernel_kind(renamed) == "min_plus"
    # the same name with other parts: MIN_INT's identity is not +inf
    assert tsr._kernel_kind(tsr.Semiring(tsr.MIN_INT, torch.add,
                                         "min_plus")) is None


DENSE = ("ARITHMETIC", "BOOLEAN", "MIN_PLUS", "MAX_MIN", "MAX_PLUS",
         "MIN_MAX", "PLUS_PAIR")


def dense_operands(name, m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, (m, k)).astype(np.float32)
    b = rng.integers(0, 5, (k, n)).astype(np.float32)
    if name == "BOOLEAN":
        return a > 2, b > 2
    return a, b


@pytest.mark.parametrize("name", DENSE)
def test_dense_semiring_matmul(name):
    # k = 40 with k_chunk 16: two whole chunks and a masked partial one
    a, b = dense_operands(name, 12, 40, 9, seed=12)
    jsr_, tsr_ = getattr(jsr, name), getattr(tsr, name)
    want = jit_ref(jsr.dense_semiring_matmul, dict(sr=jsr_, k_chunk=16),
                   jnp.asarray(a), jnp.asarray(b))
    got = tsr.dense_semiring_matmul(torch.as_tensor(a), torch.as_tensor(b),
                                    tsr_, k_chunk=16)
    np.testing.assert_array_equal(np_of(got), np_of(want))
    assert np_of(got).dtype == np_of(want).dtype


@pytest.mark.parametrize("name", DENSE)
def test_dense_semiring_matvec(name):
    a, b = dense_operands(name, 12, 40, 1, seed=13)
    x = b[:, 0]
    jsr_, tsr_ = getattr(jsr, name), getattr(tsr, name)
    if name == "PLUS_PAIR":
        # JAX's matvec indexes the scalar that PLUS_PAIR's mul returns and
        # raises; its matmul over x as one column is the reference
        want = jsr.dense_semiring_matmul(jnp.asarray(a),
                                         jnp.asarray(x)[:, None], jsr_)[:, 0]
    else:
        want = jit_ref(jsr.dense_semiring_matvec, dict(sr=jsr_),
                       jnp.asarray(a), jnp.asarray(x))
    got = tsr.dense_semiring_matvec(torch.as_tensor(a), torch.as_tensor(x),
                                    tsr_)
    np.testing.assert_array_equal(np_of(got), np_of(want))


# --------------------------------------------------------------------------
# on the card: the kernel against its plain version (chip_smoke.py does the
# full sweep at the main path's shapes)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(128, 128, 128), (100, 77, 53),
                                   (129, 17, 257), (256, 48, 128)])
def test_kernel_vs_plain_on_gpu(cuda, kind, shape):
    a, b = (torch.as_tensor(x, device=cuda)
            for x in operands(kind, *shape, seed=14))
    before = smm.launches
    got = smm.semiring_matmul(a, b, kind)
    torch.cuda.synchronize()
    assert smm.launches == before + 1
    assert torch.equal(got, smm.semiring_matmul_plain(a, b, kind))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [31, 32, 33, 777])
def test_or_and_partial_words_on_gpu(cuda, k):
    # K packed into 32-bit words: a K that 32 does not divide leaves zero
    # bits in the last word
    a, b = (torch.as_tensor(x, device=cuda)
            for x in operands("or_and", 129, k, 257, seed=k))
    assert torch.equal(smm.semiring_matmul(a, b, "or_and"),
                       smm.semiring_matmul_plain(a, b, "or_and"))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["min_plus", "max_min"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_signed_zero_ties_on_gpu(cuda, kind, dtype):
    a, b = (torch.as_tensor(x, device=cuda)
            for x in signed_zeros(kind, 129, 17, 257, seed=15, dtype=dtype))
    assert same_bits(smm.semiring_matmul(a, b, kind),
                     smm.semiring_matmul_plain(a, b, kind))


@pytest.mark.gpu
def test_kernel_refuses_int_min_plus_on_gpu(cuda):
    i = torch.ones((4, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        smm.semiring_matmul(i, i, "min_plus")
