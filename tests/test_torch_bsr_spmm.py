"""Parity of the port's blocked-ELL SpMM and of its host helper.

On the CPU ``repro_torch.kernels.bsr_spmm.bsr_spmm`` runs its plain version
(the Hopper kernel runs only on the GPU: the ``gpu`` tests below, and
``chip_smoke.py`` phase 6b). The same numpy inputs go to the JAX kernel in
interpret mode (as ``tests/test_kernels.py`` runs it), to its oracle
``repro.kernels.ref.bsr_spmm`` and to the port. Shapes the Pallas kernel
refuses (n not a multiple of its tile) are held against ``ref`` only.

Tolerances: float32 sums within 1e-4 relative and absolute (another
summation order over up to 512 unit-normal products); bf16 outputs within
2^-7 relative plus 2^-6 absolute (the port rounds once from float32, the
JAX oracle sums in bf16).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.bsr_spmm import bsr_spmm as pallas_bsr
from repro.kernels.bsr_spmm import to_blocked_ell as jax_to_blocked_ell
from repro_torch.kernels import bsr_spmm as bs

from torch_parity import np_of

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -6)


def port(cols, vals, x):
    return np_of(bs.bsr_spmm(torch.as_tensor(cols), torch.as_tensor(vals),
                             torch.as_tensor(x)))


def both_refs(cols, vals, x, pallas=True):
    jc, jv, jx = jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x)
    out = [np_of(ref.bsr_spmm(jc, jv, jx, x.shape[0]))]
    if pallas:
        out.append(np_of(pallas_bsr(jc, jv, jx, interpret=True)))
    return out


def blocky(rng, M, N, bm, bk, density):
    mask = np.kron(rng.random((M // bm, N // bk)) < density,
                   np.ones((bm, bk), bool))
    return np.where(mask, rng.standard_normal((M, N)), 0.0).astype(np.float32)


@pytest.mark.parametrize("density", [0.1, 0.4, 1.0])
def test_plain_vs_pallas_ref_and_dense(density):
    rng = np.random.default_rng(4)
    dense = blocky(rng, 256, 384, 128, 128, density)
    cols, vals = bs.to_blocked_ell(dense, 128, 128)
    x = rng.standard_normal((384, 128)).astype(np.float32)
    got = port(cols, vals, x)
    for want in both_refs(cols, vals, x) + [dense @ x]:
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_ragged_rows_and_padding():
    rng = np.random.default_rng(5)
    dense = np.zeros((384, 512), np.float32)
    dense[:128, :128] = rng.standard_normal((128, 128))    # row 0: 1 block
    dense[128:256] = rng.standard_normal((128, 512))       # row 1: all
    cols, vals = bs.to_blocked_ell(dense, 128, 128)        # row 2: empty
    assert cols[2, 0] == -1 and (cols[0, 1:] == -1).all()
    x = rng.standard_normal((512, 256)).astype(np.float32)
    got = port(cols, vals, x)
    for want in both_refs(cols, vals, x) + [dense @ x]:
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_padding_contributes_zero_whatever_it_holds():
    # a -1 block holding NaN, over an x block holding inf: still zero
    rng = np.random.default_rng(6)
    cols = np.array([[0, -1], [-1, 1]], np.int32)
    vals = rng.standard_normal((2, 2, 8, 4)).astype(np.float32)
    vals[0, 1] = np.nan
    x = rng.standard_normal((8, 5)).astype(np.float32)
    got = port(cols, vals, x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:8], vals[0, 0] @ x[:4], **F32_TOL)
    np.testing.assert_allclose(got[8:], vals[1, 1] @ x[4:], **F32_TOL)


def test_grouped_matmul_moe_pattern():
    """Block-diagonal A == grouped (per-expert) matmul, the call
    ``models.layers._expert_ffn`` makes: R = E, K = 1, block e at e."""
    rng = np.random.default_rng(6)
    E, C, D, Fd = 4, 128, 128, 128
    xe = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, Fd)).astype(np.float32)
    cols = np.arange(E, dtype=np.int32)[:, None]
    got = port(cols, xe[:, None], w.reshape(E * D, Fd))
    want = np.einsum("ecd,edf->ecf", xe, w).reshape(E * C, Fd)
    np.testing.assert_allclose(got, want, **F32_TOL)
    for ref_out in both_refs(cols, xe[:, None], w.reshape(E * D, Fd)):
        np.testing.assert_allclose(got, ref_out, **F32_TOL)


@pytest.mark.parametrize("R,K,bm,bk,n", [(3, 2, 5, 7, 9), (8, 3, 10, 64, 130),
                                         (4, 1, 640, 16, 24),
                                         (4, 3, 8, 48, 136),
                                         (3, 1, 16, 1408, 64),
                                         (5, 4, 130, 64, 256)])
def test_ragged_blocks_and_columns_vs_ref(R, K, bm, bk, n):
    # bm, bk and n that no tile divides; ids past x's last block are clipped
    # (bk = 48 and 1408 are not multiples of the Hopper kernel's 64-deep
    # slices; bm = 8 is decode's tile, 130 a ragged 128-row one)
    rng = np.random.default_rng(R * K + n)
    nblk = 6
    cols = rng.integers(-1, nblk + 2, (R, K)).astype(np.int32)
    vals = rng.standard_normal((R, K, bm, bk)).astype(np.float32)
    x = rng.standard_normal((nblk * bk, n)).astype(np.float32)
    (want,) = both_refs(cols, vals, x, pallas=False)
    np.testing.assert_allclose(port(cols, vals, x), want, **F32_TOL)


def test_bf16_vs_ref():
    rng = np.random.default_rng(9)
    dense = blocky(rng, 128, 256, 64, 64, 0.5)
    cols, vals = bs.to_blocked_ell(dense, 64, 64)
    x = rng.standard_normal((256, 72)).astype(np.float32)
    jv, jx = jnp.asarray(vals, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    want = np_of(ref.bsr_spmm(jnp.asarray(cols), jv, jx, 256)) \
        .astype(np.float32)
    got = bs.bsr_spmm(torch.as_tensor(cols),
                      torch.as_tensor(vals).bfloat16(),
                      torch.as_tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("R,K,bm,bk,n", [(4, 4, 8, 48, 64), (3, 2, 130, 64, 128)])
def test_padding_rows_and_clipped_ids_vs_ref_and_pallas(dtype, R, K, bm, bk,
                                                        n):
    # K > 1 stored blocks a row with -1 padding and ids past x's last block,
    # and a block-row of padding alone, which gives exact zeros (the experts
    # that received no token); bf16 against the oracle on bf16 inputs
    rng = np.random.default_rng(R * bm + bk)
    nblk = 3
    cols = rng.integers(-1, nblk + 2, (R, K)).astype(np.int32)
    cols[1] = -1
    vals = rng.standard_normal((R, K, bm, bk)).astype(np.float32)
    x = rng.standard_normal((nblk * bk, n)).astype(np.float32)
    if dtype == "bfloat16":
        tv, tx = (torch.as_tensor(a).bfloat16() for a in (vals, x))
        got = bs.bsr_spmm(torch.as_tensor(cols), tv, tx)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        vals, x = tv.float().numpy(), tx.float().numpy()
        tol = BF16_TOL
    else:
        got, tol = port(cols, vals, x), F32_TOL
    np.testing.assert_array_equal(got[bm:2 * bm], 0.0)
    ref_out = np_of(ref.bsr_spmm(jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(x), x.shape[0]))
    np.testing.assert_allclose(got, ref_out, **tol)
    # the Pallas kernel reads x's block by the id itself: clip as ref does
    pallas = np_of(pallas_bsr(jnp.asarray(np.minimum(cols, nblk - 1)),
                              jnp.asarray(vals), jnp.asarray(x),
                              interpret=True))
    np.testing.assert_allclose(got, pallas, **tol)


@pytest.mark.parametrize("bm,bk,max_blocks", [(64, 32, None), (32, 64, 2),
                                              (128, 128, None)])
def test_to_blocked_ell_bitwise_equal_to_jax(bm, bk, max_blocks):
    rng = np.random.default_rng(bm + bk)
    dense = blocky(rng, 256, 384, bm, bk, 0.35)
    jc, jv = jax_to_blocked_ell(dense, bm, bk, max_blocks)
    tc, tv = bs.to_blocked_ell(dense, bm, bk, max_blocks)
    assert tc.dtype == jc.dtype and tv.dtype == jv.dtype
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)


def test_types_and_shapes_refused():
    cols = torch.zeros((2, 1), dtype=torch.int32)
    vals = torch.zeros((2, 1, 4, 4))
    with pytest.raises(ValueError):
        bs.bsr_spmm(cols, vals, torch.zeros((6, 3)))       # 6 % 4 != 0
    with pytest.raises(TypeError):
        bs.bsr_spmm(cols, vals.double(), torch.zeros((8, 3)).double())
    with pytest.raises(TypeError):
        bs.bsr_spmm(cols.float(), vals, torch.zeros((8, 3)))


# --------------------------------------------------------------------------
# the Hopper kernel (GPU only)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def gpu_operands(cuda, dtype, R, K, bm, bk, n, nblk=5):
    # ids run past x's last block, and block-row 1 is padding alone
    g = torch.Generator(device=cuda).manual_seed(R + n)
    cols = torch.randint(-1, nblk + 2, (R, K), generator=g, device=cuda,
                         dtype=torch.int32)
    cols[1] = -1
    vals = torch.randn((R, K, bm, bk), generator=g, device=cuda).to(dtype)
    x = torch.randn((nblk * bk, n), generator=g, device=cuda).to(dtype)
    return cols, vals, x


def launch_once(cols, vals, x):
    before = bs.launches
    got = bs.bsr_spmm(cols, vals, x)
    torch.cuda.synchronize()
    assert bs.launches == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,K,bm,bk,n", [(3, 2, 5, 7, 9), (8, 3, 100, 64, 130),
                                         (16, 1, 8, 256, 88),
                                         (4, 3, 8, 48, 136),
                                         (5, 4, 130, 64, 256)])
def test_kernel_vs_plain_on_gpu(cuda, dtype, R, K, bm, bk, n):
    cols, vals, x = gpu_operands(cuda, dtype, R, K, bm, bk, n)
    got = launch_once(cols, vals, x)
    want = bs.bsr_spmm_plain(cols, vals, x)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,K,bm,bk,n", [(3, 1, 16, 1408, 64),
                                         (4, 2, 200, 1408, 512)])
def test_kernel_long_sums_on_gpu(cuda, dtype, R, K, bm, bk, n):
    # sums of up to K * bk = 2816 products (bk = 1408: the expert product's
    # ragged last 64-deep slice), beyond the fixed tolerances' premise: two
    # float32 summation orders of m terms differ by at most 2 m u (|A| |x|)
    # (u = 2^-24), and a bf16 output by one more rounding on each side
    cols, vals, x = gpu_operands(cuda, dtype, R, K, bm, bk, n)
    got = launch_once(cols, vals, x).double()
    want = bs.bsr_spmm_plain(cols, vals, x).double()
    bound = 2 * K * bk * 2.0 ** -24 * bs.bsr_spmm_plain(
        cols, vals.float().abs(), x.float().abs()).double()
    if dtype == torch.bfloat16:
        bound += 2.0 ** -7 * want.abs()
    assert bool(((got - want).abs() <= bound).all())


# --------------------------------------------------------------------------
# the gradients: the plain backward against autograd, the Function on the GPU
# --------------------------------------------------------------------------

def grad_operands(R, K, bm, bk, n, nblk, seed, oor=0, pad_rows=(),
                  unnamed=(), dtype=torch.float32, device="cpu"):
    """Random blocked-ELL operands and dy: ids up to nblk + oor - 1 (past
    x's last block when oor > 0), -1 in about a fifth of the slots, rows of
    padding alone and column blocks no slot names."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, nblk + oor, (R, K)).astype(np.int32)
    cols[rng.random((R, K)) < 0.2] = -1
    for c in unnamed:
        cols[cols == c] = -1
    cols[list(pad_rows)] = -1
    t = [torch.as_tensor(a).to(device) for a in (
        cols, rng.standard_normal((R, K, bm, bk)),
        rng.standard_normal((nblk * bk, n)),
        rng.standard_normal((R * bm, n)))]
    return t[0], t[1].to(dtype), t[2].to(dtype), t[3].to(dtype)


# (R, K, bm, bk, n, nblk, ids past the end, padding rows, unnamed blocks)
GRAD_CASES = [(6, 4, 8, 8, 16, 4, 0, (), (1,)),
              (5, 3, 5, 7, 9, 4, 2, (0,), ()),
              (8, 1, 12, 16, 8, 8, 0, (2, 5), (3,)),
              (4, 4, 8, 4, 4, 3, 1, (3,), (0, 2))]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_backward_plain_vs_autograd(case):
    """``bsr_spmm_backward_plain`` against torch.autograd through the plain
    forward (K up to 4, repeated ids, ids past the last block, padding
    rows, unnamed column blocks), float32 within 1e-5: the same float32
    products summed in another order. Unnamed column blocks get zeros."""
    R, K, bm, bk, n, nblk, oor, pad_rows, unnamed = case
    cols, vals, x, dy = grad_operands(R, K, bm, bk, n, nblk, seed=R * K,
                                      oor=oor, pad_rows=pad_rows,
                                      unnamed=unnamed)
    leaves = [vals.clone().requires_grad_(), x.clone().requires_grad_()]
    want = torch.autograd.grad(bs.bsr_spmm_plain(cols, *leaves), leaves, dy)
    got = bs.bsr_spmm_backward_plain(cols, vals, x, dy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for c in unnamed:
        assert not bool(got[1][c * bk:(c + 1) * bk].any())
    assert not bool(got[0][cols < 0].any())


def test_transposed_layout_names_every_pair():
    """A^T's blocked-ELL form (what the dx product runs on): block-row c
    holds vals[r, t]^T with id r for every (r, t) whose clipped id is c,
    in ascending (r, t), padded with -1."""
    cols = torch.tensor([[0, 2], [2, -1], [7, 0]], dtype=torch.int32)
    vals = torch.arange(3 * 2 * 2 * 3, dtype=torch.float32) \
        .reshape(3, 2, 2, 3)
    cols_t, vals_t = bs._transposed(cols, vals, nblk=3)
    assert cols_t.tolist() == [[0, 2, -1], [-1, -1, -1], [0, 1, 2]]
    assert torch.equal(vals_t[0, 0], vals[0, 0].T)
    assert torch.equal(vals_t[0, 1], vals[2, 1].T)
    assert torch.equal(vals_t[2, 2], vals[2, 0].T)    # id 7 clipped to 2
    assert not bool(vals_t[1].any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_backward_kernel_vs_plain_on_gpu(cuda, dtype, case):
    """Both gradients through ``BsrSpmm`` (two products on the kernel)
    against the plain backward: float32 within 1e-4, bfloat16 within 2^-7
    of |want| plus 2^-7 of max|want| (one rounding of the stored output
    and of dy's products)."""
    R, K, bm, bk, n, nblk, oor, pad_rows, unnamed = case
    cols, vals, x, dy = grad_operands(R, K, bm, bk, n, nblk, seed=R * K,
                                      oor=oor, pad_rows=pad_rows,
                                      unnamed=unnamed, dtype=dtype,
                                      device=cuda)
    leaves = [vals.clone().requires_grad_(), x.clone().requires_grad_()]
    before = bs.backward_launches
    got = torch.autograd.grad(bs.bsr_spmm(cols, *leaves), leaves, dy)
    torch.cuda.synchronize()
    assert bs.backward_launches == before + 2
    want = bs.bsr_spmm_backward_plain(cols, vals, x, dy)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for g, w in zip(got, want):
        w = w.float()
        err = (g.float() - w).abs()
        assert bool((err <= tol * w.abs() + tol * w.abs().max()).all())
