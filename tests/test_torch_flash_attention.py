"""Parity of the port's flash attention.

On the CPU ``repro_torch.kernels.flash_attention.flash_attention`` runs its
plain version (the Hopper kernel runs only on the GPU: the ``gpu`` tests
below, and ``chip_smoke.py`` phase 6). The same numpy inputs go to the JAX
kernel in interpret mode (as ``tests/test_kernels.py`` runs it), to its
oracle ``repro.kernels.ref.flash_attention`` and to the port. Inputs the
Pallas kernel refuses (S not a multiple of its blocks, GQA without a
repeat, S != Skv) are held against ``ref`` or ``repro.models.layers``.

Tolerances: float32 results within 2e-5 absolute and relative (two
summation orders of softmax-weighted unit-normal values); bfloat16 results
within 2^-7 relative plus 2^-7 absolute, two bf16 roundings of outputs of
magnitude below 4 (the Pallas kernel rounds p to bf16, the oracle keeps it
in float32).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as tlayers

from torch_parity import np_of

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def qkv(B, S, H, d, seed, skv=None, kvh=None, dtype=np.float32, dv=None):
    rng = np.random.default_rng(seed)
    skv, kvh, dv = skv or S, kvh or H, dv or d
    return (rng.standard_normal((B, S, H, d)).astype(dtype),
            rng.standard_normal((B, skv, kvh, d)).astype(dtype),
            rng.standard_normal((B, skv, kvh, dv)).astype(dtype))


def port(q, k, v, causal, dtype=torch.float32):
    t = [torch.as_tensor(x).to(dtype) for x in (q, k, v)]
    return fa.flash_attention(*t, causal=causal).float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bq,bkv", [(128, 64, 64), (256, 128, 64)])
def test_plain_vs_pallas_and_ref(causal, S, bq, bkv):
    q, k, v = qkv(1, S, 2, 64, seed=S)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want_pallas = np_of(pallas_flash(jq, jk, jv, causal=causal, bq=bq,
                                     bkv=bkv, interpret=True))
    want_ref = np_of(ref.flash_attention(jq, jk, jv, causal))
    got = port(q, k, v, causal)
    np.testing.assert_allclose(got, want_pallas, **F32_TOL)
    np.testing.assert_allclose(got, want_ref, **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_vs_pallas_bf16(causal):
    q, k, v = qkv(1, 128, 2, 128, seed=8)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np_of(pallas_flash(jq, jk, jv, causal=causal, bq=64, bkv=64,
                              interpret=True)).astype(np.float32)
    got = port(q, k, v, causal, torch.bfloat16)
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("S", [1, 77, 130, 258])
def test_ragged_sequence_vs_ref(S):
    # no block divides 77 (the Pallas kernel asserts S % bq == 0); 130 and
    # 258 leave a ragged last 128-row query tile of the Hopper kernel, here
    # at its head dims
    d = {130: 64, 258: 128}.get(S, 16)
    q, k, v = qkv(2, S, 2, d, seed=S)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for causal in (True, False):
        np.testing.assert_allclose(port(q, k, v, causal),
                                   np_of(ref.flash_attention(jq, jk, jv,
                                                             causal)),
                                   **F32_TOL)


@pytest.mark.parametrize("S,skv", [(33, 33), (5, 40), (1, 40), (130, 300),
                                   (40, 130)])
def test_gqa_and_cache_alignment_vs_layers_attention(S, skv):
    # 4 query heads over 2 KV heads, read in place; S < Skv aligns the
    # causal mask at the bottom right, as layers.attention's tril(k=Skv-S)
    # (130 queries over 300 keys: a ragged query tile, and key tiles that
    # cross the diagonal and the end of Skv)
    q, k, v = qkv(2, S, 4, 16, seed=S + skv, skv=skv, kvh=2)
    for causal in (True, False):
        want = np_of(jlayers.attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       chunked=False))
        got = np_of(tlayers.attention(torch.as_tensor(q), torch.as_tensor(k),
                                      torch.as_tensor(v), causal=causal))
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_rows_that_see_no_key_give_zeros():
    # S > Skv under the causal mask: query 0 sees no key (the online
    # softmax's acc / max(l, 1e-30) = 0)
    q, k, v = qkv(1, 4, 2, 16, seed=3, skv=2)
    got = port(q, k, v, True)
    np.testing.assert_array_equal(got[:, :2], 0.0)
    want = np_of(ref.flash_attention(jnp.asarray(q[:, 2:]), jnp.asarray(k),
                                     jnp.asarray(v), True))
    np.testing.assert_allclose(got[:, 2:], want, **F32_TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_rows_that_see_no_key_give_zeros_bf16(d):
    # the same at the Hopper kernel's head dims in bf16: 140 queries over 12
    # keys, so the whole first 128-row tile and some of the second see none
    S, skv = 140, 12
    q, k, v = qkv(1, S, 2, d, seed=d, skv=skv)
    got = port(q, k, v, True, torch.bfloat16)
    np.testing.assert_array_equal(got[:, :S - skv], 0.0)
    cast = [torch.as_tensor(x).bfloat16().float().numpy() for x in (q, k, v)]
    want = np_of(ref.flash_attention(jnp.asarray(cast[0][:, S - skv:]),
                                     jnp.asarray(cast[1]),
                                     jnp.asarray(cast[2]), True))
    np.testing.assert_allclose(got[:, S - skv:], want, **BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_long_sequence_vs_reference_unchunked(causal):
    # above S * Skv = 4096^2 the reference's attention defaults to its
    # _chunked_attention, which clamps the last key slice (keys counted
    # twice when 1024 does not divide Skv) and aligns the causal mask at the
    # top left (ROADMAP §3, reference defect 4); the port's attention is
    # held against the reference's unchunked path, and the chunked one is
    # shown to part from it
    S = 4608
    q, k, v = qkv(1, S, 1, 8, seed=46)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = np_of(jlayers.attention(jq, jk, jv, causal=causal, chunked=False))
    got = np_of(tlayers.attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                  causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    chunked = np_of(jlayers.attention(jq, jk, jv, causal=causal))
    assert np.abs(chunked - want).max() > 1e-2


def test_types_and_shapes_refused():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))


# --------------------------------------------------------------------------
# the Hopper kernel (GPU only)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def test_route_on_the_cpu_is_the_plain_version():
    """On the CPU both the forward and the gradient run the plain version,
    whatever the type and head dims."""
    for d, dv, dtype in ((128, 128, torch.bfloat16), (192, 128, torch.bfloat16),
                         (80, 80, torch.float32), (16, 16, torch.bfloat16)):
        q, k, v = (torch.as_tensor(x).to(dtype)
                   for x in qkv(1, 5, 2, d, seed=1, dv=dv))
        assert fa.route(q, k, v) == "plain"
        assert fa.backward_route(q, k, v) == "plain"


@pytest.mark.parametrize("S", [17, 130])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_backward_plain_vs_jax_vjp(d, causal, S):
    """``flash_attention_backward_plain``, the card kernels' oracle, on the
    plain forward's (o, lse) against ``jax.vjp`` of the JAX package's
    ``ref.flash_attention`` on the same float32 inputs: within 1e-5
    absolute and relative (two orders of float32 sums of O(1) terms)."""
    import jax
    q, k, v = qkv(1, S, 2, d, seed=S + d + causal)
    do = np.random.default_rng(d).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      return_lse=True)
    got = fa.flash_attention_backward_plain(tq, tk, tv, o, lse, tdo,
                                            causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: ref.flash_attention(a, b, c, causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np_of(w), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_route_on_gpu(cuda):
    """The main paths' shapes take the tensor cores: the serving prefill
    (4, 2048, 16, 128), deepseek-v2-lite's MLA (d 192, dv 128), qwen2-vl's
    GQA 28/4 and hubert's d = 80, and the training backward at
    (2, 4096, 16, 128); float32 and d = 16 take the FMA kernels."""
    def ops(B, S, H, kvh, d, dv, dtype=torch.bfloat16):
        return (torch.empty(B, S, H, d, device=cuda, dtype=dtype),
                torch.empty(B, S, kvh, d, device=cuda, dtype=dtype),
                torch.empty(B, S, kvh, dv, device=cuda, dtype=dtype))
    for shape in [(4, 2048, 16, 16, 128, 128), (4, 2048, 16, 16, 192, 128),
                  (4, 2048, 28, 4, 128, 128), (8, 1500, 16, 16, 80, 80)]:
        assert fa.route(*ops(*shape)) == "wgmma", shape
    assert fa.backward_route(*ops(2, 4096, 16, 16, 128, 128)) == "wgmma"
    for shape in [(2, 130, 16, 16, 128, 128, torch.float32),
                  (2, 130, 16, 16, 16, 16)]:
        assert fa.route(*ops(*shape)) == "fma", shape
        assert fa.backward_route(*ops(*shape)) == "fma", shape
    assert fa.backward_route(*ops(1, 130, 16, 16, 192, 128)) == "fma"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,skv,H,kvh,d", [(77, 77, 4, 2, 64),
                                           (130, 200, 4, 1, 128),
                                           (1, 9, 2, 2, 16),
                                           (130, 130, 4, 2, 64),
                                           (258, 258, 2, 1, 128),
                                           (130, 300, 4, 2, 64),
                                           (140, 12, 2, 2, 128),
                                           # MLA's (d, dv) at ragged S, Skv
                                           # beside it; d = 80 with GQA;
                                           # d = 96 over zero columns
                                           (130, 300, 4, 4, (192, 128)),
                                           (300, 77, 4, 4, (192, 128)),
                                           (130, 130, 4, 1, 80),
                                           (77, 200, 4, 2, 80),
                                           (130, 130, 2, 2, 96)])
def test_kernel_vs_plain_on_gpu(cuda, dtype, S, skv, H, kvh, d):
    d, dv = d if isinstance(d, tuple) else (d, d)
    q, k, v = (torch.as_tensor(x, device=cuda).to(dtype)
               for x in qkv(2, S, H, d, seed=14, skv=skv, kvh=kvh, dv=dv))
    for causal in (True, False):
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)


# --------------------------------------------------------------------------
# the backward: the plain formula against autograd, the Function on the GPU
# --------------------------------------------------------------------------

# (B, S, Skv, H, KVH, d, dv, causal): phase 6c's kinds at small sizes (ragged
# S, Skv beside S with rows that see no key, GQA, d = dv in 16, 64, 128,
# hubert's d = 80 and MLA's d = 192 with dv = 128)
BWD_CASES = [(2, 9, 9, 4, 4, 16, 16, True), (2, 9, 9, 4, 2, 16, 16, False),
             (1, 33, 33, 4, 1, 64, 64, True), (1, 20, 40, 4, 2, 64, 64, True),
             (1, 30, 12, 2, 2, 128, 128, True),
             (1, 17, 17, 2, 2, 80, 80, False),
             (1, 13, 13, 2, 2, 192, 128, True),
             # the bf16 tensor-core backward's edges: ragged 64- and 128-row
             # tiles with GQA groups of 2 and 4, rows that see no key, Skv
             # beside S, d = 80 under the causal mask
             (1, 130, 130, 4, 2, 64, 64, True),
             (1, 200, 100, 4, 1, 128, 128, True),
             (1, 77, 150, 4, 2, 128, 128, True),
             (1, 40, 40, 2, 2, 80, 80, True)]


def bwd_operands(B, S, skv, H, kvh, d, dv, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape)).to(dtype)
            for shape in ((B, S, H, d), (B, skv, kvh, d), (B, skv, kvh, dv),
                          (B, S, H, dv))]


@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_plain_vs_autograd(case):
    """``flash_attention_backward_plain`` on the plain forward's (o, lse)
    against torch.autograd through the plain forward, in float32 (float64
    inputs rounded to float32): within 1e-5 absolute and relative."""
    B, S, skv, H, kvh, d, dv, causal = case
    q, k, v, do = bwd_operands(B, S, skv, H, kvh, d, dv, seed=S + d)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa.flash_attention_plain(*leaves, causal=causal, return_lse=True)
    want = torch.autograd.grad(o, leaves, do)
    got = fa.flash_attention_backward_plain(q, k, v, o.detach(), lse.detach(),
                                            do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # a row that sees no key: lse -inf, and neither it nor its keys get a
    # gradient from it
    if causal and skv < S:
        assert bool(torch.isinf(lse[:, :, :S - skv]).all())
        assert not bool(got[0][:, :S - skv].any())


def test_lse_vs_logsumexp_of_jax_scores():
    """The plain version's lse against ``jax.nn.logsumexp`` of the scaled
    scores under the bottom-right causal mask (rows that see no key: -inf)."""
    import jax
    q, k, v, _ = bwd_operands(1, 12, 8, 2, 1, 16, 16, seed=5)
    _, lse = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    jq, jk = jnp.asarray(q.numpy()), jnp.asarray(k.numpy())
    s = jnp.einsum("bqhd,bkhd->bhqk", jq, jnp.repeat(jk, 2, axis=2)) / 4.0
    seen = jnp.arange(8)[None, :] <= jnp.arange(12)[:, None] - 4
    want = jax.nn.logsumexp(jnp.where(seen, s, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np_of(want), rtol=1e-6,
                               atol=1e-6)


def test_plain_path_differentiable_on_cpu():
    """On the CPU the wrapper takes the plain version, which autograd
    differentiates: the gradient exists and matches the plain backward."""
    q, k, v, do = bwd_operands(1, 10, 10, 2, 1, 16, 16, seed=8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    o, lse = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_kernel_vs_plain_on_gpu(cuda, dtype, case):
    """The Function on the card: forward kernel with lse, backward kernel;
    held against the plain backward on the same (q, k, v, o, lse, dO)
    (phase 6c's tolerance: 1e-4 or 2^-7 of |want| plus 1e-4 or 2^-9 of
    max|want|)."""
    B, S, skv, H, kvh, d, dv, causal = case
    q, k, v, do = (t.to(cuda) for t in bwd_operands(
        B, S, skv, H, kvh, d, dv, seed=S + d, dtype=dtype))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.launches, fa.backward_launches)
    out = fa.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.launches, fa.backward_launches) == (before[0] + 1,
                                                   before[1] + 1)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    want = fa.flash_attention_backward_plain(q, k, v, out.detach(), lse, do,
                                             causal=causal)
    rtol, frac = (1e-4, 1e-4) if dtype == torch.float32 else (2.0 ** -7,
                                                              2.0 ** -9)
    for g, w in zip(got, want):
        w = w.float()
        err = (g.float() - w).abs()
        assert bool((err <= rtol * w.abs() + frac * w.abs().max()).all())
