"""Parity of the port's SSD intra-chunk contraction.

On the CPU ``repro_torch.kernels.ssd_chunk.ssd_chunk`` runs its plain
version (the Hopper kernel runs only on the GPU: the ``gpu`` test below,
and ``chip_smoke.py`` phase 8). The same numpy inputs go to the JAX kernel
in interpret mode (as ``tests/test_kernels.py`` runs it), to its oracle
``repro.kernels.ref.ssd_chunk_diag`` (one chunk at a time, as
``repro.kernels.ops.ssd_chunk`` loops over G) and to the port.

Tolerance: 1e-4 absolute and relative, the JAX tests' own for this kernel:
every version computes in float32 from the same (possibly bf16) inputs, and
they part only by summation order (the cumsum over up to 256 steps, the
products over q and N) on outputs of magnitude up to about 30.

The backward: ``ssd_chunk_backward_plain`` (the formula the backward
kernel computes) against ``jax.vjp`` of ``ref.ssd_chunk_diag`` and against
torch autograd through ``ssd_chunk_plain``, each gradient within 1e-5 of
its own largest |g| (float32 sums over q, P, N and the heads in other
orders; dA sums a reverse cumsum whose terms cancel). Where a segment above
the diagonal overflows, the reference's gradients of dt and A are NaN
(ROADMAP §3, reference defect 8); the port's are finite and held against
float64 autograd of a twin that selects before the exp.

The backward's tensor-core route splits each float32 operand into two bf16
terms; ``test_bf16_split_backward_within_phase_8b_limit`` emulates that
arithmetic here and holds it to ``chip_smoke.py`` phase 8b's limit against
float64 gradients, before any card run.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd
from repro_torch.kernels import ssd_chunk as sc

from torch_parity import np_of

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (phase 8b's magnitude bounds, for gpu tests)

TOL = dict(rtol=1e-4, atol=1e-4)


def inputs(G, q, H, P, N, seed, model_like=False):
    """x, dt, A, B, C as numpy float32. ``model_like`` draws dt and A as
    mamba2's init makes them: A = -exp(log linspace(1, 16)) and dt =
    softplus(N(0, 1) + dt_bias), dt_bias = softplus^-1 of a log-spaced
    [1e-3, 1e-1]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, q, H, P)).astype(np.float32)
    B = rng.standard_normal((G, q, N)).astype(np.float32)
    C = rng.standard_normal((G, q, N)).astype(np.float32)
    if model_like:
        A = -np.linspace(1.0, 16.0, H).astype(np.float32)
        dt0 = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))
        bias = np.log(np.expm1(dt0))
        pre = rng.standard_normal((G, q, H)) + bias
        dt = np.logaddexp(pre, 0.0).astype(np.float32)
    else:
        A = (-rng.random(H) - 0.5).astype(np.float32)
        dt = (rng.random((G, q, H)) * 0.1 + 0.01).astype(np.float32)
    return x, dt, A, B, C


def port(x, dt, A, B, C, dtype=torch.float32, dt_dtype=torch.float32):
    return sc.ssd_chunk(torch.as_tensor(x).to(dtype),
                        torch.as_tensor(dt).to(dt_dtype),
                        torch.as_tensor(A).to(dt_dtype),
                        torch.as_tensor(B).to(dtype),
                        torch.as_tensor(C).to(dtype))


def oracle(x, dt, A, B, C):
    """``ref.ssd_chunk_diag`` one chunk at a time, stacked over G."""
    ys, sts = zip(*(ref.ssd_chunk_diag(*(jnp.asarray(a) for a in
                                         (x[g], dt[g], A, B[g], C[g])))
                    for g in range(x.shape[0])))
    return np.stack([np_of(v) for v in ys]), np.stack([np_of(v) for v in sts])


def check(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(np_of(g), np_of(w), **TOL)


@pytest.mark.parametrize("q,H,P,N", [(64, 4, 32, 32), (128, 2, 64, 64)])
def test_plain_vs_pallas_and_ref(q, H, P, N):
    x, dt, A, B, C = inputs(3, q, H, P, N, seed=9)
    got = port(x, dt, A, B, C)
    check(got, pallas_ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                          interpret=True))
    check(got, oracle(x, dt, A, B, C))


@pytest.mark.parametrize("q", [40, 256, 1])
def test_ragged_and_long_chunks(q):
    # q = 40: mamba's chunk = min(ssm_chunk, S) for a short prompt; 256:
    # the longest chunk the kernel takes
    x, dt, A, B, C = inputs(2, q, 3, 8, 16, seed=q)
    got = port(x, dt, A, B, C)
    check(got, pallas_ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                          interpret=True))
    check(got, oracle(x, dt, A, B, C))


def test_bf16_inputs_vs_pallas():
    # x, B, C, dt and A in bf16: every version casts them to float32 first
    # (the Pallas kernel at its :26-30), so the inputs' bf16 values agree and
    # the float32 tolerance holds
    x, dt, A, B, C = inputs(2, 64, 4, 16, 32, seed=11, model_like=True)
    bf = jnp.bfloat16
    want = pallas_ssd(*(jnp.asarray(a, bf) for a in (x, dt, A, B, C)),
                      interpret=True)
    check(port(x, dt, A, B, C, torch.bfloat16, torch.bfloat16), want)
    # x, B, C in bf16 with dt and A in float32 (the f32-parameter configs)
    want = pallas_ssd(jnp.asarray(x, bf), jnp.asarray(dt), jnp.asarray(A),
                      jnp.asarray(B, bf), jnp.asarray(C, bf), interpret=True)
    check(port(x, dt, A, B, C, torch.bfloat16), want)


def test_masked_overflow_gives_no_nan():
    # the model's dt and A over a 128-step chunk: above the diagonal
    # cA_i - cA_k passes 88, so exp overflows to inf there; the masked
    # entries must be selected away (0 * inf would be NaN)
    x, dt, A, B, C = inputs(2, 128, 8, 16, 32, seed=12, model_like=True)
    cA = np.cumsum(dt.astype(np.float64) * A, axis=1)
    assert (cA[:, :1] - cA[:, -1:]).max() > 89.0          # exp(seg) = inf
    got = port(x, dt, A, B, C)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    check(got, pallas_ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                          interpret=True))
    check(got, oracle(x, dt, A, B, C))


def cotangents(G, q, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, q, H, P)).astype(np.float32),
            rng.standard_normal((G, H, P, N)).astype(np.float32))


def jax_vjp(x, dt, A, B, C, dy, dst):
    """(dx, ddt, dA, dB, dC) of ``ref.ssd_chunk_diag``, one chunk at a time
    (``jax.vjp``), stacked over G; dA summed over G."""
    grads = []
    for g in range(x.shape[0]):
        _, vjp = jax.vjp(ref.ssd_chunk_diag, *(jnp.asarray(a) for a in
                                               (x[g], dt[g], A, B[g], C[g])))
        grads.append([np.asarray(v) for v in vjp((jnp.asarray(dy[g]),
                                                  jnp.asarray(dst[g])))])
    dx, ddt, dA, dB, dC = zip(*grads)
    return (np.stack(dx), np.stack(ddt), np.sum(dA, axis=0), np.stack(dB),
            np.stack(dC))


def autograd_plain(x, dt, A, B, C, dy, dst, dtype=torch.float32):
    """The five gradients by torch autograd through ``ssd_chunk_plain``."""
    ins = [torch.as_tensor(a).to(dtype).requires_grad_()
           for a in (x, dt, A, B, C)]
    y, st = sc.ssd_chunk_plain(*ins)
    out = (y * torch.as_tensor(dy)).sum() + (st * torch.as_tensor(dst)).sum()
    return torch.autograd.grad(out, ins)


def grads_close(got, want, frac=1e-5):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        g = np_of(g).astype(np.float64) if isinstance(g, torch.Tensor) \
            else np.asarray(g, np.float64)
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=frac * float(np.abs(w).max()))


BACKWARD_SHAPES = [(3, 1, 3, 8, 16), (3, 40, 3, 8, 16), (2, 128, 4, 16, 8)]


@pytest.mark.parametrize("G,q,H,P,N", BACKWARD_SHAPES)
def test_backward_plain_vs_jax_vjp(G, q, H, P, N):
    x, dt, A, B, C = inputs(G, q, H, P, N, seed=20 + q)
    dy, dst = cotangents(G, q, H, P, N, seed=30 + q)
    got = sc.ssd_chunk_backward_plain(
        *(torch.as_tensor(a) for a in (x, dt, A, B, C, dy, dst)))
    assert [t.dtype for t in got] == [torch.float32] * 5
    grads_close(got, jax_vjp(x, dt, A, B, C, dy, dst))


@pytest.mark.parametrize("G,q,H,P,N", BACKWARD_SHAPES)
def test_backward_plain_vs_autograd(G, q, H, P, N):
    x, dt, A, B, C = inputs(G, q, H, P, N, seed=40 + q)
    dy, dst = cotangents(G, q, H, P, N, seed=50 + q)
    got = sc.ssd_chunk_backward_plain(
        *(torch.as_tensor(a) for a in (x, dt, A, B, C, dy, dst)))
    grads_close(got, autograd_plain(x, dt, A, B, C, dy, dst))


def test_backward_plain_gives_each_gradient_in_its_input_type():
    x, dt, A, B, C = inputs(2, 16, 2, 4, 8, seed=3)
    dy, dst = cotangents(2, 16, 2, 4, 8, seed=4)
    bf = torch.bfloat16
    t = [torch.as_tensor(a) for a in (x, dt, A, B, C)]
    got = sc.ssd_chunk_backward_plain(t[0].to(bf), t[1], t[2].to(bf),
                                      t[3].to(bf), t[4].to(bf),
                                      torch.as_tensor(dy),
                                      torch.as_tensor(dst))
    assert [g.dtype for g in got] == [bf, torch.float32, bf, bf, bf]


def test_backward_route_on_the_cpu_is_the_plain_version():
    t = [torch.as_tensor(a) for a in inputs(1, 8, 2, 64, 16, seed=5)]
    assert sc.backward_route(*t) == "plain"


def _safe_twin64(x, dt, A, B, C, dy, dst):
    """float64 autograd of the SSD chunk with the diagonal selected before
    the exp (no inf reaches the graph)."""
    ins = [torch.as_tensor(a).double().requires_grad_()
           for a in (x, dt, A, B, C)]
    x_, dt_, A_, B_, C_ = ins
    q = x.shape[1]
    cA = torch.cumsum(dt_ * A_, dim=1)
    seg = cA[:, :, None, :] - cA[:, None, :, :]
    causal = torch.ones(q, q, dtype=torch.bool).tril()[None, :, :, None]
    L = torch.exp(torch.where(causal, seg, -math.inf))
    w = (C_ @ B_.transpose(1, 2))[..., None] * L * dt_[:, None]
    y = torch.einsum("gqkh,gkhp->gqhp", w, x_)
    dec = torch.exp(cA[:, -1:] - cA) * dt_
    st = torch.einsum("gkhp,gkn->ghpn", x_ * dec[..., None], B_)
    out = (y * torch.as_tensor(dy).double()).sum() + \
        (st * torch.as_tensor(dst).double()).sum()
    return torch.autograd.grad(out, ins)


def _split(v):
    """A float32 tensor's two bf16 terms hi = bf16(v), lo = bf16(v - hi), as
    float32 (``csrc/ssd_chunk_bwd.cu``'s ``split2``)."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def split_backward(x, dt, A, B, C, dy, dst):
    """The tensor-core backward route's arithmetic in plain PyTorch: x, B,
    C bf16 (their products exact in float32); each product with one float32
    operand (dy, dst) takes its hi and lo terms, each product of two (W and
    dy, x dec and dst) hi hi + hi lo + lo hi; the rest float32, as the
    FMA route and ``ssd_chunk_backward_plain``."""
    x, B, C = (t.float() for t in (x, B, C))
    dt, a = dt.float(), A.float()
    cA, L = sc._decay(dt, A)                                 # (G, i, k, H)
    S = C @ B.transpose(1, 2)
    SL = S[..., None] * L
    W = SL * dt[:, None, :, :]
    E = torch.exp(cA[:, -1:, :] - cA)
    dec = E * dt
    dyh, dyl = _split(dy)
    dsth, dstl = _split(dst)
    dW = sum(torch.einsum("gihp,gkhp->gikh", d, x) for d in (dyh, dyl))
    U = sum(torch.einsum("gkn,ghpn->gkhp", B, d) for d in (dsth, dstl))
    Wh, Wl = _split(W)
    dx = sum(torch.einsum("gikh,gihp->gkhp", w, d)
             for w, d in ((Wh, dyh), (Wh, dyl), (Wl, dyh))) + dec[..., None] * U
    xwh, xwl = _split(x * dec[..., None])
    dBst = sum(torch.einsum("gkhp,ghpn->gkn", w, d)
               for w, d in ((xwh, dsth), (xwh, dstl), (xwl, dsth)))
    ddec = (x * U).sum(-1)
    dS = (dW * L * dt[:, None, :, :]).sum(-1)
    dC = dS @ B
    dB = dS.transpose(1, 2) @ C + dBst
    M = dW * W
    dcA = M.sum(2) - M.sum(1) - ddec * dec
    dcA[:, -1] += (ddec * dec).sum(1)
    R = torch.flip(torch.cumsum(torch.flip(dcA, [1]), dim=1), [1])
    ddt = (dW * SL).sum(1) + ddec * E + a * R
    dA = (dt * R).sum((0, 1))
    return dx, ddt, dA, dB, dC


@pytest.mark.parametrize("G,q,H,P,N", [(2, 128, 4, 64, 128),
                                       (3, 77, 5, 64, 40)])
def test_bf16_split_backward_within_phase_8b_limit(G, q, H, P, N):
    """The tensor-core route's two-term split, emulated on the model-like
    inputs (exp overflows above the diagonal), against float64 gradients of
    the same bf16 x, B, C: every gradient within phase 8b's limit (2^-10 of
    its terms' magnitudes plus 1e-6, ``chip_smoke.ssd_bwd_bounds``), before
    the kernel's own bf16 rounding of dx, dB and dC, which the limit takes
    on top. The split's own error is ~2^-16 of those magnitudes: the float32
    cumsum of dt A, as on the card, sets most of what remains."""
    x, dt, A, B, C = inputs(G, q, H, P, N, seed=60 + q, model_like=True)
    dy, dst = cotangents(G, q, H, P, N, seed=70 + q)
    cA = np.cumsum(dt.astype(np.float64) * A, axis=1)
    assert (cA[:, :1] - cA[:, -1:]).max() > 89.0          # exp(seg) = inf
    xb, Bb, Cb = (torch.as_tensor(a).bfloat16() for a in (x, B, C))
    t = [xb, torch.as_tensor(dt), torch.as_tensor(A), Bb, Cb,
         torch.as_tensor(dy), torch.as_tensor(dst)]
    got = split_backward(*t)
    want = _safe_twin64(*(v.float().numpy() for v in t))
    for name, g, w, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                             chip_smoke.ssd_bwd_bounds(*t)):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        e = (g.double() - w).abs()
        limit = 2.0 ** -10 * b + 1e-6
        assert bool((e <= limit).all()), (name, float((e / limit).max()))


def test_overflow_gradients_are_finite_where_the_reference_gives_nan():
    """Reference defect 8: the model-like 128-step chunk of
    ``test_masked_overflow_gives_no_nan``. ``jax.vjp`` of
    ``ref.ssd_chunk_diag`` gives NaN gradients of dt and A (its
    ``where(causal, exp(seg), 0)`` multiplies the where's zero cotangent by
    exp(seg) = inf), finite ones of x, B and C. The port's plain backward
    and autograd through the repaired plain version are finite, within
    5e-5 of each gradient's largest |g| of float64 autograd (float32
    cumsums of dt A reaching -300 move exp(cA_i - cA_k) by some 1e-5
    relative)."""
    x, dt, A, B, C = inputs(2, 128, 8, 16, 32, seed=12, model_like=True)
    dy, dst = cotangents(2, 128, 8, 16, 32, seed=13)
    cA = np.cumsum(dt.astype(np.float64) * A, axis=1)
    assert (cA[:, :1] - cA[:, -1:]).max() > 89.0          # exp(seg) = inf
    jdx, jddt, jdA, jdB, jdC = jax_vjp(x, dt, A, B, C, dy, dst)
    assert np.isnan(jddt).any() and np.isnan(jdA).any()
    assert all(np.isfinite(g).all() for g in (jdx, jdB, jdC))
    want = _safe_twin64(x, dt, A, B, C, dy, dst)
    got = sc.ssd_chunk_backward_plain(
        *(torch.as_tensor(a) for a in (x, dt, A, B, C, dy, dst)))
    grads_close(got, want, frac=5e-5)
    grads_close(autograd_plain(x, dt, A, B, C, dy, dst), want, frac=5e-5)
    # x, B and C's gradients do not pass through the overflow: the
    # reference's agree with the port's there
    grads_close([got[0], got[3], got[4]], [jdx, jdB, jdC])


@pytest.mark.parametrize("model_like", [False, True])
def test_repaired_plain_forward_is_bitwise_the_old_one(model_like):
    """``exp(where(causal, seg, -inf))`` gives the forward of the old
    ``where(causal, exp(seg), 0)``, bitwise (the repair changes only the
    gradient)."""
    x, dt, A, B, C = (torch.as_tensor(a) for a in
                      inputs(2, 128, 8, 16, 32, seed=12,
                             model_like=model_like))
    q = x.shape[1]
    cA = torch.cumsum(dt * A, dim=1)
    seg = cA[:, :, None, :] - cA[:, None, :, :]
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    L = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
    w = (C @ B.transpose(1, 2))[..., None] * L * dt[:, None, :, :]
    y = torch.einsum("gqkh,gkhp->gqhp", w, x)
    st = torch.einsum("gkhp,gkn->ghpn",
                      x * (torch.exp(cA[:, -1:, :] - cA) * dt)[..., None], B)
    got = sc.ssd_chunk_plain(x, dt, A, B, C)
    assert torch.equal(got[0], y) and torch.equal(got[1], st)


def test_types_and_shapes_refused():
    x, dt, A, B, C = (torch.as_tensor(a) for a in inputs(1, 4, 2, 3, 5, 0))
    with pytest.raises(TypeError):                 # x, B, C not alike
        sc.ssd_chunk(x, dt, A, B.bfloat16(), C)
    with pytest.raises(TypeError):
        sc.ssd_chunk(x.double(), dt, A, B.double(), C.double())
    with pytest.raises(TypeError):
        sc.ssd_chunk(x, dt.half(), A, B, C)
    with pytest.raises(ValueError):                # A's heads
        sc.ssd_chunk(x, dt, A[:1], B, C)
    with pytest.raises(ValueError):                # B's length
        sc.ssd_chunk(x, dt, A, B[:, :3], C)
    with pytest.raises(ValueError):
        sc.ssd_chunk(x[0], dt, A, B, C)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sc.ssd_chunk(*(t.to("meta") for t in (x, dt, A, B, C)))


# --------------------------------------------------------------------------
# the Hopper kernel (GPU only)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,ddt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("G,q,H,P,N", [(2, 128, 8, 64, 128),
                                       (3, 40, 5, 8, 16),
                                       (1, 256, 2, 72, 200),
                                       (2, 77, 12, 64, 128),
                                       (3, 40, 9, 64, 40),
                                       (2, 128, 3, 64, 8),
                                       (2, 77, 5, 72, 200)])
def test_kernel_vs_plain_on_gpu(cuda, xdt, ddt, G, q, H, P, N):
    x, dt, A, B, C = inputs(G, q, H, P, N, seed=q, model_like=True)
    t = [torch.as_tensor(a, device=cuda) for a in (x, dt, A, B, C)]
    t = [t[0].to(xdt), t[1].to(ddt), t[2].to(ddt), t[3].to(xdt),
         t[4].to(xdt)]
    before = sc.launches
    got = sc.ssd_chunk(*t)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    # chip_smoke.py phase 8's tolerance: 2^-10 of the sum of the terms'
    # magnitudes (the plain version on |x|, |B|, |C|) plus 1e-6; the
    # kernel's cumsum of dt A (reaching a few hundred) is summed in another
    # order than torch.cumsum, which moves exp(cA_i - cA_k) by ~1e-4
    bounds = sc.ssd_chunk_plain(t[0].abs(), t[1], t[2], t[3].abs(),
                                t[4].abs())
    for g, w, b in zip(got, sc.ssd_chunk_plain(*t), bounds):
        assert bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= 2.0 ** -10 * b + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,q,P,N,want", [
    (torch.bfloat16, 128, 64, 128, "wgmma"),     # mamba2's prefill
    (torch.bfloat16, 77, 64, 40, "wgmma"),       # ragged q, N of 40
    (torch.bfloat16, 256, 64, 128, "fma"),       # q past 128
    (torch.bfloat16, 77, 72, 200, "fma"),        # P and N it does not take
    (torch.float32, 128, 64, 128, "fma")])       # f32 inputs
def test_route_on_gpu(cuda, xdt, q, P, N, want):
    t = [torch.as_tensor(a, device=cuda)
         for a in inputs(1, q, 2, P, N, seed=5)]
    t = [t[0].to(xdt), t[1], t[2], t[3].to(xdt), t[4].to(xdt)]
    assert sc.route(*t) == want


def test_route_on_the_cpu_is_the_plain_version():
    t = [torch.as_tensor(a) for a in inputs(1, 8, 2, 64, 16, seed=5)]
    assert sc.route(*t) == "plain"


# phase 8b's small cases: (G, q, H, P, N), x/B/C type, dt/A type; bf16
# x/B/C with P = 64, N a multiple of 8 up to 128 and q up to 128 take the
# tensor-core route (the main widths at small G and H, q = 1, 40 and 128, N
# = 8 and 128, dt bf16 and f32, the model-like overflow chunk, a last group
# of one head), the rest the FMA kernels
BACKWARD_GPU_CASES = [(6, 16, 16, 8, 16, torch.bfloat16, torch.float32),
                      (6, 16, 16, 8, 16, torch.float32, torch.float32),
                      (3, 40, 5, 64, 128, torch.bfloat16, torch.float32),
                      (2, 256, 3, 64, 128, torch.bfloat16, torch.bfloat16),
                      (2, 1, 3, 4, 5, torch.float32, torch.bfloat16),
                      (3, 77, 5, 72, 200, torch.float32, torch.float32),
                      (2, 128, 8, 16, 32, torch.float32, torch.float32),
                      (2, 128, 8, 64, 128, torch.bfloat16, torch.float32),
                      (2, 128, 8, 64, 128, torch.bfloat16, torch.bfloat16),
                      (2, 1, 3, 64, 8, torch.bfloat16, torch.float32),
                      (2, 128, 9, 64, 8, torch.bfloat16, torch.bfloat16),
                      (2, 128, 8, 64, 32, torch.bfloat16, torch.float32)]


def _gpu_operands(cuda, G, q, H, P, N, xdt, ddt, seed):
    x, dt, A, B, C = inputs(G, q, H, P, N, seed=seed, model_like=True)
    dy, dst = cotangents(G, q, H, P, N, seed=seed + 1)
    t = [torch.as_tensor(a, device=cuda) for a in (x, dt, A, B, C, dy, dst)]
    return [t[0].to(xdt), t[1].to(ddt), t[2].to(ddt), t[3].to(xdt),
            t[4].to(xdt), t[5], t[6]]


@pytest.mark.gpu
@pytest.mark.parametrize("G,q,H,P,N,xdt,ddt", BACKWARD_GPU_CASES)
def test_backward_kernel_vs_plain_on_gpu(cuda, G, q, H, P, N, xdt, ddt):
    """The backward kernel against ``ssd_chunk_backward_plain`` on the same
    inputs, within phase 8b's limit (2^-10 of each gradient's terms'
    magnitudes plus 1e-6, plus one bf16 rounding where the type is bf16),
    every gradient finite; two calls bitwise equal; one launch a call."""
    t = _gpu_operands(cuda, G, q, H, P, N, xdt, ddt, seed=q)
    before = sc.backward_launches
    got = sc.ssd_chunk_backward(*t)
    again = sc.ssd_chunk_backward(*t)
    torch.cuda.synchronize()
    assert sc.backward_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    chip_smoke.ssd_bwd_close(got, sc.ssd_chunk_backward_plain(*t),
                             chip_smoke.ssd_bwd_bounds(*t), "gpu test")


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,q,P,N,want", [
    (torch.bfloat16, 128, 64, 128, "wgmma"),     # mamba2's training
    (torch.bfloat16, 40, 64, 8, "wgmma"),        # ragged q, N of 8
    (torch.bfloat16, 256, 64, 128, "fma"),       # q past 128
    (torch.bfloat16, 77, 72, 200, "fma"),        # P and N it does not take
    (torch.float32, 128, 64, 128, "fma")])       # f32 inputs
def test_backward_route_on_gpu(cuda, xdt, q, P, N, want):
    """Each input's backward route: the forward's tensor-core domain takes
    wgmma, the rest the FMA kernels."""
    t = _gpu_operands(cuda, 1, q, 2, P, N, xdt, torch.float32, 5)
    assert sc.backward_route(*t[:5]) == want


@pytest.mark.gpu
def test_ssd_chunked_backward_on_gpu_matches_cpu(cuda):
    """``.backward()`` through ``layers.ssd_chunked`` (three chunks from a
    starting state) on the card, where ``SsdChunk`` launches both kernels,
    against the CPU, where autograd runs through the plain version: every
    input's gradient within 1e-4 of its largest |g| (float32 sums in other
    orders through the inter-chunk loop)."""
    from repro_torch.models import layers as tlayers
    x, dt, A, B, C = inputs(2, 48, 3, 4, 8, seed=7, model_like=True)
    rng = np.random.default_rng(8)
    init, wy, ws = (rng.standard_normal(s).astype(np.float32)
                    for s in ((2, 3, 4, 8), (2, 48, 3, 4), (2, 3, 4, 8)))
    grads = {}
    for dev in ("cpu", cuda):
        live = [torch.as_tensor(a, device=dev).requires_grad_()
                for a in (x, dt, A, B, C, init)]
        before = (sc.launches, sc.backward_launches)
        y, st = tlayers.ssd_chunked(*live[:5], 16, init_state=live[5])
        ((y * torch.as_tensor(wy, device=dev)).sum()
         + (st * torch.as_tensor(ws, device=dev)).sum()).backward()
        grads[str(dev)] = [t.grad.cpu() for t in live]
        if dev != "cpu":
            assert (sc.launches, sc.backward_launches) == (
                before[0] + 1, before[1] + 1)
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()))
