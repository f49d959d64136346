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
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd
from repro_torch.kernels import ssd_chunk as sc

from torch_parity import np_of

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
