"""Parity of the port's Mamba2 mixer, the mamba2 and hybrid models and
their serving path.

The JAX package's own initialised parameters are carried across with
``repro_torch.models.weights.params_from_numpy``; inputs are made with
numpy. Everything runs on the CPU, where ``ssd_chunk`` takes its plain
version, at ``get_smoke("mamba2-2.7b")`` (2 layers, d_model 64, d_inner
128, 16 heads x 8, state 16, chunk 16) and ``get_smoke("jamba-1.5-large-
398b")`` (8 layers: 7 mamba, 1 attention, MoE every second layer).

Tolerances:
- float32: 1e-5 absolute plus 1e-5 relative, also for the port's chunked
  cached prefill against JAX's per-token scan (another summation order of
  the same float32 recurrence; states and outputs reach about 5, and the
  two routes part by about 2e-6);
- bfloat16 compute: types and shapes exactly, values within 2^-4 absolute
  plus 2^-4 relative. JAX rounds every step to bf16 (with bf16 parameters
  even the cumsum of dt A and the decay), and rounds ``C . B`` to bf16
  where the port's kernel keeps it in float32 as the Pallas kernel does;
  the port computes the scan in float32 and rounds once. On outputs up to
  about 6 the two part by up to 0.042, a few bf16 ulps grown through the
  scan and the gating.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jget_smoke
from repro.models import Model as JModel
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.serve import greedy_generate as jgreedy
from repro.serve import make_prefill as jmake_prefill
from repro.serve import make_serve_step as jmake_serve_step
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models import Model, init_params
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve import greedy_generate, make_prefill, make_serve_step

from torch_parity import np_of

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -4, atol=2.0 ** -4)
ARCH = "mamba2-2.7b"
HYBRID = "jamba-1.5-large-398b"
CPU = torch.device("cpu")
J2T = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
       jnp.int32: torch.int32}


def cfgs(arch=ARCH, **over):
    over.setdefault("dtype", "float32")
    return jget_smoke(arch).scaled(**over), get_smoke(arch).scaled(**over)


_PARAMS = {}


def params(jcfg):
    """The JAX package's params for ``jcfg`` and their carry to the port."""
    if jcfg not in _PARAMS:
        jp = jinit_params(jcfg, seed=0)
        _PARAMS[jcfg] = jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                              device=CPU)
    return _PARAMS[jcfg]


def layer0(jcfg, cfg):
    """Layer 0's parameters, cast as each package's ``_layer`` casts them."""
    jp, tp = params(jcfg)
    jl = {k: v[0] for k, v in jp["blocks"]["pos0"].items()}
    tl = {k: v[0] for k, v in tp["blocks"]["pos0"].items()}
    return JModel(jcfg)._cast_params(jl), Model(cfg)._cast_params(tl)


def ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            (rng.random((B, S, H)) * 0.2 + 0.01).astype(np.float32),
            (-rng.random(H) - 0.5).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


def close(got, want, tol=TOL):
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == J2T[want.dtype.type], (got.dtype, want.dtype)
    np.testing.assert_allclose(np_of(got.float()),
                               np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_causal_conv():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    close(tlayers._causal_conv(torch.as_tensor(x), torch.as_tensor(w), 4),
          jlayers._causal_conv(jnp.asarray(x), jnp.asarray(w), 4))


def test_ssd_decode_step():
    x, dt, A, Bm, Cm = ssd_inputs(2, 1, 3, 4, 5, seed=1)
    state = np.random.default_rng(2).standard_normal((2, 3, 4, 5)) \
        .astype(np.float32)
    got = tlayers.ssd_decode_step(*(torch.as_tensor(a) for a in
                                    (x, dt, A, Bm, Cm, state)))
    want = jlayers.ssd_decode_step(*(jnp.asarray(a) for a in
                                     (x, dt, A, Bm, Cm, state)))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_multi_chunk(with_state):
    x, dt, A, Bm, Cm = ssd_inputs(2, 48, 3, 4, 8, seed=3)
    init = np.random.default_rng(4).standard_normal((2, 3, 4, 8)) \
        .astype(np.float32) if with_state else None
    jfn = jax.jit(jlayers.ssd_chunked, static_argnames="chunk")
    want = jfn(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=16,
               init_state=None if init is None else jnp.asarray(init))
    got = tlayers.ssd_chunked(
        *(torch.as_tensor(a) for a in (x, dt, A, Bm, Cm)), 16,
        init_state=None if init is None else torch.as_tensor(init))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_gradients_vs_jax(with_state):
    """Every input's gradient of ``ssd_chunked`` over three chunks (the
    intra-chunk part through ``ssd_chunk``'s plain version, the float32
    inter-chunk loop and ``y_off``), from a starting state or none, against
    ``jax.grad`` of the JAX package's ``ssd_chunked`` for the same random
    weighting of y and the final state; each within 1e-5 of its own largest
    |g| (float32 sums in other orders)."""
    x, dt, A, Bm, Cm = ssd_inputs(2, 48, 3, 4, 8, seed=5)
    rng = np.random.default_rng(6)
    init = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    ws = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    ins = [x, dt, A, Bm, Cm] + ([init] if with_state else [])

    def jloss(*a):
        y, st = jlayers.ssd_chunked(*a[:5], chunk=16,
                                    init_state=a[5] if with_state else None)
        return (y * wy).sum() + (st * ws).sum()

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(ins)))))(
        *(jnp.asarray(a) for a in ins))
    live = [torch.as_tensor(a).requires_grad_() for a in ins]
    y, st = tlayers.ssd_chunked(*live[:5], 16,
                                init_state=live[5] if with_state else None)
    got = torch.autograd.grad((y * torch.as_tensor(wy)).sum()
                              + (st * torch.as_tensor(ws)).sum(), live)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(np_of(g), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def _jmamba(jcfg):
    return jax.jit(lambda x, p, c: jlayers.mamba_block(x, p, jcfg, cache=c))


def test_mamba_block_without_cache():
    jcfg, cfg = cfgs()
    jl, tl = layer0(jcfg, cfg)
    for S in (40, 16, 5):              # three chunks, one, a short prompt
        x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)) \
            .astype(np.float32)
        want, _ = _jmamba(jcfg)(jnp.asarray(x), jl, None)
        got, nc = tlayers.mamba_block(torch.as_tensor(x), tl, cfg)
        assert nc is None
        close(got, want)


def _caches(cfg, B, seed):
    """A nonzero conv history and state, as numpy."""
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((B, cfg.d_conv - 1, cfg.d_inner +
                                2 * cfg.ssm_state)).astype(np.float32)
    state = rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_headdim,
                                 cfg.ssm_state)).astype(np.float32)
    return conv, state


@pytest.mark.parametrize("S", [37, 1])
def test_mamba_block_with_cache(S):
    # S = 37: the port's chunked prefill (three chunks of 16, the last one
    # padded) from a nonzero state, against JAX's per-token scan; S = 1:
    # one decode step on both sides
    jcfg, cfg = cfgs()
    jl, tl = layer0(jcfg, cfg)
    x = np.random.default_rng(5).standard_normal((2, S, cfg.d_model)) \
        .astype(np.float32)
    conv, state = _caches(cfg, 2, seed=6)
    want, jc = _jmamba(jcfg)(jnp.asarray(x), jl,
                             dict(conv=jnp.asarray(conv),
                                  state=jnp.asarray(state)))
    tc = dict(conv=torch.as_tensor(conv).clone(),
              state=torch.as_tensor(state).clone())
    got, nc = tlayers.mamba_block(torch.as_tensor(x), tl, cfg, cache=tc)
    close(got, want)
    assert nc["conv"] is tc["conv"] and nc["state"] is tc["state"]
    close(tc["conv"], jc["conv"])
    close(tc["state"], jc["state"])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_mamba_block_types(param_dtype):
    """The reference's result types, bf16 compute: with f32 parameters dt
    and A are f32, so every path returns f32; with bf16 parameters
    (``A_log`` and ``dt_bias`` stored in bf16) the no-cache path runs in
    bf16 and returns bf16, and the cached paths return f32 (the state is)."""
    jcfg, cfg = cfgs(dtype="bfloat16", param_dtype=param_dtype)
    jl, tl = layer0(jcfg, cfg)
    assert tl["A_log"].dtype == J2T[jl["A_log"].dtype.type]
    for S, cached in ((24, False), (24, True), (1, True)):
        x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model))
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.as_tensor(x, dtype=torch.float32).bfloat16()
        jc = tc = None
        if cached:
            conv, state = _caches(cfg, 2, seed=7)
            jc = dict(conv=jnp.asarray(conv, jnp.bfloat16),
                      state=jnp.asarray(state))
            tc = dict(conv=torch.as_tensor(conv).bfloat16(),
                      state=torch.as_tensor(state).clone())
        want, _ = _jmamba(jcfg)(xj, jl, jc)
        got, _ = tlayers.mamba_block(xt, tl, cfg, cache=tc)
        assert bool(torch.isfinite(got.float()).all())
        close(got, want, BF16_TOL)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

def test_params_from_numpy_keeps_the_mamba_leaves():
    # A_log, dt_bias and D_skip keep their stored type through the carry
    # and through _cast_params (_KEEP_F32 skips the activation cast)
    jcfg = jget_smoke(ARCH).scaled(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, seed=0))
    tp = params_from_numpy(tree, device=CPU)
    blk, jblk = tp["blocks"]["pos0"], tree["blocks"]["pos0"]
    assert set(blk) == set(jblk)
    for k in blk:
        assert blk[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(blk[k].view(torch.int16).numpy(),
                                      jblk[k].view(np.int16))
    cast = Model(get_smoke(ARCH).scaled(dtype="float32"))._cast_params(
        {k: v[0] for k, v in blk.items()})
    for k, v in cast.items():
        want = torch.bfloat16 if k in Model._KEEP_F32 else torch.float32
        assert v.dtype == want, k


@pytest.mark.parametrize("arch", [ARCH, HYBRID], ids=str)
def test_forward_and_cache_layout_match_jax(arch):
    jcfg, cfg = cfgs(arch)
    jp, tp = params(jcfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 40)) \
        .astype(np.int32)
    jlg, jaux, _ = jax.jit(lambda p, t: JModel(jcfg).forward(
        p, dict(tokens=t), remat=False))(jp, jnp.asarray(toks))
    tlg, taux, caches = Model(cfg)(tp, dict(tokens=torch.as_tensor(toks)))
    assert caches is None
    assert tuple(tlg.shape) == (2, 40, tmodel.vocab_padded(cfg))
    close(tlg, jlg)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    jc = JModel(jcfg).init_cache(2, 50)
    tc = Model(cfg).init_cache(2, 50, device=CPU)
    assert set(tc) == set(jc)
    for pos in jc:
        assert set(tc[pos]) == set(jc[pos])
        for f in jc[pos]:
            assert tuple(tc[pos][f].shape) == jc[pos][f].shape
            assert tc[pos][f].dtype == J2T[jc[pos][f].dtype.type]


@pytest.mark.parametrize("arch", [ARCH, HYBRID], ids=str)
def test_cached_prefill_matches_jax(arch):
    # JAX's prefill runs each mamba layer's per-token scan; the port's runs
    # ssd_chunked from the cached state
    jcfg, cfg = cfgs(arch)
    jp, tp = params(jcfg)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, (2, 21)) \
        .astype(np.int32)
    jm, tm = JModel(jcfg), Model(cfg)
    want, jc = jax.jit(jmake_prefill(jm))(jp, jm.init_cache(2, 30),
                                          jnp.asarray(prompt))
    got, tc = make_prefill(tm)(tp, tm.init_cache(2, 30, device=CPU),
                               torch.as_tensor(prompt))
    close(got, want)
    for pos in jc:
        for f in jc[pos]:
            if f == "offset":
                np.testing.assert_array_equal(np_of(tc[pos][f]),
                                              np_of(jc[pos][f]))
            else:
                close(tc[pos][f], jc[pos][f])


def test_greedy_generate_matches_jax():
    jcfg, cfg = cfgs()
    jp, tp = params(jcfg)
    B, S, T, max_len = 2, 20, 6, 27
    prompt = np.random.default_rng(10).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    jm = JModel(jcfg)
    want_tok = np_of(jgreedy(jm, jp, jnp.asarray(prompt), max_len, T))
    logits = []
    got_tok = np_of(greedy_generate(Model(cfg), tp, prompt, max_len, T,
                                    device=CPU, on_logits=logits.append))
    np.testing.assert_array_equal(got_tok, want_tok)
    # JAX's logits along the same tokens (its greedy loop, step by step)
    lg, caches = jax.jit(jmake_prefill(jm))(jp, jm.init_cache(B, max_len),
                                            jnp.asarray(prompt))
    step = jax.jit(jmake_serve_step(jm))
    for t in range(T):
        if t:
            lg, caches = step(jp, caches, jnp.asarray(want_tok[:, t - 1:t]),
                              jnp.full((B,), S + t - 1, jnp.int32))
        close(logits[t], lg)


@pytest.mark.parametrize("arch", [ARCH, HYBRID], ids=str)
def test_decode_matches_forward(arch):
    """Prefill of half the tokens (three chunks with mamba2's smoke chunk of
    16, the last padded), then one-token decode steps, agree with the
    teacher-forced forward (float32, so the check is algorithmic)."""
    cfg = get_smoke(arch).scaled(dtype="float32")
    model = Model(cfg)
    p = init_params(cfg, seed=0, device=CPU)
    B, S = 2, 80
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)), dtype=torch.int32)
    with torch.inference_mode():
        full, _, _ = model(p, dict(tokens=toks))
        half = 40
        caches = model.init_cache(B, S, device=CPU)
        lg, caches = make_prefill(model)(p, caches, toks[:, :half])
        torch.testing.assert_close(lg, full[:, half - 1], **TOL)
        step = make_serve_step(model)
        for t in range(half, half + 4):
            lg, caches = step(p, caches, toks[:, t:t + 1],
                              torch.full((B,), t, dtype=torch.int32))
            torch.testing.assert_close(lg, full[:, t], **TOL)


def test_serve_launcher_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                       "--prompt-len", "20", "--tokens", "3", "--device",
                       "cpu"])
    assert tuple(out.shape) == (2, 3)
    assert int(out.max()) < tmodel.vocab_padded(get_smoke(ARCH))
    assert "mamba2-2.7b on cpu" in capsys.readouterr().out
