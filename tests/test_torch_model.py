"""Parity of the port's LM stack: layers, model, weights and serving.

The JAX package's own initialised parameters are carried across with
``repro_torch.models.weights.params_from_numpy``, so both packages compute
with the same numbers; inputs are made with numpy. Everything runs at
``get_smoke("qwen2-moe-a2.7b").scaled(dtype="float32")`` (2 layers, d_model
64, 8 routed experts padded to 16, top-2, 2 shared) on the CPU, where the
port's kernels take their plain versions.

Tolerances: float32 activations and logits within 1e-5 absolute plus 1e-5
relative (another summation order and another cos/sin over a few hundred
terms; the logits are of order 0.1); indices, tokens, cache offsets and the
router's choices bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import Model as JModel
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.config import active_param_count as jactive
from repro.models.config import param_count as jparam_count
from repro.serve import greedy_generate as jgreedy
from repro.serve import make_prefill as jmake_prefill
from repro.serve import make_serve_step as jmake_serve_step
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models import Model, init_params
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.config import active_param_count, param_count
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve import greedy_generate, make_prefill, make_serve_step

from torch_parity import np_of

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen2-moe-a2.7b"
CPU = torch.device("cpu")


def cfgs(**over):
    over.setdefault("dtype", "float32")
    return jget_smoke(ARCH).scaled(**over), get_smoke(ARCH).scaled(**over)


_PARAMS = {}


def params(jcfg):
    """The JAX package's params for ``jcfg`` and their carry to the port."""
    if jcfg not in _PARAMS:
        jp = jinit_params(jcfg, seed=0)
        _PARAMS[jcfg] = jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                              device=CPU)
    return _PARAMS[jcfg]


def layer0(tree):
    """Layer 0's parameters of a stacked tree."""
    return {k: v[0] for k, v in tree["blocks"]["pos0"].items()}


def hidden(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)) \
        .astype(np.float32)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tlayers.rmsnorm(torch.as_tensor(x), torch.as_tensor(w), 1e-6)),
        np_of(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        np_of(tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                                 1e6)),
        np_of(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-4)       # angles up to 3000 rad in float32


def test_gqa_block_with_and_without_cache():
    jcfg, cfg = cfgs()
    jp, tp = params(jcfg)
    jl, tl = layer0(jp), layer0(tp)
    B, S, D = 2, 6, cfg.d_model
    x = hidden(B, S, D, seed=1)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jgqa = jax.jit(lambda x, p, pos, cache: jlayers.gqa_block(
        x, p, jcfg, pos, cache=cache))
    want, _ = jgqa(jnp.asarray(x), jl, jnp.asarray(pos), None)
    got, _ = tlayers.gqa_block(torch.as_tensor(x), tl, cfg,
                               torch.as_tensor(pos))
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)
    # with a cache: a first fill of S, then one token at offset S
    shape = (B, 9, cfg.n_kv_heads, cfg.hd)
    jc = dict(k=jnp.zeros(shape), v=jnp.zeros(shape), offset=jnp.int32(0))
    tc = dict(k=torch.zeros(shape), v=torch.zeros(shape), offset=0)
    x1 = hidden(B, 1, D, seed=2)
    pos1 = np.full((B, 1), S, np.int32)
    for xs, ps in ((x, pos), (x1, pos1)):
        want, jc = jgqa(jnp.asarray(xs), jl, jnp.asarray(ps), jc)
        got, tc = tlayers.gqa_block(torch.as_tensor(xs), tl, cfg,
                                    torch.as_tensor(ps), cache=tc)
        np.testing.assert_allclose(np_of(got), np_of(want), **TOL)
        assert tc["offset"] == int(jc["offset"])
        for f in ("k", "v"):
            np.testing.assert_allclose(np_of(tc[f]), np_of(jc[f]), **TOL)


def moe_pair(jcfg, cfg, x, jl, tl):
    jy, jaux = jax.jit(lambda x, p: jlayers.moe_block(x, p, jcfg))(
        jnp.asarray(x), jl)
    ty, taux = tlayers.moe_block(torch.as_tensor(x), tl, cfg)
    return (np_of(ty), float(taux)), (np_of(jy), float(jaux))


def test_moe_block():
    jcfg, cfg = cfgs()
    jp, tp = params(jcfg)
    x = hidden(2, 16, cfg.d_model, seed=3)
    (got, aux), (want, jaux) = moe_pair(jcfg, cfg, x, layer0(jp), layer0(tp))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


def test_router_ties_pick_the_lowest_experts_first():
    # an all-zero router: every real expert ties (the padding experts sit at
    # -1e30), so top-k must be experts 0..K-1 in that order, as lax.top_k
    jcfg, cfg = cfgs()
    jp, tp = params(jcfg)
    E, K = tp["blocks"]["pos0"]["router"].shape[-1], cfg.top_k
    probs = np.zeros((5, E), np.float32)
    probs[:, :cfg.n_experts] = 1.0 / cfg.n_experts
    jv, ji = jax.lax.top_k(jnp.asarray(probs), K)
    tv, ti = tlayers.router_top_k(torch.as_tensor(probs), K)
    np.testing.assert_array_equal(np_of(ji), np.tile(np.arange(K), (5, 1)))
    np.testing.assert_array_equal(np_of(ti), np_of(ji))
    np.testing.assert_array_equal(np_of(tv), np_of(jv))
    jl, tl = layer0(jp), layer0(tp)
    jl["router"] = jnp.zeros_like(jl["router"])
    tl["router"] = torch.zeros_like(tl["router"])
    x = hidden(2, 8, cfg.d_model, seed=4)
    (got, aux), (want, jaux) = moe_pair(jcfg, cfg, x, jl, tl)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


def test_capacity_overflow_drops_the_same_tokens():
    # capacity_factor 0.5: C = 8 slots per expert for 128 tokens x top-2
    # over 8 real experts, so most experts overflow and drop tokens
    jcfg, cfg = cfgs(capacity_factor=0.5)
    jp, tp = params(cfgs()[0])
    jl, tl = layer0(jp), layer0(tp)
    x = hidden(2, 64, cfg.d_model, seed=5)
    xt = x.reshape(-1, cfg.d_model)
    logits = xt @ np_of(tl["router"])
    logits[:, cfg.n_experts:] = -1e30
    top = np.argsort(-logits, axis=1, kind="stable")[:, :cfg.top_k]
    assert np.bincount(top.ravel()).max() > 8          # some expert drops
    (got, aux), (want, jaux) = moe_pair(jcfg, cfg, x, jl, tl)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    # dropped slots really change the output (capacity 8.0 keeps them all)
    (full, _), _ = moe_pair(*cfgs(), x, jl, tl)
    assert not np.allclose(got, full, **TOL)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JARCHS, ids=str)
def test_param_shapes_and_counts_equal_jax(arch):
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jget_smoke(arch), get_smoke(arch))):
        assert tc == tc.validate()
        assert tmodel.param_shapes(tc) == jmodel.param_shapes(jc)
        assert param_count(tc) == jparam_count(jc)
        assert active_param_count(tc) == jactive(jc)
        assert tmodel.period_of(tc) == jmodel.period_of(jc)
        assert tmodel.vocab_padded(tc) == jmodel.vocab_padded(jc)
        assert tmodel.experts_padded(tc) == jmodel.experts_padded(jc)
    assert ARCHS == JARCHS


def test_init_params_shapes_dtypes_and_distributions():
    cfg = get_smoke(ARCH)
    p = init_params(cfg, seed=0, device=CPU)
    shapes = tmodel.param_shapes(cfg)
    flat = lambda t, pre="": {f"{pre}{k}": v for kk, vv in t.items()
                              for k, v in (flat(vv, f"{kk}/").items()
                                           if isinstance(vv, dict)
                                           else [(kk, vv)])}
    got, want = flat(p), flat(shapes)
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.float32 for v in got.values())
    blk = p["blocks"]["pos0"]
    assert torch.equal(blk["ln1"], torch.ones_like(blk["ln1"]))
    D = cfg.d_model
    assert abs(float(blk["we_g"].std()) - D ** -0.5) < 0.1 * D ** -0.5
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    # deterministic in (seed, path); layers of a stack differ
    again = init_params(cfg, seed=0, device=CPU, dtype=torch.bfloat16)
    assert again["embed"].dtype == torch.bfloat16
    torch.testing.assert_close(again["embed"].float(), p["embed"],
                               rtol=2 ** -8, atol=0)
    assert not torch.equal(blk["wq"][0], blk["wq"][1])
    assert not torch.equal(init_params(cfg, seed=1, device=CPU)["embed"],
                           p["embed"])


def test_params_from_numpy_round_trip():
    jcfg = jget_smoke(ARCH).scaled(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, seed=0))
    tp = params_from_numpy(tree, device=CPU)
    back = jax.tree.map(np.asarray, jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), tp,
        is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def test_forward_matches_jax():
    jcfg, cfg = cfgs()
    jp, tp = params(jcfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 16)) \
        .astype(np.int32)
    jl, jaux, _ = jax.jit(lambda p, t: JModel(jcfg).forward(
        p, dict(tokens=t), remat=False))(jp, jnp.asarray(toks))
    tl, taux, caches = Model(cfg)(tp, dict(tokens=torch.as_tensor(toks)))
    assert caches is None
    assert tuple(tl.shape) == (2, 16, tmodel.vocab_padded(cfg))
    np.testing.assert_allclose(np_of(tl), np_of(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_pos3_without_mrope_sections_is_ignored_as_in_jax():
    # qwen2-moe has no M-RoPE sections: the reference applies plain RoPE at
    # pos and ignores pos3, so the logits equal those without pos3
    jcfg, cfg = cfgs()
    assert cfg.mrope_sections is None
    jp, tp = params(jcfg)
    toks = np.random.default_rng(16).integers(0, cfg.vocab, (1, 8)) \
        .astype(np.int32)
    pos3 = np.broadcast_to(np.arange(8, dtype=np.int32), (3, 1, 8)).copy()
    jl, _, _ = JModel(jcfg).forward(
        jp, dict(tokens=jnp.asarray(toks), pos3=jnp.asarray(pos3)),
        remat=False)
    tl, _, _ = Model(cfg)(tp, dict(tokens=torch.as_tensor(toks),
                                   pos3=torch.as_tensor(pos3)))
    plain, _, _ = Model(cfg)(tp, dict(tokens=torch.as_tensor(toks)))
    np.testing.assert_allclose(np_of(tl), np_of(jl), **TOL)
    np.testing.assert_array_equal(np_of(tl), np_of(plain))


def test_pos3_with_mrope_sections_raises():
    # the name is kept from the slice that refused M-RoPE: qwen2-vl with a
    # pos3 of distinct t/h/w now runs M-RoPE, as the reference does (its
    # logits against JAX's: tests/test_torch_families.py), and differs
    # from the same tokens without pos3 (plain RoPE at pos)
    cfg = get_smoke("qwen2-vl-7b").scaled(dtype="float32")
    assert cfg.mrope_sections is not None
    p = init_params(cfg, seed=0, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(17).integers(
        0, cfg.vocab, (1, 6)), dtype=torch.int32)
    pos3 = torch.stack([torch.zeros(6, dtype=torch.int32),
                        torch.arange(6, dtype=torch.int32) // 3,
                        torch.arange(6, dtype=torch.int32) % 3])[:, None]
    mrope, _, _ = Model(cfg)(p, dict(tokens=toks, pos3=pos3))
    plain, _, _ = Model(cfg)(p, dict(tokens=toks))
    assert torch.isfinite(mrope).all()
    assert not torch.allclose(mrope, plain, **TOL)
    # t = h = w = pos collapses M-RoPE to RoPE
    same, _, _ = Model(cfg)(p, dict(tokens=toks, pos3=torch.arange(
        6, dtype=torch.int32).expand(3, 1, 6)))
    torch.testing.assert_close(same, plain, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "hubert-xlarge"],
                         ids=str)
def test_unported_families_raise(arch):
    # the name is kept from the slice that refused MLA and the audio
    # frontend: both construct now, and their forward matches JAX's
    # (tests/test_torch_families.py); expert-parallel MoE, the last stub it
    # pinned, is held against JAX in tests/test_torch_moe_ep.py
    cfg = get_smoke(arch).scaled(dtype="float32")
    model = Model(cfg)
    p = init_params(cfg, seed=0, device=CPU)
    batch = dict(features=torch.randn(1, 5, cfg.d_model)) \
        if cfg.frontend == "audio_frames" else \
        dict(tokens=torch.zeros((1, 5), dtype=torch.int32))
    logits, _, _ = model(p, batch)
    assert tuple(logits.shape) == (1, 5, tmodel.vocab_padded(cfg))
    assert torch.isfinite(logits).all()


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_cached_prefill_matches_jax():
    jcfg, cfg = cfgs()
    jp, tp = params(jcfg)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)) \
        .astype(np.int32)
    jm, tm = JModel(jcfg), Model(cfg)
    want, jc = jax.jit(jmake_prefill(jm))(jp, jm.init_cache(2, 20),
                                          jnp.asarray(prompt))
    got, tc = make_prefill(tm)(tp, tm.init_cache(2, 20, device=CPU),
                               torch.as_tensor(prompt))
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)
    assert set(tc) == set(jc)
    for pos in jc:
        np.testing.assert_array_equal(np_of(tc[pos]["offset"]),
                                      np_of(jc[pos]["offset"]))
        for f in ("k", "v"):
            assert tuple(tc[pos][f].shape) == jc[pos][f].shape
            np.testing.assert_allclose(np_of(tc[pos][f]), np_of(jc[pos][f]),
                                       **TOL)


def test_greedy_generate_matches_jax():
    jcfg, cfg = cfgs()
    jp, tp = params(jcfg)
    B, S, T, max_len = 2, 10, 6, 17
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (B, S)) \
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
    assert len(logits) == T
    for t in range(T):
        if t:
            lg, caches = step(jp, caches, jnp.asarray(want_tok[:, t - 1:t]),
                              jnp.full((B,), S + t - 1, jnp.int32))
        np.testing.assert_allclose(np_of(logits[t]), np_of(lg), **TOL)


PORTED_DECODERS = [a for a in ARCHS if get_smoke(a).kind == "decoder"]


@pytest.mark.parametrize("arch", PORTED_DECODERS, ids=str)
def test_decode_matches_forward(arch):
    """The port's mirror of ``tests/test_smoke_archs.py``'s test of the same
    name: prefill of half the tokens, then one-token decode steps, agree with
    the teacher-forced forward (float32, so the check is algorithmic)."""
    cfg = get_smoke(arch).scaled(dtype="float32")
    model = Model(cfg)
    p = init_params(cfg, seed=0, device=CPU)
    B, S = 2, 16
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)), dtype=torch.int32)
    with torch.inference_mode():
        full, _, _ = model(p, dict(tokens=toks))
        half = S // 2
        caches = model.init_cache(B, S, device=CPU)
        lg, caches = make_prefill(model)(p, caches, toks[:, :half])
        torch.testing.assert_close(lg, full[:, half - 1], rtol=2e-5,
                                   atol=2e-5)
        step = make_serve_step(model)
        for t in range(half, S):
            lg, caches = step(p, caches, toks[:, t:t + 1],
                              torch.full((B,), t, dtype=torch.int32))
            torch.testing.assert_close(lg, full[:, t], rtol=2e-5, atol=2e-5)


def test_padded_vocab_ids_are_reachable_as_in_jax():
    """Reference defect 3 (ROADMAP §4): the lm_head's padding rows are
    random and greedy argmax runs over all vocab_padded logits, so an id >=
    vocab can be emitted. The port keeps that for parity: with the real rows
    zeroed, the random padding rows decide, and both packages emit the same
    padding ids."""
    jcfg, cfg = cfgs(vocab=500)              # padded to 512
    jp, tp = params(jcfg)
    V = cfg.vocab
    jp = dict(jp, lm_head=jp["lm_head"].at[:V].set(0.0))
    tp = dict(tp, lm_head=tp["lm_head"].clone())
    tp["lm_head"][:V] = 0.0
    prompt = np.random.default_rng(9).integers(0, V, (2, 4)) \
        .astype(np.int32)
    want = np_of(jgreedy(JModel(jcfg), jp, jnp.asarray(prompt), 7, 2))
    got = np_of(greedy_generate(Model(cfg), tp, prompt, 7, 2, device=CPU))
    np.testing.assert_array_equal(got, want)
    assert (got >= V).all()


def test_serve_launcher_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                       "--prompt-len", "8", "--tokens", "3", "--device",
                       "cpu"])
    assert tuple(out.shape) == (2, 3)
    assert int(out.max()) < tmodel.vocab_padded(get_smoke(ARCH))
    assert "qwen2-moe-a2.7b on cpu" in capsys.readouterr().out
    # MLA serves now (its tokens against JAX's: tests/test_torch_families.py)
    out = tserve.main(["--arch", "deepseek-v2-lite-16b", "--smoke",
                       "--batch", "2", "--prompt-len", "6", "--tokens", "2",
                       "--device", "cpu"])
    assert tuple(out.shape) == (2, 2)
    assert "deepseek-v2-lite-16b on cpu" in capsys.readouterr().out
    # an encoder has no decode
    with pytest.raises(ValueError, match="encoder"):
        tserve.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                     "cpu"])


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default resolves to it")
    cfg = get_smoke(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greedy_generate(Model(cfg), None, np.zeros((1, 2), np.int32), 4, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", ARCH, "--smoke"])
