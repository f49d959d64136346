"""Parity of the port's last three families with the JAX package: MLA
(deepseek-v2-lite-16b), M-RoPE with the vision-patch frontend (qwen2-vl-7b)
and the audio-frame encoder (hubert-xlarge).

The JAX package's own initialised parameters are carried across with
``repro_torch.models.weights.params_from_numpy``; inputs are made with numpy
(``synthetic_batch`` draws them the same in both packages). Everything runs
at each architecture's smoke config in float32 on the CPU, where the port's
kernels take their plain versions.

Tolerances: float32 activations and logits within 1e-5 absolute plus 1e-5
relative, as ``tests/test_torch_model.py``; batches, tokens, cache offsets
and cache layouts bitwise.
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
from repro.train.data import synthetic_batch as jsynthetic_batch
from repro_torch.configs import get_smoke
from repro_torch.models import Model
from repro_torch.models import layers as tlayers
from repro_torch.models.model import vocab_padded
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve import greedy_generate, make_prefill, make_serve_step
from repro_torch.train import synthetic_batch

from torch_parity import np_of

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
MLA, VL, AUDIO = "deepseek-v2-lite-16b", "qwen2-vl-7b", "hubert-xlarge"
FAMILIES = (MLA, VL, AUDIO)
SHAPE = dict(batch=2, seq=16)


def cfgs(arch, **over):
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


def layer0(tree):
    return {k: v[0] for k, v in tree["blocks"]["pos0"].items()}


def hidden(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)) \
        .astype(np.float32)


def as_torch(batch):
    """A numpy batch as the port's tensors (bool and integer types kept)."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def image_batch(cfg, B, S, T, seed):
    """Tokens, T patches at the first T positions of each row and pos3 with
    distinct t/h/w: t constant, (h, w) on a 2 x (T / 2) grid for the
    patches, then t = h = w = the absolute position for the text."""
    rng = np.random.default_rng(seed)
    pos3 = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    pos3[0, :, :T] = 0
    pos3[1, :, :T] = np.arange(T) // (T // 2)
    pos3[2, :, :T] = np.arange(T) % (T // 2)
    vmask = np.zeros((B, S), bool)
    vmask[:, :T] = True
    return dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                vision_embeds=rng.standard_normal((B, T, cfg.d_model))
                .astype(np.float32),
                vision_mask=vmask, pos3=pos3)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sections", [(2, 3, 3), (2, 1, 0), (4, 3, 3)],
                         ids=str)
def test_apply_mrope_matches_jax(sections):
    # distinct t/h/w; sections summing to hd/2, short of it (the last axis
    # fills the rest) and past it (cut), as the reference's repeat
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos3 = rng.integers(0, 3000, (3, 2, 7)).astype(np.int32)
    got = tlayers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), 1e6,
                              sections)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                               sections)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5,
                               atol=1e-4)   # angles up to 3000 rad in f32
    # t = h = w collapses to RoPE at that position
    same = np.broadcast_to(pos3[0], (3, 2, 7)).copy()
    np.testing.assert_array_equal(
        np_of(tlayers.apply_mrope(torch.as_tensor(x), torch.as_tensor(same),
                                  1e6, sections)),
        np_of(tlayers.apply_rope(torch.as_tensor(x),
                                 torch.as_tensor(pos3[0]), 1e6)))


def test_mla_block_without_cache():
    jcfg, cfg = cfgs(MLA)
    jp, tp = params(jcfg)
    B, S = 2, 9
    x = hidden(B, S, cfg.d_model, seed=1)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    want, _ = jax.jit(lambda x, p, pos: jlayers.mla_block(
        x, p, jcfg, pos))(jnp.asarray(x), layer0(jp), jnp.asarray(pos))
    got, cache = tlayers.mla_block(torch.as_tensor(x), layer0(tp), cfg,
                                   torch.as_tensor(pos))
    assert cache is None
    assert tuple(got.shape) == (B, S, cfg.d_model)
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)


def test_mla_block_with_cache():
    # a first fill of 6, a chunk of 3 at offset 6, then one token at 9
    jcfg, cfg = cfgs(MLA)
    jp, tp = params(jcfg)
    jl, tl = layer0(jp), layer0(tp)
    B, L, D = 2, 12, cfg.d_model
    jmla = jax.jit(lambda x, p, pos, cache: jlayers.mla_block(
        x, p, jcfg, pos, cache=cache))
    cshape = (B, L, cfg.kv_lora_rank)
    rshape = (B, L, 1, cfg.qk_rope_dim)
    jc = dict(c_kv=jnp.zeros(cshape), k_rope=jnp.zeros(rshape),
              offset=jnp.int32(0))
    tc = dict(c_kv=torch.zeros(cshape), k_rope=torch.zeros(rshape), offset=0)
    off = 0
    for i, S in enumerate((6, 3, 1)):
        x = hidden(B, S, D, seed=10 + i)
        pos = np.tile(np.arange(off, off + S, dtype=np.int32), (B, 1))
        want, jc = jmla(jnp.asarray(x), jl, jnp.asarray(pos), jc)
        got, tc = tlayers.mla_block(torch.as_tensor(x), tl, cfg,
                                    torch.as_tensor(pos), cache=tc)
        off += S
        np.testing.assert_allclose(np_of(got), np_of(want), **TOL)
        assert tc["offset"] == int(jc["offset"]) == off
        for f in ("c_kv", "k_rope"):
            np.testing.assert_allclose(np_of(tc[f]), np_of(jc[f]), **TOL)
        assert not tc["c_kv"][:, off:].any()


def test_mla_cache_overflow_raises():
    _, cfg = cfgs(MLA)
    _, tp = params(cfgs(MLA)[0])
    tc = dict(c_kv=torch.zeros(1, 4, cfg.kv_lora_rank),
              k_rope=torch.zeros(1, 4, 1, cfg.qk_rope_dim), offset=3)
    with pytest.raises(ValueError, match="do not fit"):
        tlayers.mla_block(torch.zeros(1, 2, cfg.d_model), layer0(tp), cfg,
                          torch.zeros(1, 2, dtype=torch.int32), cache=tc)


def test_embed_scatters_patches_over_ragged_masks():
    # row 0: 3 True positions for 4 patches; row 1: none; row 2: 6 True for
    # 4 patches (the last two take patch 3, the reference's clip); row 3:
    # scattered positions
    jcfg, cfg = cfgs(VL)
    jp, tp = params(jcfg)
    B, S, T = 4, 10, 4
    rng = np.random.default_rng(2)
    vm = np.zeros((B, S), bool)
    vm[0, [1, 4, 8]] = True
    vm[2, 2:8] = True
    vm[3, [0, 3, 9]] = True
    batch = dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 vision_embeds=rng.standard_normal((B, T, cfg.d_model))
                 .astype(np.float32), vision_mask=vm)
    want = JModel(jcfg).embed(jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    got = Model(cfg).embed(tp, as_torch(batch))
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)
    ve = np_of(got)
    np.testing.assert_array_equal(ve[2, 6], ve[2, 5])       # clipped to T-1
    text = Model(cfg).embed(tp, dict(tokens=torch.as_tensor(batch["tokens"])))
    np.testing.assert_array_equal(ve[1], np_of(text)[1])    # no patch


def test_audio_embed_is_the_frame_projection():
    jcfg, cfg = cfgs(AUDIO)
    jp, tp = params(jcfg)
    feats = hidden(2, 5, cfg.d_model, seed=3)
    want = JModel(jcfg).embed(jp, dict(features=jnp.asarray(feats)))
    got = Model(cfg).embed(tp, dict(features=torch.as_tensor(feats)))
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES, ids=str)
def test_params_carry_across(arch):
    jcfg = jget_smoke(arch)
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, seed=0))
    tp = params_from_numpy(tree, device=CPU)
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32 and tuple(node.shape) == a.shape
        np.testing.assert_array_equal(np_of(node), a)
    names = set(tp) | set(tp["blocks"]["pos0"])
    want = {MLA: {"w_dkv", "kv_ln", "w_ukv"}, VL: {"vision_proj"},
            AUDIO: {"frame_proj"}}[arch]
    assert want <= names


# with these, every registry architecture's forward is held against JAX's:
# qwen2-moe in tests/test_torch_model.py, mamba2 and jamba in
# tests/test_torch_mamba.py
DENSE_GQA = ("qwen2-72b", "deepseek-7b", "granite-3-2b", "deepseek-67b")


@pytest.mark.parametrize("arch", FAMILIES + DENSE_GQA, ids=str)
def test_forward_matches_jax(arch):
    # each package's synthetic batch (bitwise the same: the test below);
    # qwen2-vl's pos3 with distinct t/h/w over the patches
    jcfg, cfg = cfgs(arch)
    jp, tp = params(jcfg)
    jb = jsynthetic_batch(jcfg, SHAPE, seed=1)
    tb = synthetic_batch(cfg, SHAPE, seed=1, device=CPU)
    for b in (jb, tb):
        b.pop("labels", None)
        b.pop("targets", None)
    if arch == VL:
        pos3 = image_batch(cfg, 2, 16, 4, 0)["pos3"]
        jb["pos3"], tb["pos3"] = jnp.asarray(pos3), torch.as_tensor(pos3)
    want, jaux, _ = jax.jit(lambda p, b: JModel(jcfg).forward(
        p, b, remat=False))(jp, jb)
    got, aux, caches = Model(cfg)(tp, tb)
    assert caches is None
    assert tuple(got.shape) == (2, 16, vocab_padded(cfg))
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES + ("qwen2-moe-a2.7b",), ids=str)
def test_synthetic_batch_is_bitwise_jax(arch):
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    shape = dict(batch=3, seq=40)
    want = jax.tree.map(np.asarray, jsynthetic_batch(jcfg, shape, seed=5))
    got = synthetic_batch(cfg, shape, seed=5, device=CPU)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), w.view(np.int16), err_msg=k)
        else:
            assert str(g.dtype) == f"torch.{w.dtype.name}", k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("abstract", [False, True], ids=["zeros", "meta"])
def test_init_cache_mla_layout(abstract):
    jcfg, cfg = cfgs(MLA)
    jc = JModel(jcfg).init_cache(3, 11, abstract=True, dtype=jnp.bfloat16)
    tc = Model(cfg).init_cache(3, 11, device=CPU, abstract=abstract,
                               dtype=torch.bfloat16)
    assert set(tc) == set(jc)
    for pos in jc:
        assert set(tc[pos]) == set(jc[pos]) == {"c_kv", "k_rope", "offset"}
        for f, spec in jc[pos].items():
            t = tc[pos][f]
            assert tuple(t.shape) == spec.shape, f
            assert str(t.dtype).split(".")[-1] == spec.dtype.name, f
            assert t.device.type == ("meta" if abstract else "cpu"), f
            if not abstract:
                assert not t.any()
    # the default type is the compute type
    dflt = Model(cfg).init_cache(1, 2, device=CPU)["pos0"]
    assert dflt["c_kv"].dtype == dflt["k_rope"].dtype == torch.float32
    # abstract needs no device (the default would ask for the GPU)
    Model(get_smoke(VL)).init_cache(1, 2, abstract=True)


def test_cast_early_matches_jax():
    # bfloat16 parameters, float32 compute: cast_early casts them before the
    # layer loop, the _KEEP_F32 leaves excepted (they keep their own type)
    jcfg, cfg = cfgs(MLA, param_dtype="bfloat16")
    jp, tp = params(jcfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 8)) \
        .astype(np.int32)
    want, _, _ = jax.jit(lambda p, t: JModel(jcfg, cast_early=True).forward(
        p, dict(tokens=t), remat=False))(jp, jnp.asarray(toks))
    model = Model(cfg, cast_early=True)
    cast = model._cast_early(tp)
    assert tp["embed"].dtype == torch.bfloat16
    assert cast["embed"].dtype == cast["lm_head"].dtype == torch.float32
    blk = cast["blocks"]["pos0"]
    assert blk["kv_ln"].dtype == blk["ln1"].dtype == torch.bfloat16
    assert blk["w_ukv"].dtype == blk["we_g"].dtype == torch.float32
    got, _, _ = model(tp, dict(tokens=torch.as_tensor(toks)))
    late, _, _ = Model(cfg)(tp, dict(tokens=torch.as_tensor(toks)))
    np.testing.assert_array_equal(np_of(got), np_of(late))
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_image_prefill_then_text_decode_matches_jax():
    jcfg, cfg = cfgs(VL)
    jp, tp = params(jcfg)
    B, S, T, max_len, steps = 2, 12, 4, 16, 3
    batch = image_batch(cfg, B, S, T, seed=6)
    jm, tm = JModel(jcfg), Model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["offset"] = jnp.zeros(B, jnp.int32)
    want, _, jc = jax.jit(lambda p, b, c: jm.forward(
        p, b, caches=c, remat=False))(jp, jb, jm.init_cache(B, max_len))
    tb = as_torch(batch)
    tb["offset"] = torch.zeros(B, dtype=torch.int32)
    got, _, tc = tm(tp, tb, caches=tm.init_cache(B, max_len, device=CPU))
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)
    jstep, tstep = jax.jit(jmake_serve_step(jm)), make_serve_step(tm)
    tok = np.asarray(np_of(got)[:, -1].argmax(-1), np.int32)[:, None]
    for t in range(steps):
        lw, jc = jstep(jp, jc, jnp.asarray(tok), jnp.full((B,), S + t,
                                                           jnp.int32))
        lg, tc = tstep(tp, tc, torch.as_tensor(tok),
                       torch.full((B,), S + t, dtype=torch.int32))
        np.testing.assert_allclose(np_of(lg), np_of(lw), **TOL)
        tok = np.asarray(np_of(lw).argmax(-1), np.int32)[:, None]
    for pos in jc:
        assert np_of(tc[pos]["offset"]).tolist() == \
            np_of(jc[pos]["offset"]).tolist() == [S + steps] * len(
                tc[pos]["offset"])
        for f in ("k", "v"):
            np.testing.assert_allclose(np_of(tc[pos][f]), np_of(jc[pos][f]),
                                       **TOL)


def test_deepseek_greedy_generate_matches_jax():
    jcfg, cfg = cfgs(MLA)
    jp, tp = params(jcfg)
    B, S, T, max_len = 2, 10, 6, 17
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    want = np_of(jgreedy(JModel(jcfg), jp, jnp.asarray(prompt), max_len, T))
    got = np_of(greedy_generate(Model(cfg), tp, prompt, max_len, T,
                                device=CPU))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", [MLA, VL], ids=str)
def test_prefill_into_a_cache_of_another_type(arch):
    # float32 compute over a bfloat16 cache (init_cache(dtype=...)): GQA's
    # q and k then differ in type, so the first fill attends as the
    # reference does (_decode_attention) and not on the flash kernel; MLA
    # up-projects the bf16 latent in float32, as JAX promotes it. Within
    # bf16's rounding: a cached entry may round to the other neighbour
    jcfg, cfg = cfgs(arch)
    jp, tp = params(jcfg)
    B, S, L = 2, 8, 10
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    jm, tm = JModel(jcfg), Model(cfg)
    want, jc = jax.jit(jmake_prefill(jm))(
        jp, jm.init_cache(B, L, dtype=jnp.bfloat16), jnp.asarray(toks))
    got, tc = make_prefill(tm)(
        tp, tm.init_cache(B, L, device=CPU, dtype=torch.bfloat16),
        torch.as_tensor(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=2 ** -7,
                               atol=2 ** -7)
    for pos in jc:
        for f, t in tc[pos].items():
            if f != "offset":
                assert t.dtype == torch.bfloat16
                np.testing.assert_allclose(np_of(t.float()), np.asarray(
                    jc[pos][f], np.float32), rtol=2 ** -7, atol=2 ** -7)
