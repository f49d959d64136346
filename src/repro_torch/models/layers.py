"""Model layers: norms, RoPE and M-RoPE, GQA and MLA attention, MLP, MoE and
the Mamba2 mixer (port of ``repro/models/layers.py``).

Functions over explicit parameter dictionaries, in the reference's layout
(``x @ w``, ``wq`` is (D, H * hd)). Attention without a cache (GQA's and
MLA's) runs on the ``flash_attention`` kernel, the routed experts on the
``bsr_spmm`` kernel and the SSD scan's intra-chunk part on the ``ssd_chunk``
kernel (each wrapper takes its plain version for CPU tensors); the rest is
torch ops, as it is plain XLA in JAX. On the card a call that needs a
gradient goes through the kernels' autograd Functions, whose backwards are
kernels too (``flash_attention``, ``bsr_spmm`` and ``ssd_chunk``), so every
family trains on the card.

MoE dispatch is the reference's sort-based, capacity-bounded bucketing: the
router's top-k choices form a block-sparse tokens -> (expert, slot) matrix,
and the expert FFNs are a block-diagonal SpMM (``bsr_spmm``).

JAX promotes mixed float types silently and torch's products refuse them,
so the Mamba2 mixer writes each cast out (``_mm``, ``_promoted``) and
returns the type the reference returns for the same input types.

Expert-parallel MoE (``moe_block_ep``) runs one data shard's tokens on one
rank of a ``ShardingPlan``'s mesh: the rank's experts on ``bsr_spmm``, the
experts' contributions summed over the model axis with ``core/comm.py``'s
gather-then-sum, then combined as ``moe_block`` combines them.
``constrain`` is the reference's sharding constraint for a DTensor
activation (``dist/shardings.py``), and passes a plain tensor through.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..core import comm
from ..dist import shardings as _sh
from ..kernels import bsr_spmm as _bsr
from ..kernels import flash_attention as _flash
from ..kernels import refuse_grad
from ..kernels import ssd_chunk as _ssd
from .config import ModelConfig


def constrain(x, spec):
    """``jax.lax.with_sharding_constraint``: a DTensor redistributed to
    ``spec``'s placements on its mesh (``dist.shardings.redistribute``); a
    plain tensor, or a None spec, as it is (the reference returns x outside
    a mesh)."""
    if spec is None:
        return x
    return _sh.redistribute(x, spec)


# --------------------------------------------------------------------------
# norms / rope
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    nrm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (nrm * w.float()).to(x.dtype)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x (B, S, H, hd) by ang (B, S, hd/2), in
    float32, rounded to x's type."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); pos: (B, S) integer. Half-split rotation, float32
    angles."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (hd/2,)
    return _rotate(x, pos[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE. x: (B, S, H, hd); pos3: (3, B, S), the
    (t, h, w) positions; ``sections`` splits the hd/2 frequency slots among
    the three axes in that order (the first ``sections[0]`` slots turn with
    t, and so on; slots past their sum, if any, with w, as the reference's
    ``jnp.repeat(..., total_repeat_length=hd // 2)`` fills them)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (hd/2,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(tuple(sections), device=x.device))
    sec_id = F.pad(sec_id, (0, max(half - sec_id.numel(), 0)),
                   value=2)[:half]                            # (hd/2,)
    axis_pos = pos3.float()[sec_id]                          # (hd/2, B, S)
    return _rotate(x, axis_pos.permute(1, 2, 0) * freqs)


# --------------------------------------------------------------------------
# attention (GQA)
# --------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """q: (B, S, H, hd), k/v: (B, Skv, KVH, hd) -> (B, S, H, hd).

    The ``flash_attention`` kernel for every S (its plain version on the
    CPU): KV heads are read in place for GQA, and the causal mask is aligned
    at the bottom right, as the reference's ``tril(k=Skv - S)``."""
    return _flash.flash_attention(q, k, v, causal=causal)


def gqa_block(x, params, cfg: ModelConfig, pos, *, cache=None,
              pos3=None) -> tuple[torch.Tensor, Any]:
    """GQA attention sublayer. cache: None (no cache) or dict(k, v, offset)
    with ``offset`` a host integer; k and v are written in place. Returns
    (out, new_cache). With a cache the attention is ``_cached_attention``'s.
    """
    B, S, D = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    # as the reference: M-RoPE where the config has sections and the batch
    # has pos3, else plain RoPE at pos (pos3 ignored)
    if cfg.mrope_sections is not None and pos3 is not None:
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    new_cache = None
    if cache is not None:
        off = int(cache["offset"])
        ck, cv = cache["k"], cache["v"]
        _check_room(ck, off, S)
        k = k.to(ck.dtype)
        v = v.to(cv.dtype)
        ck[:, off:off + S] = k
        cv[:, off:off + S] = v
        new_cache = dict(k=ck, v=cv, offset=off + S)
        out = _cached_attention(q, k, v, ck[:, :off + S], cv[:, :off + S],
                                off)
    else:
        out = attention(q, k, v, causal=cfg.causal)
    out = out.reshape(B, S, H * hd) @ params["wo"]
    return out, new_cache


def _check_room(cache_t: torch.Tensor, off: int, S: int) -> None:
    if off + S > cache_t.shape[1]:
        raise ValueError(f"the cache holds {cache_t.shape[1]} positions; "
                         f"{off} + {S} do not fit")


def _cached_attention(q, k, v, k_live, v_live, off: int) -> torch.Tensor:
    """Attention of q (B, S, H, d) at absolute positions off .. off + S - 1
    with a cache: k/v are this chunk's keys and values as the cache holds
    them, k_live/v_live the cache's first off + S positions.

    A first fill (off 0, S > 1) is causal attention over the fresh keys (the
    cache holds nothing older, and the reference's ``_decode_attention``
    masks the positions at or past S), so it runs on the ``flash_attention``
    kernel when q, k and v share a type; a cache of another type, later
    chunks and one-token decode attend with ``_decode_attention``, as the
    reference does."""
    S = q.shape[1]
    if off == 0 and S > 1 and q.dtype == k.dtype == v.dtype:
        return attention(q, k, v, causal=True)
    return _decode_attention(q, k_live, v_live, off + S)


def _decode_attention(q, k, v, valid_len: int) -> torch.Tensor:
    """Query attention over a (possibly padded) cache, causal w.r.t. the
    absolute query positions ``valid_len - S + i``. Query heads are grouped
    by KV head and contracted against the unrepeated cache; scores in
    float32, p in v's type for the PV product, as the reference."""
    B, S, H, hd = q.shape
    kvh = k.shape[2]
    rep = H // kvh
    dv = v.shape[-1]
    qg = q.reshape(B, S, kvh, rep, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / \
        math.sqrt(hd)
    kpos = torch.arange(k.shape[1], device=q.device)
    qpos = valid_len - S + torch.arange(S, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]                    # (S, Skv)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, S, kvh * rep, dv).to(q.dtype)


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------------

def mla_block(x, params, cfg: ModelConfig, pos, *, cache=None):
    """MLA: keys and values come from a kv_lora_rank latent ``c_kv`` and one
    rope key ``k_rope`` shared by the heads, which is all a cache holds
    (kv_lora_rank + qk_rope_dim numbers a token, where GQA's cache of the
    same heads holds 2 H hd).

    cache: None or dict(c_kv (B, L, kv_lora_rank), k_rope (B, L, 1,
    qk_rope_dim), offset) with ``offset`` a host integer; both are written in
    place. Returns (out, new_cache).

    Attention has d = qk_nope_dim + qk_rope_dim and dv = v_head_dim: without
    a cache on the ``flash_attention`` kernel, with one as
    ``_cached_attention`` says. With a cache, k and v are up-projected from
    the off + S live positions only; the reference up-projects all L and
    masks the rest, and the answer is the same. The up-projection and ``wo``
    are plain products, as in the reference.
    """
    B, S, D = x.shape
    H, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ params["wq"]).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    # the compressed kv latent and the shared rope key
    c_kv, k_rope = (x @ params["w_dkv"]).split([cfg.kv_lora_rank, rope],
                                               dim=-1)
    c_kv = rmsnorm(c_kv, params["kv_ln"], cfg.rms_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)
    new_cache = None
    if cache is not None:
        off = int(cache["offset"])
        cc, cr = cache["c_kv"], cache["k_rope"]
        _check_room(cc, off, S)
        cc[:, off:off + S] = c_kv
        cr[:, off:off + S] = k_rope
        new_cache = dict(c_kv=cc, k_rope=cr, offset=off + S)
        c_kv, k_rope = cc[:, :off + S], cr[:, :off + S]
    # up-project keys and values from the latent
    wkv = params["w_ukv"].reshape(cfg.kv_lora_rank, H, nope + cfg.v_head_dim)
    lt = _promoted(c_kv, wkv)            # a cache of another type promotes
    kv = torch.einsum("bsl,lhe->bshe", c_kv.to(lt), wkv.to(lt))
    k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
    kt = _promoted(k_nope, k_rope)       # jnp.concatenate promotes
    k = torch.cat([k_nope.to(kt), k_rope.to(kt).expand(*k_nope.shape[:3],
                                                       rope)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    if cache is not None:
        out = _cached_attention(q, k, v, k, v, off)
    else:
        out = attention(q, k, v, causal=cfg.causal)
    out = out.reshape(B, S, H * cfg.v_head_dim) @ params["wo"]
    return out, new_cache


# --------------------------------------------------------------------------
# MLP / MoE
# --------------------------------------------------------------------------

def mlp_block(x, params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_act == "gelu":            # jax.nn.gelu's default: tanh form
        return F.gelu(x @ params["w1"], approximate="tanh") @ params["w2"]
    return (F.silu(x @ params["wg"]) * (x @ params["w1"])) @ params["w2"]


def _expert_ffn(xe, wg, w1, w2, block_cols) -> torch.Tensor:
    """xe: (E, C, D); w*: (E, D, F)/(E, F, D); block_cols: (E, 1) int32,
    e for an expert with tokens and -1 for one without.

    Each einsum of the reference is one ``bsr_spmm`` over the block-diagonal
    A with R = E block-rows of one (C x D) block each: x is the weight stack
    seen as (E * D, F), and block e multiplies its own D rows. An expert
    with no token is padding: the kernel reads none of its weights, and its
    rows (never gathered back) are zeros."""
    E, C, D = xe.shape
    Fd = wg.shape[-1]
    vals = xe[:, None]                                       # (E, 1, C, D)
    g = _bsr.bsr_spmm(block_cols, vals, wg.reshape(E * D, Fd))
    u = _bsr.bsr_spmm(block_cols, vals, w1.reshape(E * D, Fd))
    h = (F.silu(g) * u).reshape(E, 1, C, Fd)
    return _bsr.bsr_spmm(block_cols, h, w2.reshape(E * Fd, D)).reshape(E, C, D)


def router_top_k(probs: torch.Tensor, k: int):
    """The k largest probabilities of each row and their experts, lowest
    expert first among equal values (``jax.lax.top_k``'s order; bf16
    router logits tie often, and ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _dispatch(xt, router, cfg: ModelConfig):
    """Route T tokens (xt: (T, D)) to their top-k experts and bucket them
    by expert with capacity C (sort-based, the sparse tokens x experts
    matrix). Returns xe (E, C, D) (a slot no token fills is zero), gates
    (E * C,) float32, slot (T * K,) per sorted choice (E * C: dropped),
    keep, order (sorted position -> choice), count (E,) (choices per
    expert, dropped ones too) and the aux load-balancing loss."""
    T, D = xt.shape
    E = router.shape[-1]                # padded to a multiple of 16
    K = cfg.top_k
    dev = xt.device
    logits = (xt @ router).float()                          # (T, E)
    if E > cfg.n_experts:               # padding experts never win
        logits[:, cfg.n_experts:] = -1e30
    probs = torch.softmax(logits, -1)
    gate_vals, gate_idx = router_top_k(probs, K)             # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    C = max(8, min(int(cfg.capacity_factor * T * K / E + 0.999), T))
    flat_e = gate_idx.reshape(-1)                            # (T*K,)
    order = torch.argsort(flat_e, stable=True)               # by expert
    e_sorted = flat_e[order]
    seg = torch.searchsorted(e_sorted, torch.arange(E + 1, device=dev)) \
        .to(torch.int32)
    count = seg[1:] - seg[:-1]
    # aux load-balancing loss (Switch-style)
    me = probs.mean(0)
    ce = count.float() / (T * K)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)
    within = torch.arange(T * K, dtype=torch.int32, device=dev) - \
        e_sorted_start(seg, e_sorted)
    keep = within < C
    slot = torch.where(keep, e_sorted * C + within, E * C)   # E*C: dropped
    tok_of = order // K
    # row E*C of each buffer takes the dropped entries and is cut off
    xe = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=dev)
    xe[slot] = xt[tok_of]
    gates = torch.zeros(E * C + 1, dtype=torch.float32, device=dev)
    gates[slot] = gate_vals.reshape(-1)[order]
    return (xe[:E * C].reshape(E, C, D), gates[:E * C], slot, keep, order,
            count, aux)


def _block_cols(count) -> torch.Tensor:
    """Experts that kept a token (from the bucket counts, no host read):
    the blocked-ELL ids of ``_expert_ffn``, -1 for an empty expert."""
    return torch.where(count > 0, torch.arange(count.numel(),
                                               device=count.device), -1) \
        .to(torch.int32).reshape(-1, 1)


def _contributions(ye_flat, slot, keep) -> torch.Tensor:
    """Each choice's gate * ye[slot] (the transpose SpMM's terms), in sorted
    order, zero where the choice is not kept. ye_flat: (slots, D), already
    scaled by the gates."""
    contrib = ye_flat[slot.clamp(max=ye_flat.shape[0] - 1)]
    return torch.where(keep[:, None], contrib, 0)


def _combine(contrib, order, T: int, K: int) -> torch.Tensor:
    """y[t] = the sum of token t's contributions (sorted order, ``contrib``)
    in contrib's type, added in ascending expert order as the reference's
    scatter-add applies them."""
    rank = torch.empty_like(order)                           # entry -> sorted
    rank[order] = torch.arange(T * K, device=order.device)
    by_expert = torch.sort(rank.reshape(T, K), dim=1).values  # (T, K)
    y = torch.zeros((T, contrib.shape[1]), dtype=contrib.dtype,
                    device=contrib.device)
    for j in range(K):
        y = y + contrib[by_expert[:, j]]
    return y


def moe_block(x, params, cfg: ModelConfig):
    """Top-k MoE with capacity-bounded, sort-based dispatch. Returns
    (out, aux_loss)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    xe, gates, slot, keep, order, count, aux = _dispatch(
        xt, params["router"], cfg)
    E, C, _ = xe.shape
    ye = _expert_ffn(xe, params["we_g"], params["we_1"], params["we_2"],
                     _block_cols(count))
    ye_flat = ye.reshape(E * C, D) * gates.reshape(E * C, 1).to(ye.dtype)
    y = _combine(_contributions(ye_flat, slot, keep), order, T, cfg.top_k)
    if cfg.n_shared_experts:
        y = y + _shared_experts(xt, params).to(y.dtype)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_block_ep(x, params, cfg: ModelConfig, plan):
    """Expert-parallel MoE on one rank of ``plan.mesh`` (the reference's
    ``shard_map`` body, run per rank). Returns (out, aux_loss).

    x: (B_loc, S, D), this rank's data shard's rows (the same on each rank
    of its model group). The rank routes them and buckets them with the
    capacity of its own T = B_loc * S tokens (so the drops are those of the
    plan-less ``moe_block`` over this shard's rows alone) and computes its
    E / model_size experts from ``model_index * E_loc`` on ``bsr_spmm``.
    Its contributions, one row a (token, choice) and zero where another
    rank's expert holds the choice, are summed over the model axis as a
    gather followed by a sum in axis order (each row has one owner, so the
    sum is exact), then combined in each token's ascending expert order as
    ``moe_block`` combines them: every rank of a model group gets the same
    bits, and they are the plan-less ``moe_block``'s on these rows (the
    reference's ``psum`` of each rank's partial sums is the same sum in
    another order). The aux loss is the mean of the shards' over the dp
    axes. ``we_*`` hold all E experts (this rank's are taken) or this
    rank's E_loc; the other leaves are whole.

    Raises ShardingError when E is not divisible by the model axis, and,
    in the words of ``kernels.refuse_grad``, on a call that needs a
    gradient (the sum over the model axis carries none yet).
    """
    B, S, D = x.shape
    m, msize = plan.model_axis, plan.model_size
    E = params["router"].shape[-1]
    K = cfg.top_k
    if E % msize:
        raise _sh.ShardingError(
            f"moe_block_ep: {E} (padded) experts not divisible by the "
            f"expert-parallel axis {m!r} (size {msize})")
    E_loc = E // msize
    refuse_grad("moe_block_ep", "its sum over the model axis is a gather "
                "that carries no gradient yet", x, *params.values())
    mc = comm.mesh_comm(plan.mesh)
    ridx = mc.index(m)
    T = B * S
    xt = x.reshape(T, D)
    xe, gates, slot, keep, order, count, aux = _dispatch(
        xt, params["router"], cfg)
    C = xe.shape[1]
    lo = ridx * E_loc

    def mine(w):                        # this rank's experts of a leaf
        if w.shape[0] == E_loc:
            return w
        if w.shape[0] != E:
            raise _sh.ShardingError(f"moe_block_ep: an expert leaf of "
                                    f"{w.shape[0]} experts, not {E} or "
                                    f"{E_loc}")
        return w[lo:lo + E_loc]

    y_loc = _expert_ffn(xe[lo:lo + E_loc], mine(params["we_g"]),
                        mine(params["we_1"]), mine(params["we_2"]),
                        _block_cols(count[lo:lo + E_loc]))  # (E_loc, C, D)
    g_loc = gates[lo * C:(lo + E_loc) * C]
    ye_flat = y_loc.reshape(E_loc * C, D) * \
        g_loc.reshape(E_loc * C, 1).to(y_loc.dtype)
    # the choices this rank's experts kept, at their local slots
    in_mine = keep & (slot >= lo * C) & (slot < (lo + E_loc) * C)
    contrib = _contributions(ye_flat, torch.where(in_mine, slot - lo * C,
                                                  E_loc * C), in_mine)
    with comm.tagged("expert_sum"):
        contrib = comm.psum(contrib, mc, m)
    y = _combine(contrib, order, T, K)
    for ax in plan.dp_axes:
        aux = comm.psum(aux, mc, ax)
    aux = aux / plan.dp_size
    if cfg.n_shared_experts:
        y = y + _shared_experts(xt, params).to(y.dtype)
    return y.reshape(B, S, D).to(x.dtype), aux


def _shared_experts(xt, params):
    """Sum over shared experts == one dense FFN with F-concatenated weights
    (plain matmuls)."""
    Ns, D, Fd = params["ws_g"].shape
    wsg = params["ws_g"].transpose(0, 1).reshape(D, Ns * Fd)
    ws1 = params["ws_1"].transpose(0, 1).reshape(D, Ns * Fd)
    ws2 = params["ws_2"].reshape(Ns * Fd, D)
    h = F.silu(xt @ wsg) * (xt @ ws1)
    return h @ ws2


def e_sorted_start(seg, e_sorted):
    return seg[e_sorted.clamp(0, seg.shape[0] - 2)]


# --------------------------------------------------------------------------
# Mamba2 (SSD — state space duality, arXiv:2405.21060)
# --------------------------------------------------------------------------

def _promoted(*ts) -> torch.dtype:
    """The type JAX's promotion gives these tensors' types (float types
    only: bf16 with f32 is f32, as in torch)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two, as ``jnp.matmul``."""
    dt = _promoted(a, b)
    return a.to(dt) @ b.to(dt)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan.

    xh: (B, S, H, P) inputs; dt: (B, S, H) >= 0 step sizes; A: (H,) < 0
    decay; Bm, Cm: (B, S, N) (single group); init_state: (B, H, P, N) or
    None. Returns (y (B, S, H, P), final_state (B, H, P, N)).

    The intra-chunk part (``y_diag`` and each chunk's state) is one
    ``ssd_chunk`` call over all (batch * chunk, head) pairs; the inter-chunk
    recurrence (a loop over chunks) and ``y_off`` stay outside, as in the
    reference. Everything is computed in float32, as the kernel computes, and
    both results are cast at the end to the promoted type of the inputs,
    the reference's result type. The reference casts ``init_state`` to that
    type; here its type joins the promotion, so a float32 state stays
    float32 under bfloat16 inputs (no JAX path passes one: the port's cached
    prefill does, where JAX runs a per-token scan with a float32 state).
    """
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    nchunk = S // chunk
    if nchunk * chunk != S:
        raise ValueError(f"S = {S} is not a multiple of chunk = {chunk}")
    out = _promoted(xh, dt, A, Bm, Cm,
                    *(() if init_state is None else (init_state,)))
    G = Bsz * nchunk
    xbc_t = _promoted(xh, Bm, Cm)        # the kernel takes x, B, C alike
    Cc = Cm.to(xbc_t).reshape(G, chunk, N)
    y_diag, states = _ssd.ssd_chunk(
        xh.to(xbc_t).reshape(G, chunk, H, Pd), dt.reshape(G, chunk, H), A,
        Bm.to(xbc_t).reshape(G, chunk, N), Cc)

    # ---- inter-chunk recurrence over the chunk index, in float32 ----
    dA_cum = torch.cumsum(dt.float().reshape(Bsz, nchunk, chunk, H)
                          * A.float(), dim=2)               # (B, c, q, H)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])            # (B, c, H)
    states = states.reshape(Bsz, nchunk, H, Pd, N)
    st = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32,
                     device=xh.device) if init_state is None \
        else init_state.float()
    prev_states = torch.empty_like(states)                  # (B, c, H, P, N)
    for c in range(nchunk):
        prev_states[:, c] = st
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]

    # ---- off-diagonal part: y += C . exp(dA_cum) . prev_state ----
    in_decay = torch.exp(dA_cum)                            # (B, c, q, H)
    y_off = torch.einsum("bcqn,bchpn->bcqhp",
                         Cc.float().reshape(Bsz, nchunk, chunk, N),
                         prev_states) * in_decay[..., None]
    y = y_diag.reshape(Bsz, nchunk, chunk, H, Pd) + y_off
    return y.reshape(Bsz, S, H, Pd).to(out), st.to(out)


def ssd_decode_step(x1, dt1, A, B1, C1, state):
    """One-token SSD recurrence. x1: (B, 1, H, P); dt1: (B, 1, H); B1/C1:
    (B, 1, N); state (B, H, P, N). Returns (y (B, 1, H, P), new_state), in
    the reference's types (the float32 state promotes both)."""
    dA = torch.exp(dt1[:, 0, :] * A[None, :])               # (B, H)
    ut = _promoted(B1, dt1, x1)
    upd = B1[:, 0, None, None, :].to(ut) * (
        dt1[:, 0, :, None].to(ut) * x1[:, 0].to(ut))[..., None]
    new_state = state * dA[:, :, None, None] + upd          # (B, H, P, N)
    yt = _promoted(C1, new_state)
    y = torch.einsum("bn,bhpn->bhp", C1[:, 0].to(yt), new_state.to(yt))
    return y[:, None], new_state


def mamba_block(x, params, cfg: ModelConfig, *, cache=None):
    """Mamba2 block: in_proj -> short conv -> SSD -> gated out_proj.

    cache: None, or dict(conv (B, d_conv - 1, Din + 2N), state (B, H, P,
    N)), both written in place. Returns (out, cache).

    A prefill with a cache (S > 1) runs ``ssd_chunked`` from the cached
    state, on the ``ssd_chunk`` kernel, where the reference runs a per-token
    scan of ``ssd_decode_step``: the two are equal in exact arithmetic, and
    the last chunk's padding (dt = 0) leaves the final state exact (its decay
    is exp(0) = 1 and its dt x is 0). The reference's result types are kept:
    with a cache, y is float32 (the state is), so ``y @ out_proj`` is a
    float32 product, as in JAX.
    """
    B, S, D = x.shape
    Din, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z = _mm(x, params["in_z"])                               # (B, S, Din)
    xbc = _mm(x, params["in_xbc"])                           # (B, S, Din+2N)
    dt = _mm(x, params["in_dt"])                             # (B, S, H)
    if cache is None:
        xbc_conv = _causal_conv(xbc, params["conv_w"], cfg.d_conv)
    else:
        hist = torch.cat([cache["conv"], xbc], dim=1)
        xbc_conv = _causal_conv(hist, params["conv_w"], cfg.d_conv)[:, -S:]
        new_conv = hist[:, -(cfg.d_conv - 1):]
    xbc_conv = F.silu(xbc_conv)
    xin, Bm, Cm = torch.split(xbc_conv, [Din, N, N], dim=-1)
    xin = xin.reshape(B, S, H, Pd)
    dt = F.softplus(dt + params["dt_bias"])                  # (B, S, H)
    A = -torch.exp(params["A_log"])                          # (H,)
    if cache is not None and S == 1:
        y, new_state = ssd_decode_step(xin, dt, A, Bm, Cm, cache["state"])
    else:
        chunk = min(cfg.ssm_chunk, S)
        pad = -S % chunk
        init = None if cache is None else cache["state"]
        if pad:
            y, new_state = ssd_chunked(
                F.pad(xin, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                A, F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)),
                chunk, init_state=init)
            y = y[:, :S]
        else:
            y, new_state = ssd_chunked(xin, dt, A, Bm, Cm, chunk,
                                       init_state=init)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
    y = y + xin * params["D_skip"][None, None, :, None]
    y = y.reshape(B, S, Din)
    y = y * F.silu(z)
    return _mm(y, params["out_proj"]), cache


def _causal_conv(x, w, width: int):
    """Depthwise causal conv. x: (B, S, C); w: (width, C). The reference's
    sum order: tap 0 (the oldest) first."""
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for t in range(width):
        out = out + pad[:, t:t + x.shape[1]] * w[t][None, None, :]
    return out
