"""Model assembly: parameter shapes and init, and the forward pass (port of
``repro/models/model.py``).

Parameters are the reference's tree, as a nested dict of tensors: layers
are grouped into *periods* (the smallest repeating signature of mixer kind
and MoE), and each leaf of ``blocks/pos<i>`` is stacked over the period's
repeats. JAX scans over that stack; here a Python loop walks it. Shapes,
leaf names and layouts are the reference's (``x @ w``), so
``weights.params_from_numpy`` carries a JAX tree across as it is.

Init is deterministic in (seed, path) with the reference's distributions,
not its numbers: one ``torch.Generator`` per leaf, seeded with the CRC-32
of the seed and the leaf's path.

Every family of the registry: decoders with GQA or MLA attention and a dense
or MoE FFN, Qwen2-VL's vision-patch frontend with M-RoPE, the HuBERT encoder
over audio frames, the attention-free Mamba2 stack (``kind="ssm"``) and the
Mamba/attention hybrid (``kind="hybrid"``), each with ``Model.loss``.
``forward(remat=True)`` (the default) recomputes each period in the
backward pass, as the reference's ``jax.checkpoint`` with
``nothing_saveable`` over its scan body.
"""
from __future__ import annotations

import math
import zlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.coo import resolve_device
from . import layers as L
from .config import ModelConfig


def _dtype(name):
    return dict(bfloat16=torch.bfloat16, float32=torch.float32,
                float16=torch.float16)[name]


def vocab_padded(cfg: ModelConfig, mult: int = 256) -> int:
    return -(-cfg.vocab // mult) * mult


def period_of(cfg: ModelConfig) -> int:
    sig = list(zip(cfg.layer_kinds(), cfg.layer_moe()))
    for p in range(1, cfg.n_layers + 1):
        if cfg.n_layers % p:
            continue
        if all(sig[i] == sig[i % p] for i in range(cfg.n_layers)):
            return p
    return cfg.n_layers


def experts_padded(cfg: ModelConfig, mult: int = 16) -> int:
    return -(-cfg.n_experts // mult) * mult if cfg.is_moe else 0


# --------------------------------------------------------------------------
# parameter construction
# --------------------------------------------------------------------------

def _layer_param_shapes(cfg: ModelConfig, kind: str, moe: bool):
    """Shapes for one layer position (unstacked)."""
    D = cfg.d_model
    shapes: dict[str, tuple] = {"ln1": (D,)}
    if kind == "attn":
        if cfg.use_mla:
            dq = cfg.qk_nope_dim + cfg.qk_rope_dim
            shapes.update(
                wq=(D, cfg.n_heads * dq),
                w_dkv=(D, cfg.kv_lora_rank + cfg.qk_rope_dim),
                kv_ln=(cfg.kv_lora_rank,),
                w_ukv=(cfg.kv_lora_rank,
                       cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)),
                wo=(cfg.n_heads * cfg.v_head_dim, D))
        else:
            hd = cfg.hd
            shapes.update(wq=(D, cfg.n_heads * hd),
                          wk=(D, cfg.n_kv_heads * hd),
                          wv=(D, cfg.n_kv_heads * hd),
                          wo=(cfg.n_heads * hd, D))
            if cfg.qkv_bias:
                shapes.update(bq=(cfg.n_heads * hd,),
                              bk=(cfg.n_kv_heads * hd,),
                              bv=(cfg.n_kv_heads * hd,))
    else:  # mamba
        Din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        shapes.update(in_z=(D, Din), in_xbc=(D, Din + 2 * N), in_dt=(D, H),
                      conv_w=(cfg.d_conv, Din + 2 * N),
                      dt_bias=(H,), A_log=(H,), D_skip=(H,),
                      out_proj=(Din, D))
    if cfg.kind != "ssm":
        shapes["ln2"] = (D,)
        F = cfg.d_ff
        if moe:
            E = experts_padded(cfg)
            shapes.update(router=(D, E),
                          we_g=(E, D, F), we_1=(E, D, F), we_2=(E, F, D))
            if cfg.n_shared_experts:
                Ns = cfg.n_shared_experts
                shapes.update(ws_g=(Ns, D, F), ws_1=(Ns, D, F),
                              ws_2=(Ns, F, D))
        elif cfg.mlp_act == "gelu":
            shapes.update(w1=(D, F), w2=(F, D))
        else:
            shapes.update(wg=(D, F), w1=(D, F), w2=(F, D))
    return shapes


def param_shapes(cfg: ModelConfig):
    """Full model parameter shape tree (stacked periods)."""
    Vp = vocab_padded(cfg)
    D = cfg.d_model
    period = period_of(cfg)
    reps = cfg.n_layers // period
    kinds = cfg.layer_kinds()[:period]
    moes = cfg.layer_moe()[:period]
    blocks = {}
    for pos in range(period):
        lshapes = _layer_param_shapes(cfg, kinds[pos], moes[pos])
        blocks[f"pos{pos}"] = {k: (reps,) + v for k, v in lshapes.items()}
    tree = dict(embed=(Vp, D), final_norm=(D,), blocks=blocks)
    if not cfg.tie_embeddings:
        tree["lm_head"] = (Vp, D)
    if cfg.frontend == "vision_patches":
        tree["vision_proj"] = (D, D)     # stub projector for patch embeds
    if cfg.frontend == "audio_frames":
        tree["frame_proj"] = (D, D)
    return tree


def _leaf_generator(seed: int, path: str, device) -> torch.Generator:
    """The leaf's own generator, seeded with the CRC-32 of seed and path: a
    stable digest, as the reference folds ``crc32(path)`` into its key
    (Python's ``hash`` is salted per process), and 32 bits, all that the
    CPU generator reads of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed(zlib.crc32(f"{seed}/{path}".encode()))
    return g


def _init_one(path: str, shape, pdt, device, seed: int) -> torch.Tensor:
    """One leaf, with the reference's distribution. A normal leaf under
    ``blocks/`` is drawn one stacked layer at a time in float32 and stored in
    ``pdt``, so no float32 copy of a whole stack is ever held."""
    name = path.split("/")[-1]
    if name.startswith("ln") or name in ("final_norm", "kv_ln", "D_skip"):
        return torch.ones(shape, dtype=pdt, device=device)
    if name == "A_log":
        row = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device))
        return row.to(pdt).expand(shape).clone()
    if name == "dt_bias":
        # softplus^-1 of dt in [1e-3, 1e-1], log-spaced
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1),
                                      shape[-1], device=device))
        return torch.log(torch.expm1(dt)).to(pdt).expand(shape).clone()
    if name.startswith("b"):
        return torch.zeros(shape, dtype=pdt, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 0.02 if name in ("embed", "lm_head") else 1.0 / math.sqrt(fan_in)
    g = _leaf_generator(seed, path, device)
    out = torch.empty(shape, dtype=pdt, device=device)
    parts = out if path.startswith("blocks/") else out[None]
    for part in parts:
        part.copy_(torch.randn(part.shape, generator=g, device=device) * std)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=None):
    """The parameter tree of ``param_shapes`` on ``device`` (None: the GPU,
    raising when there is none), in ``dtype`` (None: ``cfg.param_dtype``)."""
    dev = resolve_device(device)
    pdt = dtype or _dtype(cfg.param_dtype)

    def build(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out[k] = build(v, path) if isinstance(v, dict) \
                else _init_one(path, v, pdt, dev, seed)
        return out

    return build(param_shapes(cfg))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

class Model(nn.Module):
    """The layer stack over an explicit parameter tree.

    ``forward(params, batch, caches=None)`` returns (logits, aux_loss,
    new_caches) as the reference's. Caches are updated in place and
    returned: the KV cache is the largest buffer a server holds, and a copy
    per step would double it. Their layout is the reference's, with each
    attention position's ``offset`` kept on the host, where the eager loop
    reads it: GQA's k and v, MLA's latent ``c_kv`` and rope key ``k_rope``;
    a mamba position's cache is its conv history and SSM state.

    ``cast_early`` casts the parameters to the compute type before the
    layer loop, the ``_KEEP_F32`` leaves excepted (the reference's option:
    there it moves bf16 through the sharded all-gathers; here it is one cast
    a forward instead of one a layer, with the same numbers).
    """

    _KEEP_F32 = ("A_log", "dt_bias", "D_skip", "ln1", "ln2", "kv_ln")

    def __init__(self, cfg: ModelConfig, *, cast_early: bool = False):
        super().__init__()
        self.cfg = cfg
        self.cast_early = cast_early

    # ---------------- embedding / frontend ----------------
    def embed(self, params, batch):
        """Token embeddings, or the frontend's: ``features @ frame_proj``
        for audio frames; for vision patches, ``vision_embeds @ vision_proj``
        over the True positions of ``vision_mask`` (patch t at the t-th True
        position of its row, patch T - 1 for any past the T-th, as the
        reference clips). A batch without ``vision_embeds`` (a decode step)
        is text only."""
        cfg = self.cfg
        adt = _dtype(cfg.dtype)
        if cfg.frontend == "audio_frames":
            return batch["features"].to(adt) @ params["frame_proj"].to(adt)
        x = nn.functional.embedding(batch["tokens"], params["embed"]).to(adt)
        if cfg.frontend == "vision_patches" and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(adt) @ params["vision_proj"].to(adt)
            vm = batch["vision_mask"].to(torch.bool)
            take = (torch.cumsum(vm, dim=1) - 1).clamp(0, ve.shape[1] - 1)
            ve_at = torch.gather(ve, 1, take[..., None].expand(
                *take.shape, ve.shape[-1]))
            x = torch.where(vm[..., None], ve_at, x)
        return x

    # ---------------- one layer ----------------
    def _cast_params(self, p):
        adt = _dtype(self.cfg.dtype)
        return {k: v if k in self._KEEP_F32 else v.to(adt)
                for k, v in p.items()}

    def _mixer(self, x, p, kind, pos, pos3, cache):
        if kind == "attn":
            if self.cfg.use_mla:
                return L.mla_block(x, p, self.cfg, pos, cache=cache)
            return L.gqa_block(x, p, self.cfg, pos, cache=cache, pos3=pos3)
        return L.mamba_block(x, p, self.cfg, cache=cache)

    def _layer(self, x, p, kind, moe, pos, pos3, cache):
        cfg = self.cfg
        p = self._cast_params(p)
        h = L.rmsnorm(x, p["ln1"], cfg.rms_eps)
        mix, new_cache = self._mixer(h, p, kind, pos, pos3, cache)
        x = x + mix.to(x.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if "ln2" in p:                   # mamba2 has no FFN sublayer
            h = L.rmsnorm(x, p["ln2"], cfg.rms_eps)
            if moe:
                ff, aux = L.moe_block(h, p, cfg)
            else:
                ff = L.mlp_block(h, p, cfg)
            x = x + ff.to(x.dtype)
        return x, aux, new_cache

    # ---------------- full stack ----------------
    def forward(self, params, batch, *, caches=None, remat=True):
        """Returns (logits (B, S, vocab_padded), aux_loss, new_caches).

        With ``remat`` (and grad mode on, and no caches) each period runs
        under ``torch.utils.checkpoint`` (non-reentrant): only its input is
        kept, and the backward pass runs its forward again, kernels
        included."""
        cfg = self.cfg
        if self.cast_early:
            params = self._cast_early(params)
        period = period_of(cfg)
        reps = cfg.n_layers // period
        kinds = cfg.layer_kinds()[:period]
        moes = cfg.layer_moe()[:period]
        x = self.embed(params, batch)
        B, S, _ = x.shape
        steps = torch.arange(S, dtype=torch.int32, device=x.device)
        offset = batch.get("offset")
        pos = steps.expand(B, S) if offset is None \
            else offset.to(x.device)[:, None] + steps[None]
        pos3 = batch.get("pos3")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def run_period(x, blks):
            total = torch.zeros((), dtype=torch.float32, device=x.device)
            for i, (kind, moe) in enumerate(zip(kinds, moes)):
                x, a, _ = self._layer(x, blks[i], kind, moe, pos, pos3, None)
                total = total + a
            return x, total

        # each stacked leaf split into its repeats once: the backward pass
        # then stacks their gradients once, where taking v[r] a repeat at a
        # time would zero-fill a full-size gradient and add it up, a repeat
        # at a time (work quadratic in depth; PERF.md §5, mamba2 training)
        stacks = [{k: v.unbind(0) for k, v in
                   params["blocks"][f"pos{i}"].items()}
                  for i in range(period)]
        for r in range(reps):
            blks = [{k: v[r] for k, v in stacks[i].items()}
                    for i in range(period)]
            if caches is None:
                if remat and torch.is_grad_enabled():
                    x, a = checkpoint(run_period, x, blks,
                                      use_reentrant=False)
                else:
                    x, a = run_period(x, blks)
                aux = aux + a
                continue
            for i, (kind, moe) in enumerate(zip(kinds, moes)):
                cc = caches[f"pos{i}"]
                c = {k: v[r] for k, v in cc.items() if k != "offset"}
                if kind == "attn":
                    c["offset"] = int(cc["offset"][r])
                x, a, nc = self._layer(x, blks[i], kind, moe, pos, pos3, c)
                aux = aux + a
                if kind == "attn":
                    cc["offset"][r] = nc["offset"]
        x = L.rmsnorm(x, params["final_norm"], cfg.rms_eps)
        head = params.get("lm_head", params["embed"])
        logits = x @ head.T.to(x.dtype)
        return logits, aux, caches

    # ---------------- loss ----------------
    def loss(self, params, batch):
        """(loss, dict(nll, aux, ntok)): the mean token NLL, logsumexp in
        float32, over ``labels >= 0`` (labels clamped to >= 0), or for an
        encoder over its ``mask`` of ``targets``; plus the MoE aux loss.
        ``ntok`` counts the positions, at least 1."""
        logits, aux, _ = self.forward(params, batch)
        if self.cfg.kind == "encoder":
            labels = batch["targets"]
            mask = batch["mask"].float()
        else:
            labels = batch["labels"]
            mask = (labels >= 0).float()
        labels = labels.clamp(min=0).long()
        lf = logits.float()
        gold = torch.gather(lf, -1, labels[..., None])[..., 0]
        nll = (torch.logsumexp(lf, dim=-1) - gold) * mask
        ntok = mask.sum().clamp(min=1.0)
        mean = nll.sum() / ntok
        return mean + aux, dict(nll=mean, aux=aux, ntok=ntok)

    def _cast_early(self, params):
        adt = _dtype(self.cfg.dtype)
        out = dict(params)
        out["blocks"] = {pos: self._cast_params(blk)
                         for pos, blk in params["blocks"].items()}
        for k in ("embed", "lm_head", "vision_proj", "frame_proj"):
            if k in params:
                out[k] = params[k].to(adt)
        return out

    # ---------------- kv / state caches ----------------
    def init_cache(self, batch_size: int, max_len: int, device=None, *,
                   abstract: bool = False, dtype=None):
        """Zeroed caches in the reference's layout, on ``device`` (None: the
        GPU), per period position: for GQA attention, k and v of (reps, B,
        max_len, KVH, hd); for MLA, ``c_kv`` (reps, B, max_len,
        kv_lora_rank) and ``k_rope`` (reps, B, max_len, 1, qk_rope_dim);
        both in ``dtype`` (None: the compute type), with ``offset`` (reps,)
        int32 on the host; for mamba, ``conv`` (reps, B, d_conv - 1, Din +
        2N) in ``dtype`` and ``state`` (reps, B, H, P, N) in float32.
        ``abstract=True`` puts every tensor, offsets too, on the ``meta``
        device (shapes and types without storage, the reference's
        ``ShapeDtypeStruct``s)."""
        cfg = self.cfg
        dev = torch.device("meta") if abstract else resolve_device(device)
        host = dev if abstract else torch.device("cpu")
        dt = dtype or _dtype(cfg.dtype)
        period = period_of(cfg)
        reps = cfg.n_layers // period

        def mk(*shape, dtyp=dt, on=dev):
            return torch.zeros((reps, batch_size) + shape, dtype=dtyp,
                               device=on)

        caches = {}
        for i, kind in enumerate(cfg.layer_kinds()[:period]):
            if kind == "attn":
                if cfg.use_mla:
                    c = dict(c_kv=mk(max_len, cfg.kv_lora_rank),
                             k_rope=mk(max_len, 1, cfg.qk_rope_dim))
                else:
                    c = dict(k=mk(max_len, cfg.n_kv_heads, cfg.hd),
                             v=mk(max_len, cfg.n_kv_heads, cfg.hd))
                c["offset"] = torch.zeros(reps, dtype=torch.int32,
                                          device=host)
            else:
                c = dict(conv=mk(cfg.d_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state),
                         state=mk(cfg.ssm_heads, cfg.ssm_headdim,
                                  cfg.ssm_state, dtyp=torch.float32))
            caches[f"pos{i}"] = c
        return caches
