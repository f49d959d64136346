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

Under a ``ShardingPlan`` on a mesh of ranks (``dist/shardings.py``) every
rank holds its block of each leaf (``init_params(plan=)``, a DTensor each)
and runs its data shard's rows: a layer gathers each sharded leaf it uses
and drops it after (ZeRO-3's gathers at use, so the numbers are the
plan-less model's), except the routed experts under ``plan.moe_ep``, which
stay on their rank (``layers.moe_block_ep``). Activations pass through
``layers.constrain`` where the reference constrains them (the embedding,
each layer's output, the logits); the logits come back as a DTensor (rows
over the data axes, the vocabulary over the model axis). The
tensor-parallel products that GSPMD picks on the TPU are not ported: each
rank of a model group computes its shard's whole layer.
"""
from __future__ import annotations

import math
import zlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.coo import resolve_device
from ..dist import shardings as sh
from ..kernels import refuse_grad
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


def _init_one(path: str, shape, pdt, device, seed: int,
              take=lambda t: t) -> torch.Tensor:
    """One leaf, with the reference's distribution. A normal leaf under
    ``blocks/`` is drawn one stacked layer at a time in float32 and stored in
    ``pdt``, so no float32 copy of a whole stack is ever held. ``take`` maps
    the leaf, or each stacked layer drawn (with a leading dim of one), to
    what is kept of it: all of it, or a rank's block (``init_params``), so
    that no rank holds a whole stacked leaf either."""
    name = path.split("/")[-1]
    if name.startswith("ln") or name in ("final_norm", "kv_ln", "D_skip"):
        return take(torch.ones(shape, dtype=pdt, device=device))
    if name == "A_log":
        row = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device))
        return take(row.to(pdt).expand(shape).clone())
    if name == "dt_bias":
        # softplus^-1 of dt in [1e-3, 1e-1], log-spaced
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1),
                                      shape[-1], device=device))
        return take(torch.log(torch.expm1(dt)).to(pdt).expand(shape).clone())
    if name.startswith("b"):
        return take(torch.zeros(shape, dtype=pdt, device=device))
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 0.02 if name in ("embed", "lm_head") else 1.0 / math.sqrt(fan_in)
    g = _leaf_generator(seed, path, device)
    if not path.startswith("blocks/"):
        return take(torch.randn(shape, generator=g, device=device) * std) \
            .to(pdt)
    out = None
    for r in range(shape[0]):
        part = take(torch.randn((1,) + tuple(shape[1:]), generator=g,
                                device=device) * std)
        if out is None:
            out = torch.empty((shape[0],) + tuple(part.shape[1:]),
                              dtype=pdt, device=device)
        out[r] = part[0]
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _mesh_of(plan):
    """The plan's mesh when it is one of ranks, else None."""
    return plan.mesh if plan is not None and \
        sh.is_device_mesh(plan.mesh) else None


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=None,
                *, plan=None):
    """The parameter tree of ``param_shapes`` on ``device`` (None: the GPU,
    raising when there is none), in ``dtype`` (None: ``cfg.param_dtype``).

    With a ``plan`` on a mesh of ranks each leaf is a DTensor holding this
    rank's block under ``init_param_specs``; each leaf is drawn in turn (a
    stacked one a layer at a time) and only the block kept, with the
    numbers of the plan-less init. Every rank of the mesh calls it."""
    dev = resolve_device(device)
    pdt = dtype or _dtype(cfg.param_dtype)
    mesh = _mesh_of(plan)
    specs = init_param_specs(cfg, plan) if mesh is not None else None

    def leaf(path, shape, spec):
        if mesh is None:
            return _init_one(path, shape, pdt, dev, seed)
        local = _init_one(path, shape, pdt, dev, seed,
                          take=lambda t: sh.local_shard(t, spec, mesh))
        return sh.from_local(local, spec, mesh, shape)

    def build(tree, spec_tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            spec = None if spec_tree is None else spec_tree[k]
            out[k] = build(v, spec, path) if isinstance(v, dict) \
                else leaf(path, v, spec)
        return out

    return build(param_shapes(cfg), specs)


def init_param_specs(cfg: ModelConfig, plan):
    """PartitionSpec tree matching ``param_shapes`` (see
    ``dist/shardings.py``)."""
    def build(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out[k] = build(v, path) if isinstance(v, dict) \
                else sh.spec_for_param(path, v, cfg, plan)
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

    ``plan`` (a ``ShardingPlan``): on a mesh of ranks the forward runs as
    the module docstring says, every rank with the global batch; without a
    mesh of ranks it changes nothing, as the reference's constraints
    outside a mesh. Under a plan on a mesh a forward that needs a gradient
    raises (``kernels.refuse_grad``), and so does context parallelism
    (decode with fewer rows than data shards).
    """

    _KEEP_F32 = ("A_log", "dt_bias", "D_skip", "ln1", "ln2", "kv_ln")

    def __init__(self, cfg: ModelConfig, plan=None, *,
                 cast_early: bool = False):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.cast_early = cast_early

    def _mesh_plan(self):
        """The plan when it runs on a mesh of ranks, else None."""
        return self.plan if _mesh_of(self.plan) is not None else None

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
            return batch["features"].to(adt) @ \
                sh.gather(params["frame_proj"]).to(adt)
        x = nn.functional.embedding(batch["tokens"],
                                    sh.gather(params["embed"])).to(adt)
        if cfg.frontend == "vision_patches" and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(adt) @ \
                sh.gather(params["vision_proj"]).to(adt)
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
        plan = self._mesh_plan()
        p = self._cast_params(p if plan is None else self._use(p))
        h = L.rmsnorm(x, p["ln1"], cfg.rms_eps)
        mix, new_cache = self._mixer(h, p, kind, pos, pos3, cache)
        x = x + mix.to(x.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if "ln2" in p:                   # mamba2 has no FFN sublayer
            h = L.rmsnorm(x, p["ln2"], cfg.rms_eps)
            if moe and plan is not None and plan.moe_ep:
                ff, aux = L.moe_block_ep(h, p, cfg, plan)
            elif moe and plan is not None:
                ff, aux = self._moe_all_rows(h, p, plan)
            elif moe:
                ff, aux = L.moe_block(h, p, cfg)
            else:
                ff = L.mlp_block(h, p, cfg)
            x = x + ff.to(x.dtype)
        if plan is not None:
            x = self._boundary(x, plan)
        return x, aux, new_cache

    # ---------------- under a plan on a mesh of ranks ----------------
    def _use(self, p):
        """A layer's leaves as it computes with them: the DTensors gathered
        whole (together: one exchange a mesh dim; dropped with the layer),
        the routed experts under ``moe_ep`` this rank's block as it is."""
        ep = self.plan is not None and self.plan.moe_ep
        keys = [k for k in p if not (ep and k in sh.MOE_EXPERT_PARAMS)]
        whole = dict(zip(keys, sh.gather_many([p[k] for k in keys])))
        return {k: whole[k] if k in whole else sh.local(v)
                for k, v in p.items()}

    def _boundary(self, x, plan, spec=None, keep=False):
        """This rank's rows ``x`` as a DTensor of rows over the data axes,
        through ``layers.constrain`` to ``spec`` (None: the plan's
        act_spec); then whole over the model axis again for the next layer,
        or, with ``keep``, the DTensor as it is (the logits)."""
        rows = sh.P(plan.dp(), *([None] * (x.dim() - 1)))
        shape = (x.shape[0] * plan.dp_size,) + tuple(x.shape[1:])
        xd = L.constrain(sh.from_local(x, rows, plan.mesh, shape),
                         spec or plan.act_spec())
        return xd if keep else sh.gather(xd, axes=(plan.model_axis,))

    def _moe_all_rows(self, h, p, plan):
        """``moe_block`` over the global batch (every data shard's rows
        gathered), as the reference's plan without ``moe_ep`` routes it;
        this shard's rows of the output."""
        hg = sh.gather_rows(h, plan)
        ff, aux = L.moe_block(hg, p, self.cfg)
        return ff[sh.dp_rows(plan, hg.shape[0])], aux

    def _rows(self, batch, plan):
        """This rank's data shard of a global batch (pos3's rows are its
        dim 1)."""
        B = batch["features" if "features" in batch else "tokens"].shape[0]
        r = sh.dp_rows(plan, B)
        return {k: (v[:, r] if k == "pos3" else v[r])
                if torch.is_tensor(v) else v for k, v in batch.items()}

    # ---------------- full stack ----------------
    def forward(self, params, batch, *, caches=None, remat=True):
        """Returns (logits (B, S, vocab_padded), aux_loss, new_caches).

        With ``remat`` (and grad mode on, and no caches) each period runs
        under ``torch.utils.checkpoint`` (non-reentrant): only its input is
        kept, and the backward pass runs its forward again, kernels
        included."""
        cfg = self.cfg
        plan = self._mesh_plan()
        if plan is not None:
            refuse_grad("Model.forward under a ShardingPlan", "its leaf "
                        "gathers and expert sums carry no gradient yet",
                        *_leaves(params))
            if plan.context_parallel:
                raise NotImplementedError(
                    "context parallelism (decode with fewer rows than data "
                    "shards) is not ported")
            batch = self._rows(batch, plan)
        if self.cast_early:
            params = self._cast_early(params)
        period = period_of(cfg)
        reps = cfg.n_layers // period
        kinds = cfg.layer_kinds()[:period]
        moes = cfg.layer_moe()[:period]
        x = self.embed(params, batch)
        if plan is not None:
            x = self._boundary(x, plan)
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
        unstack = (lambda v: v.unbind(0)) if plan is None else sh.unstack
        stacks = [{k: unstack(v) for k, v in
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
        norm, head = params["final_norm"], params.get("lm_head",
                                                      params["embed"])
        if plan is not None:
            norm, head = sh.gather_many([norm, head])
        x = L.rmsnorm(x, norm, cfg.rms_eps)
        logits = x @ head.T.to(x.dtype)
        if plan is not None:
            logits = self._boundary(logits, plan, plan.logits_spec(),
                                    keep=True)
        return logits, aux, caches

    # ---------------- loss ----------------
    def loss(self, params, batch):
        """(loss, dict(nll, aux, ntok)): the mean token NLL, logsumexp in
        float32, over ``labels >= 0`` (labels clamped to >= 0), or for an
        encoder over its ``mask`` of ``targets``; plus the MoE aux loss.
        ``ntok`` counts the positions, at least 1."""
        logits, aux, _ = self.forward(params, batch)
        logits = sh.gather(logits)       # whole under a plan
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
        ``ShapeDtypeStruct``s). Under a plan on a mesh of ranks B is this
        rank's data shard of ``batch_size`` rows, every head whole."""
        cfg = self.cfg
        plan = self._mesh_plan()
        if plan is not None:
            r = sh.dp_rows(plan, batch_size)
            batch_size = r.stop - r.start
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
