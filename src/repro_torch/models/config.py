"""ModelConfig — one dataclass describing every supported architecture (own copy).

Families (``kind``):
  'decoder'  causal LM: GQA/MLA attention + (dense | MoE) MLP   [most archs]
  'encoder'  bidirectional encoder (HuBERT): masked-unit prediction
  'ssm'      attention-free Mamba2 (SSD)
  'hybrid'   Jamba: periodic attention in a Mamba stack, MoE interleave

Every field is explicit so configs/<arch>.py files read like the paper
tables they came from.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                       # decoder | encoder | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int

    # ---- attention ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False          # qwen2
    rope_theta: float = 1e6
    mrope_sections: Optional[tuple[int, ...]] = None   # qwen2-vl M-RoPE
    causal: bool = True

    # ---- MLA (deepseek-v2) ----
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0            # 0 = full-rank q projection
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # ---- MLP / MoE ----
    d_ff: int = 0                   # dense MLP width (per expert for MoE)
    mlp_act: str = "silu"           # silu (swiglu) | gelu (hubert)
    n_experts: int = 0              # routed experts (0 = dense)
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1              # MoE layer every k layers (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # ---- Mamba2 / SSD ----
    ssm_state: int = 0              # N
    ssm_headdim: int = 64           # P
    ssm_expand: int = 2
    ssm_chunk: int = 128
    d_conv: int = 4
    attn_period: int = 0            # hybrid: one attention layer per period
    attn_offset: int = 0            # index within the period

    # ---- encoder (hubert) ----
    mask_prob: float = 0.08

    # ---- numerics / norm ----
    rms_eps: float = 1e-6
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"
    tie_embeddings: bool = False

    # ---- frontend stubs ----
    frontend: Optional[str] = None  # None | 'audio_frames' | 'vision_patches'

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:       # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> list[str]:
        """Per-layer kind: 'attn' | 'mamba' for the mixer part."""
        if self.kind in ("decoder", "encoder"):
            return ["attn"] * self.n_layers
        if self.kind == "ssm":
            return ["mamba"] * self.n_layers
        out = []
        for i in range(self.n_layers):
            if self.attn_period and i % self.attn_period == self.attn_offset:
                out.append("attn")
            else:
                out.append("mamba")
        return out

    def layer_moe(self) -> list[bool]:
        if not self.is_moe:
            return [False] * self.n_layers
        return [(i % self.moe_every) == (self.moe_every - 1)
                if self.moe_every > 1 else True
                for i in range(self.n_layers)]

    def validate(self):
        assert self.kind in ("decoder", "encoder", "ssm", "hybrid")
        if self.kind in ("decoder", "encoder"):
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0
        if self.kind == "hybrid":
            assert self.attn_period > 0
        if self.is_moe:
            assert 0 < self.top_k <= self.n_experts
        return self

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **overrides)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
    D, V = cfg.d_model, cfg.vocab
    total = V * D                       # embedding
    if not cfg.tie_embeddings:
        total += V * D                  # lm head
    kinds = cfg.layer_kinds()
    moes = cfg.layer_moe()
    for kind, moe in zip(kinds, moes):
        total += 2 * D                  # norms
        if kind == "attn":
            if cfg.use_mla:
                qd = cfg.qk_rope_dim + cfg.qk_nope_dim
                total += D * cfg.n_heads * qd                 # q proj
                total += D * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                total += cfg.kv_lora_rank * cfg.n_heads * \
                    (cfg.qk_nope_dim + cfg.v_head_dim)
                total += cfg.n_heads * cfg.v_head_dim * D     # o proj
            else:
                hd = cfg.hd
                total += D * cfg.n_heads * hd                 # wq
                total += 2 * D * cfg.n_kv_heads * hd          # wk, wv
                total += cfg.n_heads * hd * D                 # wo
                if cfg.qkv_bias:
                    total += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        else:
            Din, N = cfg.d_inner, cfg.ssm_state
            H = cfg.ssm_heads
            total += D * (2 * Din + 2 * N + H)                # in_proj
            total += cfg.d_conv * (Din + 2 * N)               # conv
            total += Din * D                                  # out_proj
            total += 2 * H + Din                              # A, dt_bias, Dskip
        if moe:
            total += D * cfg.n_experts                        # router
            total += cfg.n_experts * 3 * D * cfg.d_ff
            total += cfg.n_shared_experts * 3 * D * cfg.d_ff
        elif kind == "attn" or cfg.kind != "ssm":
            if cfg.d_ff:
                mult = 3 if cfg.mlp_act == "silu" else 2
                total += mult * D * cfg.d_ff
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Active (per-token) parameters — MoE counts top_k + shared only."""
    if not cfg.is_moe:
        return param_count(cfg)
    dense = dataclasses.replace(cfg, n_experts=0, n_shared_experts=0)
    base = param_count(dense)
    # subtract the dense-MLP layers counted for moe positions, add active moe
    D = cfg.d_model
    for moe in cfg.layer_moe():
        if moe:
            base -= 3 * D * cfg.d_ff * (1 if cfg.d_ff else 0)
            base += D * cfg.n_experts          # router
            base += (cfg.top_k + cfg.n_shared_experts) * 3 * D * cfg.d_ff
    return base
