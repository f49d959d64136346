"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer [arXiv:2403.19887].

Jamba block structure: period 8 with the attention layer at offset 4
(1 attention : 7 mamba), MoE replacing the dense MLP every 2nd layer.
The paper uses Mamba-1 mixers; we use the Mamba2/SSD mixer (state 128,
headdim 64) — noted as a deviation in DESIGN.md §Arch-applicability.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", kind="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_every=2,
    attn_period=8, attn_offset=4,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
    rope_theta=1e6,
).validate()

SMOKE = CONFIG.scaled(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=512, n_experts=4,
                      top_k=2, ssm_state=16, ssm_headdim=8, ssm_chunk=16, capacity_factor=8.0)
