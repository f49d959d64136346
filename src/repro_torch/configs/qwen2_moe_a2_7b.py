"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts are padded to 64 for 16-way expert parallelism (router
logits for padding experts are masked to -inf — they never receive tokens).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", kind="decoder",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936,
    n_experts=60, n_shared_experts=4, top_k=4, moe_every=1,
    rope_theta=1e6,
).validate()

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=32, vocab=512, n_experts=8,
                      n_shared_experts=2, top_k=2, capacity_factor=8.0)
