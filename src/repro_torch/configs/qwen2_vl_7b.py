"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone only per the assignment; the vision frontend is a STUB
(input_specs provide precomputed patch embeddings; a learned projector maps
them into the token stream at vision_mask positions).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", kind="decoder",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), frontend="vision_patches",
).validate()

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=512,
                      mrope_sections=(2, 3, 3))
