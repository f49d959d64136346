"""hubert-xlarge [audio] — encoder-only [arXiv:2106.07447].

Backbone only: the conv waveform frontend is a STUB (input_specs provide
precomputed frame embeddings (B, T, d_model)). Training objective is
masked-unit prediction over the 504-unit codebook at masked frames.
Encoder-only ⇒ no decode shapes (skipped per the assignment).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", kind="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, mlp_act="gelu", causal=False,
    frontend="audio_frames", mask_prob=0.08,
).validate()

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab=64)
