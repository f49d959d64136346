"""deepseek-67b [dense] — llama-arch, GQA [arXiv:2401.02954]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", kind="decoder",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=102400, rope_theta=1e4,
).validate()

SMOKE = CONFIG.scaled(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=96, vocab=512)
