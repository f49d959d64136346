"""deepseek-7b [dense] — llama-arch, MHA (kv == heads) [arXiv:2401.02954]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", kind="decoder",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=102400, rope_theta=1e4,
).validate()

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=160, vocab=512)
