"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: 64 layers of Mamba2 mixers (d_inner = 2·d_model = 5120,
80 heads × headdim 64, state 128, chunked SSD scan). No MLP sublayer
(Mamba2 convention). Sub-quadratic ⇒ runs long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", kind="ssm",
    n_layers=64, d_model=2560, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128, d_conv=4,
).validate()

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, vocab=512, ssm_state=16,
                      ssm_headdim=8, ssm_chunk=16)
