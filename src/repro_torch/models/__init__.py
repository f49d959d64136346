"""repro_torch.models — the LM stack (port of ``repro.models``)."""
from .config import ModelConfig
from .model import Model, init_params
