"""repro_torch.serve — KV-cache prefill and decode."""
from .decode import greedy_generate, make_prefill, make_serve_step
