"""repro_torch.dist — wire compression for the sparse exchanges and the
dense reductions (``compression``).

The JAX package's ``dist/shardings.py`` (the parameter sharding plan of the
LM stack) is not ported yet (ROADMAP.md, "the rest of the LM stack").
"""
from . import compression
from .compression import (dequantize_payload, int8_quantize,
                          make_topk_error_feedback, quantize_payload)
