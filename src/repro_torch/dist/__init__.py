"""repro_torch.dist — wire compression for the sparse exchanges and the
dense reductions (``compression``), and the LM stack's sharding plans and
parameter blocks on a named mesh (``shardings``).
"""
from . import compression
from .compression import (dequantize_payload, int8_quantize,
                          make_topk_error_feedback, quantize_payload)
