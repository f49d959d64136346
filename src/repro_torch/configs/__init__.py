"""Own copies of the architectures (``--arch <id>``) and shape cells.

Data only, copied from the JAX package so the port imports none of it.
"""
from .registry import (ARCHS, SHAPES, cell_step_kind, cell_valid, get_config,
                       get_smoke, valid_cells)
