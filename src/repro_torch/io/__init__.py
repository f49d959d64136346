"""repro_torch.io — graph generators, the label-format reader and the
MatrixMarket and binary matrix files (numpy, host-side)."""
from .binio import read_binary, write_binary
from .labelio import read_generalized_tuples
from .mmio import read_mm_header, read_mm_parallel, write_mm_parallel
