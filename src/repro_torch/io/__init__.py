"""repro_torch.io — graph generators and the label-format reader (numpy,
host-side)."""
from .labelio import read_generalized_tuples
