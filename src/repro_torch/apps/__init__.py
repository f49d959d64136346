"""repro_torch.apps — the paper's applications, built on repro_torch.core (§7)."""
from .bfs import bfs_levels
from .pagerank import pagerank
from .fastsv import fastsv
from .hipmcl import hipmcl
from .tricount import triangle_count
from .matching import maximal_matching
