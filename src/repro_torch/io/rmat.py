"""R-MAT / Graph500 generator (the port's own copy of ``repro.io.rmat``).

Vectorized recursive quadrant sampling in numpy with the Graph500
parameters (a, b, c, d) = (0.57, 0.19, 0.19, 0.05). Deterministic per seed.
"""
from __future__ import annotations

import numpy as np

GRAPH500 = (0.57, 0.19, 0.19, 0.05)


def rmat_edges(scale: int, edge_factor: int = 16, seed: int = 0,
               params=GRAPH500, permute: bool = True):
    """Generate 2^scale-vertex R-MAT edges. Returns (rows, cols) int64."""
    a, b, c, d = params
    n = 1 << scale
    ne = n * edge_factor
    rng = np.random.default_rng(seed)
    rows = np.zeros(ne, np.int64)
    cols = np.zeros(ne, np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(ne)
        go_right = (r >= a) & (r < ab) | (r >= abc)
        go_down = r >= ab
        rows = (rows << 1) | go_down
        cols = (cols << 1) | go_right
    if permute:
        perm = rng.permutation(n).astype(np.int64)
        rows, cols = perm[rows], perm[cols]
    return rows, cols


def rmat_coo(scale: int, edge_factor: int = 16, seed: int = 0,
             params=GRAPH500, symmetrize: bool = False,
             drop_self_loops: bool = False):
    """R-MAT as deduplicated COO with unit weights."""
    rows, cols = rmat_edges(scale, edge_factor, seed, params)
    if symmetrize:
        rows, cols = (np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
    if drop_self_loops:
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
    n = 1 << scale
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    rows, cols = rows[first], cols[first]
    vals = np.ones(len(rows), np.float32)
    return (n, n), rows, cols, vals
