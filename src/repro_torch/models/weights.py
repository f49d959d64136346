"""Carry a parameter tree of the JAX package across to the port.

The port keeps the reference's tree, leaf names and layouts (``x @ w``), so
the carry is a copy, path for path, with no transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.coo import resolve_device


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: carry the bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_numpy(tree, device=None):
    """The port's parameters from a nested dict of numpy arrays (the JAX
    package's ``init_params`` tree brought to the host), each in its own
    type, on ``device`` (None: the GPU)."""
    dev = resolve_device(device)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return _tensor(node, dev)

    return build(tree)
