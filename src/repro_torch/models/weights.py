"""Carry a parameter tree of the JAX package across to the port.

The port keeps the reference's tree, leaf names and layouts (``x @ w``), so
the carry is a copy, path for path, with no transpose. The optimizer state
carries the same way: ``init_opt_state``'s tree (``m`` and ``v`` shaped
like the parameters, ``step`` a 0-d int32) is a nested dict of arrays too,
so both packages can start from one ``(params, opt)``.
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
        t = torch.from_numpy(a.copy(order="C"))   # 0-d stays 0-d
    return t.to(device)


def params_from_numpy(tree, device=None):
    """The port's tensors from a nested dict of numpy arrays (the JAX
    package's ``init_params`` tree or its ``init_opt_state`` tree brought to
    the host), each in its own type and shape (a 0-d ``step`` stays 0-d), on
    ``device`` (None: the GPU)."""
    dev = resolve_device(device)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return _tensor(node, dev)

    return build(tree)
