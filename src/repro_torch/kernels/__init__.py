"""Hand-written Hopper kernels (``csrc/``) and their plain PyTorch versions."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, why: str, *tensors) -> None:
    """Raise when a CUDA kernel that carries no gradient is asked for one:
    grad mode on and an input that requires grad. A kernel's output is a
    fresh tensor with no ``grad_fn``, so without this the autograd graph
    would be cut there and ``backward()`` would return gradients that skip
    the kernel, silently. The plain versions on the CPU stay
    differentiable."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}'s CUDA kernel has no backward ({why}); run it under "
            f"torch.no_grad() or on inputs that do not require grad")
