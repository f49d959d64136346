"""repro_torch — the PyTorch/CUDA port of ``repro`` (CombBLAS 2.0 primitives).

Same module layout and names as ``repro``; tensors live on the GPU unless a
caller passes ``device="cpu"``. Hand-written Hopper kernels sit in
``kernels/`` beside their plain PyTorch versions. The package imports neither
JAX nor ``repro``.
"""
