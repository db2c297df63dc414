"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and keeps its own copies of what it needs. Entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``, and raise
when no GPU is present and the CPU was not asked for (see
``repro_torch.device``). Kernels that the JAX package wrote in Pallas for the
TPU are written by hand for Hopper under ``repro_torch/kernels/csrc``.
"""
