"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``csrc/`` holds the CUDA sources, ``build`` compiles and loads them, and each
kernel's module holds its wrapper, plain version and launch counter.
"""
