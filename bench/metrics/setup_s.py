"""Seconds from the process's start to the window's: imports, the CUDA
context, kernels loaded (built on a checkout's first run), weights and
optimizer state made from the seed, and the warm-up steps."""


def read(rec):
    return rec["setup_s"]
