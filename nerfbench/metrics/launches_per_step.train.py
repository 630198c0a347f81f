"""CUDA kernel launches a training step: the device kernels of the traced
slice over its steps."""


def read(s):
    return s.n_kernels / s.units if s.n_kernels else None
