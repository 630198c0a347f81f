"""CUDA kernel launches a frame: the device kernels of the traced slice
over its frames."""


def read(s):
    return s.n_kernels / s.units if s.n_kernels else None
