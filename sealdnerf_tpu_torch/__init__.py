"""SealD-NeRF on PyTorch and CUDA: the port of `sealdnerf_tpu` to one NVIDIA
H100.

The JAX package `sealdnerf_tpu` is the reference; every module here mirrors
the module of the same path there and is held against it by the
`tests/test_torch_*.py` parity tests. This package imports `torch` and never
`jax`.

Ported so far: the static CP render path (`main_nerf.py ... --test`):
ray generation, the dense march, the CP field with its hand-written Hopper
kernel (ops/csrc/field_fwd.cu, the port of the Pallas `_field_kernel`),
compositing, the occupancy grid, the tiled whole-frame renderer, checkpoint
IO and the inference half of `FastTrainer`.
"""

__version__ = "0.1.0"
