"""SealD-NeRF on PyTorch and CUDA: the port of `sealdnerf_tpu` to one NVIDIA
H100.

The JAX package `sealdnerf_tpu` is the reference; every module here mirrors
the module of the same path there and is held against it by the
`tests/test_torch_*.py` parity tests. This package imports `torch` and never
`jax`.

Ported so far: the static CP render path (`main_nerf.py ... --test`),
training of the same field (`main_nerf.py`), and serving of the
time-conditioned CP-D-NeRF field (`main_dnerf.py ... --test`): ray
generation, the dense march, the CP field and its deform tower, compositing,
the static and the time-binned occupancy grids, the tiled whole-frame
renderer, checkpoint IO and `FastTrainer`. The Pallas kernels
`_field_kernel`, `_field_bwd_kernel` and `_dyn_field_kernel` are hand-written
Hopper kernels (ops/csrc/field_fwd.cu, field_bwd.cu, dyn_field_fwd.cu).
"""

__version__ = "0.1.0"
