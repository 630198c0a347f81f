"""SealD-NeRF on PyTorch and CUDA: the port of `sealdnerf_tpu` to one NVIDIA
H100.

The JAX package `sealdnerf_tpu` is the reference; every module here mirrors
the module of the same path there and is held against it by the
`tests/test_torch_*.py` parity tests. This package imports `torch` and never
`jax`.

Ported: every CLI of the reference but the GUI (main_nerf, main_dnerf,
main_seald, main_SealNeRF, main_tensoRF, main_CCNeRF, main_sdf), on the CP
fields through the four hand-written Hopper kernels that replace the Pallas
ones (ops/csrc/field_fwd.cu, field_bwd.cu, dyn_field_fwd.cu,
dyn_field_bwd.cu), and on the Instant-NGP, D-NeRF, TensoRF and SDF fields in
plain PyTorch, as the reference computes those in plain XLA.
"""

__version__ = "0.1.0"
