"""Times the dynamic field kernel (K3) of the tree in the current directory
on random and on ray-coherent samples, beside the static kernel (K1) on the
same coherent samples, and checks it against its plain version.

    cd <tree> && python3 <path to>/profiling/torch_dyn_kernel_timing.py TAG

The package is imported from the current directory, so two checkouts with
two versions of ops/csrc/dyn_field_fwd.cu can be compared inside one call on
one card, in turns (old, new, new, old). Prints one line: whether the kernel
is within K1's tolerances of the plain version, whether it equals K1 at
t = 0, and the times. A second line times the same field with a deform tower
of two matrices (no hidden one) instead of eight: the difference is the cost
of the six hidden layers, which separates the tower from the canonical half.
The field is chip_smoke.py's seeded dynamic field with its deform tower
re-gained; the coherent samples are those of a 256x256 pinhole frame, 128
samples a ray, in the tiled renderer's order (pixel-major).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sealdnerf_tpu_torch.models.cp import CPDNeRFConfig  # noqa: E402
from sealdnerf_tpu_torch.ops.field import (dyn_field_forward,  # noqa: E402
                                           dyn_field_forward_plain,
                                           field_forward, pack_tables)


def coherent_samples(res=256, n_steps=128):
    """Planar [3, res^2 * n_steps] positions and directions of a pinhole
    frame seen from (0.3, 0.2, -2.5) towards the box, each ray sampled in
    order from 1.5 to 3.5, clipped to the box."""
    px = (np.arange(res, dtype=np.float32) + 0.5) / res - 0.5
    u, v = np.meshgrid(px, px, indexing="xy")
    d = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.array([0.3, 0.2, -2.5], np.float32)
    ts = np.linspace(1.5, 3.5, n_steps, dtype=np.float32)
    x = np.clip(o + ts[None, :, None] * d[:, None, :], -1, 1)
    x3 = np.ascontiguousarray(x.reshape(-1, 3).T.astype(np.float32))
    d3 = np.ascontiguousarray(np.repeat(d, n_steps, axis=0).T)
    return torch.from_numpy(x3).cuda(), torch.from_numpy(d3).cuda()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    tag = sys.argv[1] if len(sys.argv) > 1 else "K3"
    cfg = CPDNeRFConfig()
    tables = pack_tables(chip_smoke._dyn_seeded_params(0, cfg, "cuda"), cfg)
    rng = np.random.default_rng(0)
    m = (1 << 20) + 37
    x3 = torch.from_numpy(
        rng.uniform(-1, 1, (3, m)).astype(np.float32)).cuda()
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    d3 = torch.from_numpy(d3).cuda()
    xc3, dc3 = coherent_samples()

    out = dyn_field_forward(tables, cfg, x3, d3, 0.37)
    ref = dyn_field_forward_plain(tables, cfg, x3, d3, 0.37)
    err = (out - ref).abs()
    (rs, a_s), (rc, a_c) = chip_smoke.TOL["sigma"], chip_smoke.TOL["rgb"]
    ok = bool((err[0] <= a_s + rs * ref[0].abs()).all()
              and (err[1:] <= a_c + rc * ref[1:].abs()).all())
    eq = torch.equal(dyn_field_forward(tables, cfg, x3, d3, 0.0),
                     field_forward(tables, cfg, x3, d3))
    ms = chip_smoke._cuda_ms
    print(f"{tag}: within tolerance {ok}, max |err| {err.max().item():.3g}, "
          f"equals K1 at t = 0 {eq}; {m} random samples full "
          f"{ms(lambda: dyn_field_forward(tables, cfg, x3, d3, 0.37), 20):.3f}"
          f" ms, density only "
          f"{ms(lambda: dyn_field_forward(tables, cfg, x3, None, 0.37, density_only=True), 20):.3f}"
          f" ms; {xc3.shape[1]} coherent samples full "
          f"{ms(lambda: dyn_field_forward(tables, cfg, xc3, dc3, 0.37), 5):.3f}"
          f" ms, K1 on them "
          f"{ms(lambda: field_forward(tables, cfg, xc3, dc3), 5):.3f} ms",
          flush=True)
    cfg2 = CPDNeRFConfig(num_layers_deform=2)
    tables2 = pack_tables(chip_smoke._dyn_seeded_params(0, cfg2, "cuda"),
                          cfg2)
    print(f"{tag}, 2 deform matrices: {m} random samples full "
          f"{ms(lambda: dyn_field_forward(tables2, cfg2, x3, d3, 0.37), 20):.3f}"
          f" ms; {xc3.shape[1]} coherent samples full "
          f"{ms(lambda: dyn_field_forward(tables2, cfg2, xc3, dc3, 0.37), 5):.3f}"
          f" ms", flush=True)


if __name__ == "__main__":
    main()
