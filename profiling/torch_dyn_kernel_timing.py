"""Times the forward field kernels, static (K1) and dynamic (K3), of the
tree in the current directory, and checks them against their plain versions.

    cd <tree> && python3 <path to>/profiling/torch_dyn_kernel_timing.py TAG

The package is imported from the current directory, so two checkouts with
two versions of ops/csrc/ can be compared inside one call on one card, in
turns (old, new, new, old): unpack the other tree with `git archive` into a
directory that .gitignore lists and run this script from each. The fields
and the samples come from the chip_smoke.py beside this script, whichever
tree is timed, so every tree sees the same inputs.

Shapes: 1,048,613 random samples (full, density-only, lod_skip=(3,)); the
2^20 density-only queries of one bin of a grid refresh, a slab in cell order;
the 8,388,608 ray-coherent samples of a 256x256 pinhole frame, 128 a ray.
Then two splits of the time: a density-only run with every line scale
skipped leaves the towers (and the planes' and frequency rows' features), so
its difference to a density-only run is the line features' gathers and
arithmetic; and K3 with a deform tower of two matrices (no hidden one)
instead of eight, whose difference is the cost of the six hidden layers.
"""

import importlib.util
import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from sealdnerf_tpu_torch.models.cp import CPDNeRFConfig  # noqa: E402
from sealdnerf_tpu_torch.ops.field import (dyn_field_forward,  # noqa: E402
                                           dyn_field_forward_plain,
                                           field_forward, field_forward_plain,
                                           pack_tables)


def _smoke_module():
    """chip_smoke.py of this script's tree (its package imports are made
    inside its functions, so they find the tree in the current directory)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_beside", os.path.join(here, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    smoke = _smoke_module()
    ms = smoke._cuda_ms
    cfg = CPDNeRFConfig()
    tables = pack_tables(smoke._dyn_seeded_params(0, cfg, "cuda"), cfg)
    rng = np.random.default_rng(0)
    m = (1 << 20) + 37
    x3 = torch.from_numpy(
        rng.uniform(-1, 1, (3, m)).astype(np.float32)).cuda()
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    d3 = torch.from_numpy(d3).cuda()
    xs3, _ = smoke._slab_samples()
    xc3, dc3 = smoke._frame_samples()

    def k1(x, d, **kw):
        return field_forward(tables, cfg, x, d, **kw)

    def k3(x, d, **kw):
        return dyn_field_forward(tables, cfg, x, d, 0.37, **kw)

    (rs, a_s), (rc, a_c) = smoke.TOL["sigma"], smoke.TOL["rgb"]
    for name, fn, plain in (
            ("K1", k1, lambda: field_forward_plain(tables, cfg, x3, d3)),
            ("K3", k3, lambda: dyn_field_forward_plain(tables, cfg, x3, d3,
                                                       0.37))):
        out, ref = fn(x3, d3), plain()
        err = (out - ref).abs()
        ok = bool((err[0] <= a_s + rs * ref[0].abs()).all()
                  and (err[1:] <= a_c + rc * ref[1:].abs()).all())
        print(f"{tag} {name}: within tolerance of plain {ok}, max |err| "
              f"{err.max().item():.3g}; {m} random samples: full "
              f"{ms(lambda: fn(x3, d3), 20):.3f} ms, density-only "
              f"{ms(lambda: fn(x3, None, density_only=True), 20):.3f} ms, "
              f"lod_skip=(3,) {ms(lambda: fn(x3, d3, lod_skip=(3,)), 20):.3f}"
              f" ms, density-only with every line scale skipped "
              f"{ms(lambda: fn(x3, None, density_only=True, lod_skip=(0, 1, 2, 3)), 20):.3f}"
              f" ms; {xs3.shape[1]} coherent slab queries, density-only "
              f"{ms(lambda: fn(xs3, None, density_only=True), 20):.3f} ms; "
              f"{xc3.shape[1]} frame-like samples, full "
              f"{ms(lambda: fn(xc3, dc3), 5):.3f} ms", flush=True)
    eq = torch.equal(dyn_field_forward(tables, cfg, x3, d3, 0.0),
                     field_forward(tables, cfg, x3, d3))
    cfg2 = CPDNeRFConfig(num_layers_deform=2)
    tables2 = pack_tables(smoke._dyn_seeded_params(0, cfg2, "cuda"), cfg2)
    print(f"{tag} K3 equals K1 at t = 0: {eq}; K3 with 2 deform matrices: "
          f"{m} random samples full "
          f"{ms(lambda: dyn_field_forward(tables2, cfg2, x3, d3, 0.37), 20):.3f}"
          f" ms; {xc3.shape[1]} frame-like samples full "
          f"{ms(lambda: dyn_field_forward(tables2, cfg2, xc3, dc3, 0.37), 5):.3f}"
          f" ms", flush=True)


if __name__ == "__main__":
    main()
