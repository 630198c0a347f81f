"""Times the field kernels of the tree in the current directory, the forward
ones (K1 static, K3 dynamic) or, with `bwd`, the backward ones (K2, K4), and
checks them against their plain versions.

    cd <tree> && python3 <path to>/profiling/torch_dyn_kernel_timing.py TAG [bwd]

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

With `bwd`: K2 and K4 (t = 0.37, and K4's canonical kernel alone at t = 0) on
a training step's 262,181 samples, random positions and the ray-coherent
samples of a 64x64 pinhole frame (the first 262,181 of 65 a ray), each with
every cotangent live and with 30 % of the columns zero (what the march
leaves empty); the worst gradient leaf against the plain version beside it.
Then K2 at the widest config the kernels take (16 k-blocks).

Both modes also time K3 (K4) with t held on the card, which spares the
call the host round trip of a float t (the trainers pass a tensor), and
split the entry into its device kernels by torch.profiler
(chip_smoke._kernel_ms): deform_fwd_kernel and field_fwd_kernel; K4's
compaction, warp, canonical, tower backward, weight-gradient and time-row
kernels (a name the tree lacks reads 0).
"""

import importlib.util
import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from sealdnerf_tpu_torch.models.cp import (CPConfig,  # noqa: E402
                                           CPDNeRFConfig, init_cp)
from sealdnerf_tpu_torch.ops.field import (dyn_field_backward,  # noqa: E402
                                           dyn_field_backward_plain,
                                           dyn_field_forward,
                                           dyn_field_forward_plain,
                                           field_backward,
                                           field_backward_plain,
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


def time_backward(tag, smoke):
    ms = smoke._cuda_ms
    cfg = CPDNeRFConfig()
    tables = pack_tables(smoke._dyn_seeded_params(0, cfg, "cuda", gain=1.0),
                         cfg)
    m = 4096 * 64 + 37
    rng = np.random.default_rng(1)
    xr = torch.from_numpy(
        rng.uniform(-1, 1, (3, m)).astype(np.float32)).cuda()
    dr = rng.normal(size=(3, m)).astype(np.float32)
    dr /= np.linalg.norm(dr, axis=0, keepdims=True)
    dr = torch.from_numpy(dr).cuda()
    xc, dc = (a[:, :m].contiguous()
              for a in smoke._frame_samples(res=64, n_steps=65))
    g_all = rng.normal(size=(4, m)).astype(np.float32)
    g_part = g_all.copy()
    g_part[:, rng.random(m) < 0.3] = 0.0
    t_dev = torch.tensor(0.37, device="cuda")
    for label, x3, d3 in (("random", xr, dr), ("ray-coherent", xc, dc)):
        for live, g in (("every cotangent live", g_all),
                        ("30 % of the cotangents zero", g_part)):
            g = torch.from_numpy(g).cuda()
            n_live = int((g.abs().amax(dim=0) > 0).sum())
            worst = {}
            for name, fn, plain in (
                    ("K2", lambda: field_backward(tables, cfg, x3, d3, g),
                     lambda: field_backward_plain(tables, cfg, x3, d3, g)),
                    ("K4", lambda: dyn_field_backward(tables, cfg, x3, d3,
                                                      0.37, g),
                     lambda: dyn_field_backward_plain(tables, cfg, x3, d3,
                                                      0.37, g))):
                ratios, _ = smoke._grad_errs(fn(), plain())
                worst[name] = max(ratios.values())
            print(f"{tag} backward, {m} {label} samples, {live} ({n_live}): "
                  f"K2 {ms(lambda: field_backward(tables, cfg, x3, d3, g), 10):.3f}"
                  f" ms, K4 at t = 0.37 "
                  f"{ms(lambda: dyn_field_backward(tables, cfg, x3, d3, 0.37, g), 10):.3f}"
                  f" ms, K4 at t = 0 "
                  f"{ms(lambda: dyn_field_backward(tables, cfg, x3, d3, 0.0, g), 10):.3f}"
                  f" ms; worst leaf against plain: K2 {worst['K2']:.3g}, K4 "
                  f"{worst['K4']:.3g}", flush=True)
            split = smoke._kernel_ms(
                lambda: dyn_field_backward(tables, cfg, x3, d3, 0.37, g), 10,
                ("compact_live_kernel", "warp_kernel", "field_bwd_kernel",
                 "tower_bwd_kernel", "tower_wgrad_kernel",
                 "time_rows_kernel"))
            print(f"{tag} backward, {label}, {live}: K4 with t on the card "
                  f"{ms(lambda: dyn_field_backward(tables, cfg, x3, d3, t_dev, g), 10):.3f}"
                  " ms; by device kernel " + ", ".join(
                      f"{k} {v:.4f} ms" for k, v in split.items()),
                  flush=True)
    # the widest config the kernels take, 16 k-blocks of feature columns
    wide = CPConfig(
        scales=CPConfig().scales + ((64, 32), (256, 64), (256, 64)),
        planes=CPConfig().planes + ((64, 8),))
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), wide,
                                 "cuda"), wide)
    g = torch.from_numpy(g_all).cuda()
    try:
        ratios, _ = smoke._grad_errs(
            field_backward(tables, wide, xr, dr, g),
            field_backward_plain(tables, wide, xr, dr, g))
    except NotImplementedError as e:
        print(f"{tag} backward, 16 k-blocks: refused ({e})", flush=True)
        return
    print(f"{tag} backward, 16 k-blocks (feat_dim {wide.feat_dim}), {m} "
          f"random samples, every cotangent live: K2 "
          f"{ms(lambda: field_backward(tables, wide, xr, dr, g), 10):.3f} ms, "
          f"K1 {ms(lambda: field_forward(tables, wide, xr, dr), 10):.3f} ms; "
          f"worst leaf against plain {max(ratios.values()):.3g}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    smoke = _smoke_module()
    if sys.argv[2:] == ["bwd"]:
        return time_backward(tag, smoke)
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
    t_dev = torch.tensor(0.37, device="cuda")
    split = smoke._kernel_ms(lambda: k3(x3, d3), 10,
                             ("deform_fwd_kernel", "field_fwd_kernel"))
    print(f"{tag} K3, {m} random samples, t on the card: full "
          f"{ms(lambda: dyn_field_forward(tables, cfg, x3, d3, t_dev), 20):.3f}"
          " ms; by device kernel " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in split.items()), flush=True)
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
