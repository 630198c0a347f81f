"""How wide must fragile_samples_plain's margins be? On an H100:

    python3 profiling/torch_fragile_margin.py

The backward kernels recompute the forward with the forward kernels' own
arithmetic, whose f32 sums run in the mma's order; the plain version sums in
a matmul's. At a few in ten thousand samples a relu's pre-activation lands on
the other side of 0, and such a sample's whole share of a gradient differs.
fragile_samples_plain names the samples at which that can happen from the
plain version alone, given two margins (ops/field.py: SUM_NOISE, FREQ_NOISE).

For a grid of margins this prints the share of the samples in the set and
K2's distance from its plain version (worst leaf, relative to max |plain|)
with the set's cotangents zeroed on both sides, beside the distance over all
samples. Where the set misses a sample whose mask flipped, the distance
stays near that over all samples; where it holds them all it falls to what
rounding alone leaves. Random positions, directions and cotangents, several
seeds and configs.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from sealdnerf_tpu_torch.models.cp import (CPConfig, init_cp,  # noqa: E402
                                           param_leaves)
from sealdnerf_tpu_torch.ops.field import (FREQ_NOISE, SUM_NOISE,  # noqa: E402
                                           field_backward,
                                           field_backward_plain,
                                           fragile_samples_plain, pack_tables)

CONFIGS = {
    "default": CPConfig(),
    "ranks (4, 20), 4 plane channels": CPConfig(
        scales=((32, 4), (128, 20)), planes=((128, 4),)),
}


def worst_leaf(got, ref):
    return max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
               for a, b in zip(param_leaves(got), param_leaves(ref)))


def run(name, cfg, m, seed):
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg,
                                 "cuda"), cfg)
    rng = np.random.default_rng(seed)
    x3 = rng.uniform(-1, 1, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    x3, d3, g = (torch.from_numpy(a).cuda() for a in (x3, d3, g))
    whole = worst_leaf(field_backward(tables, cfg, x3, d3, g),
                       field_backward_plain(tables, cfg, x3, d3, g))
    print(f"{name}, M={m}, seed {seed}: all samples {whole:.3g}", flush=True)
    for e in (-25, -23, -22, -21, -20):
        for f in (-23, -21, -20, -19):
            fragile = fragile_samples_plain(tables, cfg, x3.t(), d3.t(),
                                            2.0 ** e, 2.0 ** f)
            g2 = g.clone()
            g2[:, fragile] = 0.0
            held = worst_leaf(field_backward(tables, cfg, x3, d3, g2),
                              field_backward_plain(tables, cfg, x3, d3, g2))
            mark = " (the defaults)" if (2.0 ** e, 2.0 ** f) == (
                SUM_NOISE, FREQ_NOISE) else ""
            print(f"  sums 2^{e}, frequency features 2^{f}: "
                  f"{fragile.float().mean().item():.4f} of the samples in "
                  f"the set, the others {held:.3g}{mark}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for seed in (1, 7, 11):
        run("default", CONFIGS["default"], 4096 * 64 + 37, seed)
    for name, cfg in CONFIGS.items():
        run(name, cfg, 4096 * 4 + 5, 4)


if __name__ == "__main__":
    main()
