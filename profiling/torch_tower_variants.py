"""Where the deform tower kernels' time goes: builds copies of
sealdnerf_tpu_torch/ops/csrc with one change each, and times the tower's
device kernels of each copy on one card.

    python3 profiling/torch_tower_variants.py [VARIANT ...]

Variants (default: all):
  base        the sources as they are;
  two_groups  two consumer warpgroups a block instead of three (168
              registers a thread instead of 128);
  no_ex       ex without its sines and cosines (sin v, cos v -> v, v): what
              the encoding costs.
Each copy is built with the package's own build (ops/build.py) into
_build/variants/<name>/ under the package, then timed by torch.profiler
(chip_smoke._kernel_ms): deform_fwd_kernel on 2^20 random samples
(density-only, t held on the card) and K4's warp_kernel, tower_bwd_kernel
and tower_wgrad_kernel on chip_smoke.py phase 3d's 262,181 samples (183,223
with a cotangent) at t = 0.37; beside them each build's registers and
spills. The first line is the card's name and power limit.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from sealdnerf_tpu_torch.models.cp import CPDNeRFConfig  # noqa: E402
from sealdnerf_tpu_torch.ops import build, field  # noqa: E402

# (file, text, replacement) of each variant
VARIANTS = {
    "base": [],
    "two_groups": [("deform_tower.cuh", "constexpr int kConsumers = 3;",
                    "constexpr int kConsumers = 2;")],
    "no_ex": [("deform_tower.cuh", "sincosf(v, &s, &c);",
               "s = v;\n  c = v;")],
}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_beside", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _use_variant(name):
    """Point ops/build.py at a copy of csrc with the variant's edits (the
    caller restores build.SRC_DIR and build.BUILD_DIR)."""
    root = build.BUILD_DIR / "variants" / name
    src = root / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.SRC_DIR, src)
    for fname, old, new in VARIANTS[name]:
        p = src / fname
        text = p.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {fname} holds no {old!r}")
        p.write_text(text.replace(old, new, 1))
    build.SRC_DIR, build.BUILD_DIR = src, root / "build"
    build.load_library.cache_clear()
    lib = build.build()
    build.load_library()
    return [line.strip() for line in (lib.parent / "nvcc.log").read_text()
            .splitlines() if ": Used " in line or "spill stores" in line]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smoke = _smoke()
    print(smoke._card(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    cfg = CPDNeRFConfig()
    tables = field.pack_tables(smoke._dyn_seeded_params(0, cfg, "cuda"), cfg)
    t = torch.tensor(0.37, device="cuda")
    rng = np.random.default_rng(0)
    xf = torch.from_numpy(
        rng.uniform(-1, 1, (3, 1 << 20)).astype(np.float32)).cuda()
    m = 4096 * 64 + 37
    rng = np.random.default_rng(2)
    x3 = rng.uniform(-1.0, 1.0, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    g[:, rng.random(m) < 0.3] = 0.0
    x3, d3, g = (torch.from_numpy(a).cuda() for a in (x3, d3, g))
    src, dst = build.SRC_DIR, build.BUILD_DIR
    for name in names:
        try:
            regs = _use_variant(name)
            fwd = smoke._kernel_ms(lambda: field.dyn_field_forward(
                tables, cfg, xf, None, t, density_only=True), 10,
                ("deform_fwd_kernel",))
            bwd = smoke._kernel_ms(lambda: field.dyn_field_backward(
                tables, cfg, x3, d3, t, g), 10,
                ("warp_kernel", "tower_bwd_kernel", "tower_wgrad_kernel"))
        finally:
            build.SRC_DIR, build.BUILD_DIR = src, dst
            build.load_library.cache_clear()
        print(f"{name}: deform_fwd_kernel {fwd['deform_fwd_kernel']:.4f} ms "
              "(2^20 samples); " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in bwd.items())
              + " (183,223 listed); build: " + " | ".join(regs), flush=True)


if __name__ == "__main__":
    main()
