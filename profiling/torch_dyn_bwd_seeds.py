"""How far the dynamic backward kernel (K4) lies from its plain version
over several seeds, sample counts and tower depths, and why: the data behind
the tolerances of chip_smoke.py's phase 3d and of tests/test_torch_card.py.

    python3 profiling/torch_dyn_bwd_seeds.py [--seeds 4 5 6]

For the full default CPDNeRFConfig with the undamped tower (chip_smoke.py's
_dyn_seeded_params, gain 1; warp 6e-4) of eight and of two matrices (no
hidden one; warp 0.11) and with the re-gained tower of eight (warp 0.1), at
8,229 and 262,181 samples, a third of the
cotangents zero, t = 0.37, it prints per seed, one line a case:

- the warp and how far the kernel's warped positions lie from the plain ones;
- the worst leaf of each group end to end, relative to the leaf's max
  |plain|, and the same for each deform matrix;
- the activations that the kernel's tower backward recomputed against the
  plain chain's: the share of entries that differ at all, the share whose
  relu mask differs (zero on one side only), and the share of samples with
  any such mask;
- the tower's backward alone, on the kernel's own position gradient, three
  ways: the kernel against the plain stage on the plain activations; the
  kernel against the plain stage on the KERNEL's activations (what is left is
  the backward's own arithmetic: the input gradients and the outer products),
  with the first matrix's time rows apart: they are rounded to bf16 after the
  sum over all samples, so one rounding that differs moves them by 2^-8;
  and the plain stage on the one set of activations against itself on the
  other (the activations' share alone, no kernel arithmetic in it);
- the same plain chain with f64 sums (bf16 operands and rounding points
  kept) against the f32 one and against the kernel: how far two plain
  versions lie apart that differ in nothing but the order and width of their
  sums;
- a second run of the kernel against the first (the atomics' reordering);
- how heavy the tail of the position gradient is (max |g_x| over its rms, and
  the share of sum |g_x| that the 16 largest samples carry): the sigma
  cotangent enters through exp(h), so a few samples can carry a leaf's
  largest entries, and one bf16 rounding that differs on such a sample moves
  the entry by 2^-8 of itself however many samples there are. The first seed
  is therefore run once more with the sigma cotangent zero (colour cotangents
  alone, through the sigmoid: no such tail).
"""

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sealdnerf_tpu_torch.models.cp import CPDNeRFConfig  # noqa: E402
from sealdnerf_tpu_torch.ops.field import (  # noqa: E402
    _time_cond_vec, bf16_round, dyn_field_backward, dyn_field_backward_plain, dyn_tower_backward_plain,
    dyn_warp_plain, freq_encode, pack_tables)


def tower_stage_f64(tables, cfg, x3, t, g_x):
    """dyn_warp_plain's activations and dyn_tower_backward_plain's grads
    with every product summed in f64: the same bf16 operands and rounding
    points."""
    def r(v):
        return bf16_round(v.float()).double()
    wd = [w.double() for w in tables.plain["deform_mlp"]["w"]]
    tb, _, tvec = _time_cond_vec(tables, cfg, t, x3.device)
    nx = cfg.deform_space_dim
    acts = [bf16_round(freq_encode(x3.t(), degree=cfg.multires_deform))
            .double()]
    h = acts[0] @ wd[0][:nx] + tb.double()
    for w in wd[1:-1]:
        acts.append(r(torch.relu(h)))
        h = acts[-1] @ w
    acts.append(r(torch.relu(h)))
    gd = [None] * len(wd)
    g_h = g_x.t().double()
    for li in range(len(wd) - 1, 0, -1):
        gb = r(g_h)
        gd[li] = (acts[li].t() @ gb).float()
        g_h = (gb @ wd[li].t()) * (acts[li] > 0)
    gd[0] = torch.cat([
        (acts[0].t() @ r(g_h)).float(),
        bf16_round(tvec)[:, None] * bf16_round(g_h.sum(dim=0).float())[None]])
    return {"w": gd}, [a.float() for a in acts]


def act_stats(a_k, a_p):
    """Shares of entries that differ, of entries whose relu mask differs, and
    of samples with any such mask, over the hidden activations."""
    diff = mask = n = 0
    bad = torch.zeros(a_k[0].shape[0], dtype=torch.bool, device=a_k[0].device)
    for k, p in zip(a_k[1:], a_p[1:]):
        flips = (k > 0) != (p > 0)
        diff += int((k != p).sum())
        mask += int(flips.sum())
        bad |= flips.any(dim=1)
        n += k.numel()
    return diff / n, mask / n, bad.float().mean().item()


def samples(m, seed, sigma_cotangent=True):
    rng = np.random.default_rng(seed)
    x3 = rng.uniform(-1, 1, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    g[:, ::3] = 0.0
    if not sigma_cotangent:
        g[0] = 0.0
    return [torch.from_numpy(a).cuda() for a in (x3, d3, g)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[4, 5, 6])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    fmt = lambda r: " ".join(f"{k} {v:.3g}" for k, v in r.items())
    for layers, gain in ((8, 1.0), (2, 1.0), (8, chip_smoke.DEFORM_GAIN)):
        cfg = CPDNeRFConfig(num_layers_deform=layers)
        tables = pack_tables(
            chip_smoke._dyn_seeded_params(0, cfg, "cuda", gain=gain), cfg)
        for m in (8192 + 37, 4096 * 64 + 37):
            for seed, sigma_cot in [(q, True) for q in args.seeds] \
                    + [(args.seeds[0], False)]:
                x3, d3, g = samples(m, seed, sigma_cot)
                parts = {}
                got = dyn_field_backward(tables, cfg, x3, d3, 0.37, g,
                                         parts=parts)
                ref = dyn_field_backward_plain(tables, cfg, x3, d3, 0.37, g)
                xw, acts_p = dyn_warp_plain(tables, cfg, x3, 0.37)
                whole, _ = chip_smoke._grad_errs(got, ref)
                leaves = [((a - b).abs().max() / b.abs().max()).item()
                          for a, b in zip(got["deform_mlp"]["w"],
                                          ref["deform_mlp"]["w"])]
                live = parts["live"]
                # the kernel warps the samples with a cotangent only
                dxw = (parts["xw"] - xw).abs()[:, live]
                g_x = parts["g_x"][:, live]
                acts_p = [a[live] for a in acts_p]
                mag = g_x.abs().amax(dim=0)
                heavy = (mag.max() / g_x.square().mean().sqrt()).item()
                top16 = (mag.topk(16).values.sum() / mag.sum()).item()
                acts_k = [a.float() for a in parts["acts"]]
                ex_diff = (acts_k[0] != acts_p[0]).float().mean().item()
                differ, masks, flipped = act_stats(acts_k, acts_p)

                def err(a, b):
                    return chip_smoke._grad_errs({"deform_mlp": a},
                                                 {"deform_mlp": b})[0]["deform"]

                def split(a):
                    """The first matrix's time rows apart from the rest."""
                    nx = cfg.deform_space_dim
                    return ({"w": [a["w"][0][:nx]] + list(a["w"][1:])},
                            {"w": [a["w"][0][nx:]]})
                kern = got["deform_mlp"]
                on_p = dyn_tower_backward_plain(tables, cfg, 0.37, acts_p, g_x)
                on_k = dyn_tower_backward_plain(tables, cfg, 0.37, acts_k, g_x)
                f64, acts_64 = tower_stage_f64(tables, cfg, x3[:, live], 0.37,
                                               g_x)
                d64, m64, s64 = act_stats(acts_64, acts_p)
                again, _ = chip_smoke._grad_errs(
                    dyn_field_backward(tables, cfg, x3, d3, 0.37, g), got)
                print(f"{layers} deform matrices, gain {gain:.3g}, M {m}, "
                      f"seed {seed}, {'all' if sigma_cot else 'colour'} "
                      f"cotangents: |g_x| max / rms {heavy:.3g}, share of "
                      f"the 16 largest samples {top16:.3g}; warp "
                      f"{(xw - x3).abs().mean().item():.3g}, positions "
                      f"kernel vs plain mean {dxw.mean().item():.3g} max "
                      f"{dxw.max().item():.3g}; end to end {fmt(whole)}; "
                      "deform matrices "
                      + " ".join(f"{v:.3g}" for v in leaves)
                      + f"; activations kernel vs plain: ex differs "
                      f"{ex_diff:.3g}, hidden differ {differ:.3g}, relu masks "
                      f"differ {masks:.3g}, samples with such a mask "
                      f"{flipped:.3g}; tower stage: kernel vs plain on plain "
                      f"activations {err(kern, on_p):.3g}, kernel vs plain on "
                      f"the kernel's activations {err(kern, on_k):.3g} (time "
                      f"rows {err(split(kern)[1], split(on_k)[1]):.3g}, all "
                      f"else {err(split(kern)[0], split(on_k)[0]):.3g}), plain "
                      f"on the kernel's vs plain on plain activations "
                      f"{err(on_k, on_p):.3g}; f64 sums: activations vs f32 "
                      f"plain differ {d64:.3g}, masks {m64:.3g}, samples "
                      f"{s64:.3g}; grads f32 plain vs f64 "
                      f"{err(on_p, f64):.3g}, kernel vs f64 "
                      f"{err(kern, f64):.3g}; second run vs first "
                      f"{fmt(again)}", flush=True)


if __name__ == "__main__":
    main()
