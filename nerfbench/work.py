"""The work of one field call, and the least time the card needs for it.

A frozen copy of the program's roofline arithmetic (chip_smoke.py's
`_field_work`, `PEAK` and `_bound`), computed here from the configuration
file's widths. It counts the work that the layer is given, however it is
implemented: each input byte read once and each output byte written once,
the towers' products on the tensor cores (bf16 x bf16 -> f32), the taps,
encodings and activations on the FP32 pipe.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit.
"""

PEAK = {"tensor_flops": 989e12, "fp32_flops": 67e12, "bytes": 3.35e12}


def tower_dims(cfg: dict):
    """(sigma tower, colour tower) layer widths of a field configuration."""
    feat = sum(r for _, r in cfg["scales"]) \
        + sum(3 * c for _, c in cfg["planes"]) + 3 + 6 * cfg["freq_degree"]
    sigma = [feat] + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1) \
        + [1 + cfg["geo_feat_dim"]]
    color = [cfg["sh_degree"] ** 2 + cfg["geo_feat_dim"]] \
        + [cfg["hidden_dim_color"]] * (cfg["num_layers_color"] - 1) + [3]
    return sigma, color


def deform_dims(cfg: dict):
    nx = 3 + 6 * cfg["multires_deform"]
    return [nx + 1 + 2 * cfg["multires_time"]] \
        + [cfg["hidden_dim_deform"]] * (cfg["num_layers_deform"] - 1) + [3]


def field_work(cfg: dict, m: int, mode: str = "fwd",
               density_only: bool = False, m_live=None, lod_skip=()):
    """(bytes, tensor-core flops, FP32-pipe flops) of one field call on m
    samples. mode: "fwd" (K1), "bwd" (K2: recompute, then the input and
    weight gradients of every product), "dyn" (K3) or "dyn_bwd" (K4: K2's
    work plus the deform tower's recompute, input and weight gradients).
    m_live: the samples whose cotangent is not all zero, which alone cost
    a backward operations (default: all). lod_skip: line scales whose
    features are zero, which need no taps and no rows of the first
    matrix."""
    sigma, color = tower_dims(cfg)
    scales = [tuple(s) for s in cfg["scales"]]
    ranks = sum(r for s, (_, r) in enumerate(scales) if s not in lod_skip)
    skipped = sum(r for _, r in scales) - ranks
    towers = [sigma] if density_only else [sigma, color]
    macs = sum(a * b for dims in towers for a, b in zip(dims[:-1], dims[1:])) \
        - skipped * sigma[1]
    # gathers: per line rank 3 lerps (3 flops each) and 2 products; per plane
    # channel and pair two 2-tap rows, the cross lerp, the line lerp, 1 product
    taps = 11 * ranks + 13 * sum(3 * c for _, c in cfg["planes"])
    enc = 2 * 6 * cfg["freq_degree"] + (0 if density_only else 60)
    tab_elems = sum(3 * res * r for res, r in scales) + sum(
        3 * (p * p * c + p * c) for p, c in cfg["planes"])
    w_elems = sum(a * b for dims in (sigma, color)
                  for a, b in zip(dims[:-1], dims[1:]))
    nbytes = m * (12 + (0 if density_only else 12) + 16) \
        + 2 * (tab_elems + w_elems)
    tensor, fp32 = 2 * macs * m, (taps + enc) * m
    live = m if m_live is None else m_live
    if mode in ("bwd", "dyn_bwd"):
        tensor, fp32 = 3 * 2 * macs * live, 3 * (taps + enc) * live
        nbytes += m * 16 + 4 * (tab_elems + w_elems)      # g_out in, grads out
    if mode in ("dyn", "dyn_bwd"):
        dd = deform_dims(cfg)
        nx = 3 + 6 * cfg["multires_deform"]
        dmacs = nx * dd[1] + sum(a * b for a, b in zip(dd[1:-1], dd[2:]))
        d_elems = dmacs + (dd[0] - nx) * dd[1]
        if mode == "dyn":
            tensor += 2 * dmacs * m
            fp32 += 2 * 6 * cfg["multires_deform"] * m
            nbytes += 2 * d_elems
        else:
            # the warp's recompute, dX and dW, each of the live samples only
            tensor += 2 * dmacs * 3 * live
            fp32 += 2 * 6 * cfg["multires_deform"] * 2 * live
            nbytes += (2 + 4) * d_elems
    return nbytes, tensor, fp32


def op_seconds(cfg: dict, m: int, **kw) -> float:
    """The operations' least time: tensor flops at the tensor-core peak
    plus FP32 flops at the FP32 peak (the numerator of mfu)."""
    _, tensor, fp32 = field_work(cfg, m, **kw)
    return tensor / PEAK["tensor_flops"] + fp32 / PEAK["fp32_flops"]


def bound_seconds(cfg: dict, m: int, **kw) -> float:
    """The least time of the call: the larger of its bytes at the HBM peak
    and its operations at their peaks (a kernel's roofline)."""
    nbytes, _, _ = field_work(cfg, m, **kw)
    return max(nbytes / PEAK["bytes"], op_seconds(cfg, m, **kw))
