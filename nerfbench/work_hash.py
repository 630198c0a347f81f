"""The work of K5, the Instant-NGP hash-grid field's forward, and the least
time the card needs for it, in work.py's conventions: each input byte read
once and each output byte written once, the table and the tower weights
once a call (bf16), the towers' products on the tensor cores (bf16 x bf16
-> f32), and on the FP32 pipe everything else: the encoding's position,
index and hash arithmetic, the trilinear weights and taps, the SH basis and
the activations. Computed from the configuration file's widths.

Per level and sample (the FP32 pipe): 6 for the position (a multiply and
an add an axis), 6 for the cell and the fractions, 3 for the fractions'
complements, 16 for the 8 corners' weights (two products each), 64 for the
8 corners' indices (the corner's three coordinates, then the hash's two
products, two xors and the mask, or the tiled index's two products, two adds
and the wrap), 8 for their addresses and 32 for the taps (a multiply and an
add per corner and feature). Per sample: 12 for the unit cube and its
bounds check, 1 for the density's exp; with colour 60 for SH(4) and 3 for
each sigmoid.
"""

from nerfbench.reference import ngp_field as nf
from nerfbench.work import PEAK

FP32_PER_LEVEL = 6 + 6 + 3 + 16 + 64 + 8 + 32
FP32_SAMPLE, FP32_COLOUR = 12 + 1, 60 + 3 * 3


def tower_dims(cfg: dict):
    """(sigma tower, colour tower) layer widths of an NGP configuration."""
    sigma = [cfg["num_levels"] * cfg["level_dim"]] \
        + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1) \
        + [1 + cfg["geo_feat_dim"]]
    color = [cfg["sh_degree"] ** 2 + cfg["geo_feat_dim"]] \
        + [cfg["hidden_dim_color"]] * (cfg["num_layers_color"] - 1) + [3]
    return sigma, color


def _macs(dims):
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def hash_work(cfg: dict, calls: int, samples: int, density_samples: int = 0):
    """(bytes, tensor-core flops, FP32-pipe flops) of `calls` K5 calls on
    `samples` samples in all, `density_samples` of them in density-only
    calls (no direction read, no colour tower, one output row of meaning;
    the kernel writes all four rows)."""
    sigma, color = tower_dims(cfg)
    full = samples - density_samples
    tab = nf.table_rows(cfg) * cfg["level_dim"]
    nbytes = samples * (12 + 16) + full * 12 \
        + calls * 2 * (tab + _macs(sigma) + _macs(color))
    tensor = 2 * (_macs(sigma) * samples + _macs(color) * full)
    fp32 = (cfg["num_levels"] * FP32_PER_LEVEL + FP32_SAMPLE) * samples \
        + FP32_COLOUR * full
    return nbytes, tensor, fp32


def op_seconds(cfg: dict, calls: int, samples: int,
               density_samples: int = 0) -> float:
    """The operations' least time: tensor flops at the tensor-core peak
    plus FP32 flops at the FP32 peak (the numerator of mfu_hash)."""
    _, tensor, fp32 = hash_work(cfg, calls, samples, density_samples)
    return tensor / PEAK["tensor_flops"] + fp32 / PEAK["fp32_flops"]


def bound_seconds(cfg: dict, calls: int, samples: int,
                  density_samples: int = 0) -> float:
    """The least time of the calls: the larger of their bytes at the HBM
    peak and their operations at their peaks (K5's roofline). Over several
    calls it is taken on their sums, which is at most the sum of each
    call's."""
    nbytes, _, _ = hash_work(cfg, calls, samples, density_samples)
    return max(nbytes / PEAK["bytes"],
               op_seconds(cfg, calls, samples, density_samples))
