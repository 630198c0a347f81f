"""Plain reference of the Instant-NGP field (Mueller et al. 2022,
arXiv:2201.05989, section 5.4), as torch-ngp builds it in nerf/network.py
and gridencoder/src/gridencoder.cu, in float32 with TF32 off.

Written from the paper and torch-ngp, importing nothing of the program:

  x01 = (x + bound) / (2 bound); outside [0, 1]^3 every feature is 0
  per level l of L: scale_l = 2^(l log2 b) N_min - 1, b = (N_max /
    N_min)^(1 / (L - 1)), N_max = desired_resolution; the level's grid
    resolution r_l = ceil(scale_l) + 1 and rows T_l = min(T, (ceil(N_min
    b^l) + 1)^3) rounded up to a multiple of 8, the levels' tables one
    after the other;
    pos = x01 scale_l + 0.5, cell = floor(pos), frac = pos - cell;
    corner c (bit a of c on axis a) read at the tiled index x + (r_l + 1) y
    + (r_l + 1)^2 z while (r_l + 1)^3 <= T_l, else at the spatial hash
    x ^ 2654435761 y ^ 805459861 z, both in 32 bits, modulo T_l;
    feat_l = sum_c (w_x w_y w_z)(c) table[corner c]       [S, 2]
  feat = feat_0 ++ ... ++ feat_{L-1}                         [S, 2 L]
  sigma tower: feat -> 64 -> 1 + 15 (relu between, no bias)
  sigma = trunc_exp(h_0): exp, its gradient taken at clamp(h_0, -15, 15)
  colour tower: SH(d, degree 4) ++ geo (15) -> 64 -> 64 -> 3, sigmoid

Departures from torch-ngp, each also the program's: the level scales are
computed once on the host in double and rounded to float32 (torch-ngp
computes exp2f on the device in float32, which may differ in the last bit);
the towers and the SH basis are those of reference/field.py (the same
equations: bias-free towers, real SH with the Condon-Shortley phase); the
seeded weights are the program's (this module takes them as given).

`q` is applied where a low-precision implementation rounds: the table, the
encoded features and every tower operand and hidden activation (the
quantisers of reference/field.py: `exact`, `bf16`, `fp8`).
"""

import math

import torch

from .field import _ExpClampedGrad, bf16, exact, fp8, sh, tower  # noqa: F401

PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF


def levels(cfg: dict):
    """Per level (scale, tiled stride or None where the level hashes, rows,
    first row): the layout of the table [rows of all levels, level_dim]."""
    if cfg.get("gridtype", "hash") != "hash":
        raise NotImplementedError("the reference holds the hash grid only")
    n_lv, n_min = cfg["num_levels"], cfg["base_resolution"]
    b = math.exp2(math.log2(cfg["desired_resolution"] / n_min) / (n_lv - 1))
    cap = 2 ** cfg["log2_hashmap_size"]
    out, off = [], 0
    for lvl in range(n_lv):
        scale = math.exp2(lvl * math.log2(b)) * n_min - 1.0
        r = int(math.ceil(scale)) + 1
        rows = min(cap, (int(math.ceil(n_min * b ** lvl)) + 1) ** 3)
        rows = int(math.ceil(rows / 8) * 8)
        tiled = (r + 1) ** 3 <= rows
        out.append((scale, r + 1 if tiled else None, rows, off))
        off += rows
    return out


def table_rows(cfg: dict) -> int:
    _, _, rows, off = levels(cfg)[-1]
    return off + rows


def _corner_index(cell, stride, rows: int):
    """Rows (within the level) of the 8 corners of cells [S, 3] -> [S, 8]."""
    out = []
    for c in range(8):
        p = [cell[:, a] + ((c >> a) & 1) for a in range(3)]
        if stride is None:
            h = p[0] * PRIMES[0]
            for a in (1, 2):
                h = h ^ ((p[a] * PRIMES[a]) & U32)
        else:
            h = (p[0] + p[1] * stride + p[2] * stride * stride) & U32
        out.append(h % rows)
    return torch.stack(out, -1)


def encode(params, cfg: dict, x01, q=exact):
    """The multiresolution encoding of x01 [S, 3] -> [S, 2 L] (zeros for a
    point outside the unit cube)."""
    table = q(params["grid"])
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(-1)
    feats = []
    for scale, stride, rows, off in levels(cfg):
        pos = x01 * scale + 0.5           # the scale enters in float32
        pf = torch.floor(pos)
        frac = pos - pf
        cell = pf.clamp(min=0.0).long()   # >= 0 where it counts (inside)
        idx = _corner_index(cell, stride, rows) + off          # [S, 8]
        ws = []
        for c in range(8):
            wc = None
            for a in range(3):
                f = frac[:, a] if (c >> a) & 1 else 1.0 - frac[:, a]
                wc = f if wc is None else wc * f
            ws.append(wc)
        w = torch.stack(ws, -1)
        feats.append((w[..., None] * table[idx]).sum(1))
    feat = torch.cat(feats, -1)
    return torch.where(oob[:, None], torch.zeros_like(feat), feat)


def density(params, cfg: dict, x, q=exact):
    """(sigma [S], geo [S, 15]) at positions x [S, 3]."""
    b = cfg["bound"]
    feat = encode(params, cfg, (x + b) / (2.0 * b), q)
    h = tower(params["sigma_mlp"]["w"], feat, q)
    return _ExpClampedGrad.apply(h[:, 0]), h[:, 1:]


def color(params, cfg: dict, d, geo, q=exact):
    h = torch.cat([sh(d, cfg["sh_degree"]), geo], dim=-1)
    return torch.sigmoid(tower(params["color_mlp"]["w"], h, q))


def forward(params, cfg: dict, x, d, t=None, q=exact, density_only=False):
    """(sigma [S], rgb [S, 3] or None) at positions x and directions d
    [S, 3]; t is unused (the field is static). Its matrix products run in
    float32: TF32 is turned off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sigma, geo = density(params, cfg, x, q)
    if density_only:
        return sigma, None
    return sigma, color(params, cfg, d, geo, q)


def forward_chunked(params, cfg: dict, x, d, t=None, q=exact,
                    density_only=False, chunk: int = 1 << 19):
    """forward() without gradient, in chunks of `chunk` samples."""
    sig, rgb = [], []
    with torch.no_grad():
        for i in range(0, x.shape[0], chunk):
            s, c = forward(params, cfg, x[i:i + chunk],
                           None if d is None else d[i:i + chunk], t, q,
                           density_only)
            sig.append(s)
            rgb.append(c)
    return torch.cat(sig), (None if density_only else torch.cat(rgb))
