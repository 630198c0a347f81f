"""Plain reference of the CP radiance field and of its time-conditioned
variant (CP-D-NeRF), in float32 with TF32 off.

A frozen copy of the field's published equations as the program states
them, written from them and importing nothing of the program:

  per line scale s:  f_a = lerp(line[s][a], x_a)              [S, R_s]
                     feat_s = f_x * f_y * f_z
  per plane scale:   plane_p(x_a, x_b) * vm_line_p(x_e)        [S, 3 C]
  feat = feat_s ++ plane features ++ freq(x, F)
  sigma tower: feat -> hidden -> 1 + geo (relu between, no bias)
  sigma = exp(h_0) (its gradient taken at clamp(h_0, -15, 15))
  colour tower: SH(d) ++ geo -> hidden -> ... -> 3, sigmoid

The dynamic field puts the D-NeRF deform tower in front of it: freq(x, 10)
++ freq(t, 6) -> 128 x 7 -> dx, gated to 0 at t == 0, and the canonical
field is read at x + dx; the warp's gradient reaches only the scales and
planes of resolution <= deform_grad_res_cutoff and the frequency features.

`q` is applied at every point where a low-precision implementation rounds
(tables, interpolation weights, features, weights and hidden activations):
`exact` for the reference itself, `fp8` for the control, which computes the
same field with those operands in float8 e4m3 and carries the gradient
straight through the rounding, and `bf16` for the scale of a frame's
sensitivity to rounding at the configuration's precision.
"""

import math

import torch

VM_PAIRS = ((0, 1, 2), (0, 2, 1), (1, 2, 0))
FP8_MAX = 448.0


def exact(t):
    return t


def fp8(t):
    """t rounded to float8 e4m3 (saturating at +-448); the gradient passes
    through unchanged."""
    r = t.detach().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
    return t + (r - t.detach())


def bf16(t):
    """t rounded to bfloat16; the gradient passes through unchanged."""
    return t + (t.detach().to(torch.bfloat16).float() - t.detach())


class _ExpClampedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def freq(x, degree: int):
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(F-1) x), cos(2^(F-1) x)]."""
    outs = [x]
    for f in range(degree):
        xf = x * (2.0 ** f)
        outs += [torch.sin(xf), torch.cos(xf)]
    return torch.cat(outs, dim=-1)


def _double_factorial(n: int) -> int:
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


def sh(d, degree: int):
    """Real spherical harmonics of unit directions [..., 3] -> [...,
    degree^2]: l = 0..degree-1, m = -l..l, Condon-Shortley phase."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    c, s = [torch.ones_like(x)], [torch.zeros_like(x)]
    for m in range(1, degree):
        c.append(x * c[m - 1] - y * s[m - 1])
        s.append(x * s[m - 1] + y * c[m - 1])
    p = {}
    for m in range(degree):
        p[(m, m)] = torch.full_like(z, (-1.0) ** m * _double_factorial(2 * m - 1))
        if m + 1 < degree:
            p[(m + 1, m)] = (2 * m + 1) * z * p[(m, m)]
        for l in range(m + 2, degree):
            p[(l, m)] = ((2 * l - 1) * z * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)

    def k(l, m):
        return math.sqrt((2 * l + 1) / (4.0 * math.pi)
                         * math.factorial(l - m) / math.factorial(l + m))
    out = []
    for l in range(degree):
        for m in range(-l, l + 1):
            a = abs(m)
            if m == 0:
                out.append(k(l, 0) * p[(l, 0)])
            else:
                out.append(math.sqrt(2.0) * k(l, a) * p[(l, a)]
                           * (c[a] if m > 0 else s[a]))
    return torch.stack(out, dim=-1)


def _taps(x01, res: int, q):
    """The two linear-interpolation taps of a table of `res` rows at x01
    (clipped to [0, 1]) -> (i0, w0, w1)."""
    xa = x01.clamp(0.0, 1.0) * (res - 1)
    i0 = torch.floor(xa).clamp(max=res - 2).detach()
    w0 = q((1.0 - (xa - i0).abs()).clamp(min=0.0))
    w1 = q((1.0 - (xa - (i0 + 1.0)).abs()).clamp(min=0.0))
    return i0.long(), w0, w1


def _line(x01, table, q):
    i0, w0, w1 = _taps(x01, table.shape[0], q)
    t = q(table)
    return w0[:, None] * t[i0] + w1[:, None] * t[i0 + 1]


def _plane(plane, xa, xb, q):
    pres = plane.shape[0]
    ia, ua0, ua1 = _taps(xa, pres, q)
    ib, ub0, ub1 = _taps(xb, pres, q)
    p = q(plane)
    q0 = ua0[:, None] * p[ia, ib] + ua1[:, None] * p[ia + 1, ib]
    q1 = ua0[:, None] * p[ia, ib + 1] + ua1[:, None] * p[ia + 1, ib + 1]
    return ub0[:, None] * q0 + ub1[:, None] * q1


def tower(ws, h, q):
    """Bias-free MLP, relu between the layers, operands through q."""
    for i, w in enumerate(ws):
        h = q(h) @ q(w)
        if i != len(ws) - 1:
            h = torch.relu(h)
    return h


def anneal(params, cfg: dict, ramp: float):
    """The sigma tower's first matrix with the rows of the line scales and
    planes finer than cfg["anneal_res"] scaled by `ramp` (coarse-to-fine);
    the params themselves at ramp 1."""
    if ramp >= 1.0:
        return params
    rows = []
    for res, rank in cfg["scales"]:
        rows += [res > cfg["anneal_res"]] * rank
    for pres, ch in cfg["planes"]:
        rows += [pres > cfg["anneal_res"]] * (3 * ch)
    rows += [False] * (3 + 6 * cfg["freq_degree"])
    w = params["sigma_mlp"]["w"]
    colw = torch.tensor([ramp if r else 1.0 for r in rows],
                        dtype=torch.float32, device=w[0].device)[:, None]
    out = dict(params)
    out["sigma_mlp"] = {"w": [w[0] * colw] + list(w[1:])}
    return out


def deform(params, cfg: dict, x, t, q, gate: bool = True):
    """The deform tower's warp dx [S, 3] at scalar time t (a float or a 0-d
    tensor); gate=True makes it 0 at t == 0."""
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(1, 1)
    et = freq(t, cfg["multires_time"]).expand(x.shape[0], -1)
    h = tower(params["deform_mlp"]["w"],
              torch.cat([freq(x, cfg["multires_deform"]), et], dim=-1), q)
    if gate:
        h = torch.where(t != 0.0, h, torch.zeros_like(h))
    return h


def density(params, cfg: dict, x, q, x_stop=None):
    """(sigma [S], geo [S, G]) of the canonical field at x [S, 3]. x_stop:
    the positions at which the scales finer than the warp's cutoff are read
    (x detached from the warp), None: x."""
    b = cfg["bound"]
    cut = cfg.get("deform_grad_res_cutoff", 1 << 30)
    x01 = (x + b) / (2.0 * b)
    x01s = x01 if x_stop is None else (x_stop + b) / (2.0 * b)
    feats = []
    for s, (res, _) in enumerate(cfg["scales"]):
        u = x01 if res <= cut else x01s
        prod = None
        for a in range(3):
            f = _line(u[:, a], params["lines"][s][a], q)
            prod = f if prod is None else prod * f
        feats.append(prod)
    for s, (pres, _) in enumerate(cfg["planes"]):
        u = x01 if pres <= cut else x01s
        for p, (a, bb, e) in enumerate(VM_PAIRS):
            feats.append(_plane(params["planes"][s][p], u[:, a], u[:, bb], q)
                         * _line(u[:, e], params["vm_lines"][s][p], q))
    grid = q(torch.cat(feats, dim=-1))
    feat = torch.cat([grid, freq(x, cfg["freq_degree"])], dim=-1)
    h = tower(params["sigma_mlp"]["w"], feat, q)
    return _ExpClampedGrad.apply(h[:, 0]), h[:, 1:]


def color(params, cfg: dict, d, geo, q):
    h = torch.cat([sh(d, cfg["sh_degree"]), geo], dim=-1)
    return torch.sigmoid(tower(params["color_mlp"]["w"], h, q))


def forward(params, cfg: dict, x, d, t=None, q=exact, density_only=False):
    """(sigma [S], rgb [S, 3] or None) at positions x and directions d
    [S, 3]; at time t for a dynamic field (cfg has "multires_deform")."""
    if "multires_deform" in cfg:
        dx = deform(params, cfg, x, t, q)
        xw = x + dx
        sigma, geo = density(params, cfg, xw, q, x_stop=x + dx.detach())
    else:
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
