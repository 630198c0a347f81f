"""Plain reference of the training step: the photometric loss of a ray
batch through the dense march and the field, the deform regulariser of a
dynamic field, the coarse-to-fine ramp, Adam (betas 0.9 / 0.99, eps
1e-15, the rate lr * 0.1^min(k / iters, 1), one rate for the tables and
one for the towers where the configuration gives two) and the EMA of the
parameters (decay 0.95), in float32 with TF32 off.

`follow` runs the steps from given parameters on the batches and
occupancies that the program drew and marched, and returns what the
comparison reads: each step's loss, the first step's gradient, and the
parameters and their EMA after the last step. It starts from step 0 with
Adam's moments at 0 and the EMA at the parameters, or from step `step0`
with the moments and the EMA that `state` holds.
"""

import torch

from . import field as rf
from . import render as rr


def leaves(tree):
    """Leaves of a params tree: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, it) for v in tree]
    return next(it)


def step_loss(params, cfg: dict, mc: dict, opt: dict, batch: dict, occ_m,
              step: int, q):
    """The loss of one step on `batch` (rays_o, rays_d, gt, bg, noise, and
    t and x_reg of a dynamic field) through `occ_m`."""
    p = params
    dynamic = "multires_deform" in cfg
    if dynamic and opt["anneal_steps"] > 0:
        ramp = min(max(float(torch.tensor(step, dtype=torch.float32)
                             / torch.tensor(opt["anneal_steps"],
                                            dtype=torch.float32)), 0.0), 1.0)
        p = rf.anneal(params, cfg, ramp)
    t = batch.get("t")
    img = rr.render_rays(p, cfg, occ_m, batch["rays_o"], batch["rays_d"], mc,
                         batch["bg"], batch["noise"], t, q)
    loss = torch.mean(torch.mean((img - batch["gt"]) ** 2, dim=-1))
    if dynamic and opt["deform_zero_reg"] > 0:
        h0 = rf.deform(p, cfg, batch["x_reg"], 0.0, q, gate=False)
        loss = loss + opt["deform_zero_reg"] * torch.mean(h0 ** 2)
    return loss


def follow(params0, cfg: dict, mc: dict, opt: dict, batches, occs,
           q=rf.exact, step0: int = 0, state=None):
    """Steps step0..step0+len(batches)-1 from params0 (and from state:
    dict(m, v, ema) of leaf lists) -> dict(losses, grad0 [leaf tensors],
    params [leaves after the last step], ema [leaves])."""
    names = leaf_names(params0)
    ps = [t.detach().clone().float().requires_grad_(True)
          for t in leaves(params0)]
    net = [("mlp" in n.split(".")[0]) for n in names]
    lr = [opt["lr_net"] if (k and opt.get("lr_net")) else opt["lr"]
          for k in net]
    if state is None:
        m = [torch.zeros_like(p) for p in ps]
        v = [torch.zeros_like(p) for p in ps]
        ema = [p.detach().clone() for p in ps]
    else:
        m, v, ema = ([t.detach().clone().float() for t in state[k]]
                     for k in ("m", "v", "ema"))
    b1, b2, eps, d = 0.9, 0.99, 1e-15, opt["ema_decay"]
    out = {"losses": [], "grad0": None}
    for k, (batch, occ_m) in enumerate(zip(batches, occs), step0):
        params = rebuild(params0, iter(ps))
        loss = step_loss(params, cfg, mc, opt, batch, occ_m, k, q)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, ps)]
        out["losses"].append(float(loss.detach()))
        if k == step0:
            out["grad0"] = [g.detach().clone() for g in grads]
        sched = 0.1 ** min(k / opt["iters"], 1.0)
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(ps, grads)):
                m[i].mul_(b1).add_(g, alpha=1 - b1)
                v[i].mul_(b2).addcmul_(g, g, value=1 - b2)
                c1, c2 = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
                denom = (v[i].sqrt() / c2 ** 0.5) + eps
                p.addcdiv_(m[i], denom, value=-lr[i] * sched / c1)
                ema[i].mul_(d).add_(p, alpha=1 - d)
    out["params"] = [p.detach() for p in ps]
    out["ema"] = ema
    out["names"] = names
    return out
