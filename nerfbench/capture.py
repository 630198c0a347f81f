"""What a check reads of the program's run, and the comparisons that turn
it into the numbers held against the limits.

- `StepCapture`: some of the program's training steps: the state they
  start from (params, Adam's moments, the EMA, the step), each step's
  batch and the occupancy it marched, the first grid refresh's queries
  and the rows it changed (when a refresh comes first), Adam's first
  moment after the first step, the params and their EMA after the last.
- `GridCapture`: the queries of the program's last grid update in a
  phase (a training refresh or a rebuild): the params it read, its points,
  times and densities, the rows it changed before it, and the occupancy
  and the grid's sums after it.
- `compare_training`, `compare_grid`, `compare_frames`: the numbers.
"""

import statistics

import numpy as np
import torch


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone_tree(v) for v in tree]
    return tree.detach().clone()


class Outputs:
    """What a check reads of the program, produced instead by the
    reference in another precision or with a fault planted (the controls
    and faults that set and test the limits)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _leaves(tree):
    from sealdnerf_tpu_torch.models.params import param_leaves
    return param_leaves(tree)


class StepCapture:
    """The program's training steps run inside the `with` block."""

    def __init__(self, trainer):
        self.tr = trainer
        self.batches, self.occs, self.queries, self.losses = [], [], [], []
        self.grad0 = None

    def __enter__(self):
        tr = self.tr
        loss_on, density_fn = tr.loss_on, tr._density_fn

        def capture_loss_on(*args, **kwargs):
            names = ("rays_o", "rays_d", "gt", "bg", "noise", "t", "x_reg")
            b = {k: (v.detach().clone() if torch.is_tensor(v) else v)
                 for k, v in zip(names, args)}
            self.batches.append(b)
            self.occs.append(tr._occ_m.clone())
            return loss_on(*args, **kwargs)

        def capture_density_fn(params):
            fn = density_fn(params)

            def query(pts, *t):
                sig = fn(pts, *t)
                if not self.batches:            # the first step's refresh
                    tq = t[0] if t else None
                    self.queries.append((pts.clone(), tq.clone() if
                                         torch.is_tensor(tq) else tq,
                                         sig.clone()))
                return sig
            return query
        tr.loss_on, tr._density_fn = capture_loss_on, capture_density_fn
        g = tr.grid_state["density_grid"]
        self.total_before = float(g.clamp(min=0).sum(dtype=torch.float64))
        self.n_cells = g.numel()
        self.rows_before = g.reshape(-1, g.shape[-1])[:self._rows()].clone()
        self.step0 = int(tr.global_step)
        self.params_before = [p.detach().clone()
                              for p in _leaves(tr.params)]
        self.ema_before = [p.detach().clone()
                           for p in _leaves(tr.ema_params)]
        self.m_before, self.v_before = self._moments()
        return self

    def _moments(self):
        """Adam's moments of every leaf (0 before its first step)."""
        tr = self.tr
        st = [tr.optimizer.state.get(p, {}) for p in _leaves(tr.params)]
        m = [s["exp_avg"].clone() if s else torch.zeros_like(p)
             for s, p in zip(st, _leaves(tr.params))]
        v = [s["exp_avg_sq"].clone() if s else torch.zeros_like(p)
             for s, p in zip(st, _leaves(tr.params))]
        return m, v

    def _rows(self):
        if not self.tr.time_conditioned:
            return 1
        return min(self.tr.dyn_grid_cfg.bins_per_call,
                   self.tr.dyn_grid_cfg.time_size)

    def after_step(self, k: int):
        tr = self.tr
        if k == 0:
            g = tr.grid_state["occ"]
            self.occ_after = g.reshape(-1, g[0].numel())[:self._rows()].clone()
            # Adam's first moment after a step is b1 m + (1 - b1) gradient
            b1 = tr.optimizer.defaults["betas"][0]
            m1, _ = self._moments()
            self.grad0 = [(a - b1 * b) / (1 - b1)
                          for a, b in zip(m1, self.m_before)]

    def __exit__(self, *exc):
        tr = self.tr
        tr.__dict__.pop("loss_on", None)
        tr.__dict__.pop("_density_fn", None)
        self.params_after = [p.detach().clone() for p in
                             _leaves(tr.params)]
        self.ema_after = [p.detach().clone() for p in
                          _leaves(tr.ema_params)]
        return False


def _leaf_gap(prog, ref, exclude):
    """The worst leaf's gap between the two norms, against the larger of
    the reference leaf's norm and the median leaf's."""
    pn = [float(p.norm()) for p in prog]
    rn = [float(r.norm()) for r in ref]
    keep = [i for i in range(len(rn)) if i not in exclude]
    med = statistics.median(rn[i] for i in keep)
    return max(abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in keep)


def excluded_leaves(ref_grad0):
    """Leaves whose reference gradient is nought to rounding (under 1e-3 of
    the median leaf's): they move under Adam by round-off alone (the
    coarse-to-fine ramp holds the finest scales' rows at 0 early on)."""
    gmed = statistics.median(float(g.norm()) for g in ref_grad0)
    return {i for i, g in enumerate(ref_grad0)
            if float(g.norm()) < 1e-3 * gmed}


def compare_training(cand, ref, cap) -> dict:
    """The numbers of a training check, of `cand` (the program's steps, or
    a control or fault) against the reference's `ref`, both from the state
    `cap` holds at their start: the worst step's loss gap, and by the worst
    leaf the first gradient, the change of the params and of their EMA over
    the steps, each as the gap between the two norms; then, where the
    steps began with a grid refresh, its density at its queried points
    (the 99th percentile of |ln sigma - ln sigma_ref|)."""
    exclude = excluded_leaves(ref.grad0)
    p0, e0 = cap.params_before, cap.ema_before
    out = {
        "loss_gap": max(abs(float(p) - float(r)) / abs(float(r))
                        for p, r in zip(cand.losses, ref.losses)),
        "grad_gap": _leaf_gap(cand.grad0, ref.grad0, exclude),
        "change_gap": _leaf_gap([a - b for a, b in
                                 zip(cand.params_after, p0)],
                                [a - b for a, b in zip(ref.params_after, p0)],
                                exclude),
        "ema_gap": _leaf_gap([a - b for a, b in zip(cand.ema_after, e0)],
                             [a - b for a, b in zip(ref.ema_after, e0)],
                             exclude),
    }
    if ref.queries:
        out["refresh_sigma_p99"] = sigma_p99(
            [c for _, _, c in cand.queries], [r for _, _, r in ref.queries])
    return out


def sigma_p99(cand, ref) -> float:
    """The 99th percentile of |ln sigma - ln sigma_ref| over all points."""
    gaps = torch.cat([(torch.log(c.clamp(min=1e-30))
                       - torch.log(r.clamp(min=1e-30))).abs()
                      for c, r in zip(cand, ref)]).float()
    k = max(1, int(0.99 * gaps.numel()))
    return float(gaps.kthvalue(k).values)


def unchanged_steps(cap: StepCapture) -> Outputs:
    """The fault "a step that returns its state unchanged"."""
    return Outputs(losses=cap.losses,
                   grad0=[torch.zeros_like(p) for p in cap.params_before],
                   params_after=cap.params_before, ema_after=cap.ema_before,
                   queries=cap.queries)


def half_batches(cap: StepCapture):
    """The fault "half of the batch left out, the mean taken over the
    rest": each step's first half of its rays."""
    out = []
    for b in cap.batches:
        n = b["rays_o"].shape[0] // 2
        out.append({k: (v[:n] if torch.is_tensor(v) and v.dim() > 0 and
                        v.shape[0] == 2 * n and k != "x_reg" else v)
                    for k, v in b.items()})
    return out


# ------------------------------------------------------------------- grid
class GridCapture:
    """The last grid update that the program makes inside the `with`
    block: the tree it read (`source`: "params", the current ones, or
    "ema") and the step; of the rows in `rows` (time bins of a dynamic
    grid; None: every cascade of a static one) each query's points, time
    and densities, the row before the update and its occupancy after; and
    the sums of the grid after it (the whole, each captured row's)."""

    def __init__(self, trainer, source: str, rows=None):
        self.tr, self.source, self.rows = trainer, source, rows
        self.last = None

    def __enter__(self):
        tr = self.tr
        density_fn = tr._density_fn

        def capture_density_fn(params):
            fn = density_fn(params)
            tree = tr.params if self.source == "params" else \
                tr.ema_params
            rec = {"step": int(tr.global_step), "params": clone_tree(tree),
                   "grid_before": tr.grid_state["density_grid"].clone(),
                   "queries": []}
            self.last = rec
            tsz = tr.dyn_grid_cfg.time_size if tr.time_conditioned else 0

            def query(pts, *t):
                sig = fn(pts, *t)
                if tsz:
                    row = int(min(max(int(float(t[0]) * tsz), 0), tsz - 1))
                else:
                    row = len(rec["queries"])       # the cascade
                if self.rows is None or row in self.rows:
                    rec["queries"].append(
                        (row, pts.clone(), t[0].clone() if t else None,
                         sig.clone()))
                return sig
            return query
        tr._density_fn = capture_density_fn
        return self

    def __exit__(self, *exc):
        tr = self.tr
        tr.__dict__.pop("_density_fn", None)
        rec = self.last
        if rec is not None:
            grid = tr.grid_state["density_grid"]
            h3 = tr.grid_state["occ"][0].numel() if not \
                tr.time_conditioned else tr.grid_state["occ"][0, 0].numel()
            before = rec.pop("grid_before").reshape(-1, h3)
            after = grid.reshape(-1, h3)
            rows = sorted({q[0] for q in rec["queries"]})
            rec["rows_before"] = {r: before[r].clone() for r in rows}
            rec["after_sums"] = {r: float(after[r].clamp(min=0).sum(
                dtype=torch.float64)) for r in rows}
            rec["total_after"] = float(grid.clamp(min=0).sum(
                dtype=torch.float64))
            rec["n_cells"] = grid.numel()
            occ = tr.grid_state["occ"].reshape(-1, h3)
            rec["occ"] = {r: occ[r].clone() for r in rows}
        return False


def compare_grid(rec: dict, ref: dict, occ=None) -> dict:
    """The numbers of the grid check, of the program's last update `rec`
    (or of an occupancy `occ` {row: [H^3]} put in its place, a control's
    or a fault's) against the reference's `ref` (reference_grid's): the
    share of the cells that the reference's update occupies and the
    candidate leaves empty, and how far the update's points fall short of
    the cells it is due to query (an exact comparison)."""
    occ = rec["occ"] if occ is None else occ
    missed = full = 0
    for row, want in ref["occ"].items():
        full += int(want.sum())
        missed += int((want & ~occ[row]).sum())
    return {"grid_occ_miss": missed / max(full, 1),
            "grid_query_shortfall": ref["shortfall"]}


def sparser_grid(rec: dict, seed: int) -> dict:
    """The fault "an answer altered where it is produced" of a grid
    update: half of its rows' occupied cells dropped, drawn from `seed`."""
    g = torch.Generator().manual_seed(seed)
    return {row: o & (torch.rand(o.shape, generator=g) < 0.5).to(o.device)
            for row, o in rec["occ"].items()}


# ----------------------------------------------------------------- frames
def _foreground_errors(cand, ref):
    """The largest channel error of every pixel that shows the field (the
    reference's not white) over the sampled frames, and each frame's mean
    squared error."""
    err, fg = [], []
    for (img, *_), (rimg, *_) in zip(cand, ref):
        a = np.asarray(img, np.float64)
        b = np.asarray(rimg, np.float64)
        err.append(np.mean((a - b) ** 2))
        fg.append(np.abs(a - b).max(-1)[(b < 0.999).any(-1)])
    return np.concatenate(fg), err


def compare_frames(cand, ref, ref_bf16) -> dict:
    """The frame check, of `cand` (the program's frames, or a control's or
    a fault's) against the reference's `ref`: `frames_mse`, the mean
    squared error over every pixel of the sampled frames;
    `frames_err_p99`, the 99th percentile of the largest channel error over
    the pixels that show the field; and `frames_err_ratio`, the median of
    that error over the median error of the reference itself rounded at the
    configuration's precision (bf16 operands, `ref_bf16`).

    A tile that takes another bucket or trim on a rounding difference
    concentrates error in a few hundred pixels, which the mean counts and
    the percentiles do not. A trained warp multiplies any rounding by the
    field's sensitivity, which differs from seed to seed more than bf16
    from float8 does; the ratio divides it out: a program that rounds
    where the configuration does reads about 1, a lower precision many
    times that."""
    fg, err = _foreground_errors(cand, ref)
    scale, _ = _foreground_errors(ref_bf16, ref)
    p99 = float(np.percentile(fg, 99)) if fg.size else 0.0
    ratio = float(np.median(fg) / max(np.median(scale), 1e-12)) \
        if fg.size else 0.0
    return {"frames_mse": float(np.mean(err)), "frames_err_p99": p99,
            "frames_err_ratio": ratio}


def altered_frames(kept):
    """The fault "an answer altered where it is produced": each frame's
    colour channels rotated (r, g, b -> g, b, r)."""
    return [(np.asarray(img)[..., [1, 2, 0]],) + tuple(rest)
            for img, *rest in kept]
