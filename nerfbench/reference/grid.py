"""Plain reference of one occupancy-grid refresh: the density at the
queried points, then on the refreshed rows max(old * decay, new) where
both are known (>= 0), the threshold min(mean density over the whole grid,
density_thresh), and the occupancy of those rows."""

import torch

from . import field as rf


def refresh_rows(params, cfg: dict, queries, old_rows, total_before: float,
                 n_cells: int, decay: float, thresh: float, q=rf.exact):
    """queries: per refreshed row, (cell indices [n], points [n, 3], time
    or None); old_rows: [rows, H^3] the rows before the refresh;
    total_before: the f64 sum of max(grid, 0) over the whole grid before
    it; n_cells: the grid's cell count -> (sigma per row, occupancy
    [rows, H^3])."""
    rows, sigmas = [], []
    for (idx, pts, t), old in zip(queries, old_rows):
        sig, _ = rf.forward_chunked(params, cfg, pts, None, t, q,
                                    density_only=True)
        sigmas.append(sig)
        new = torch.full_like(old, -1.0)
        new[idx] = sig
        keep = (old >= 0) & (new >= 0)
        rows.append(torch.where(keep, torch.maximum(old * decay, new), old))
    old_sum = sum(float(o.clamp(min=0).sum(dtype=torch.float64))
                  for o in old_rows)
    new_sum = sum(float(r.clamp(min=0).sum(dtype=torch.float64))
                  for r in rows)
    mean = (total_before - old_sum + new_sum) / n_cells
    th = min(mean, thresh)
    return sigmas, torch.stack([r > th for r in rows])


def coverage(poses, intr, h: int, bound: float, chunk: int = 1 << 15):
    """The cells [H^3] (raster order) that some training camera sees: the
    cell's centre in front of the camera and inside its frustum widened by
    a cell. poses: [B, 4, 4] cam2world; intr: [4] (fx, fy, cx, cy)."""
    fx, fy, cx, cy = (float(v) for v in intr)
    idx = torch.arange(h ** 3, device=poses.device)
    xyz = torch.stack([idx // (h * h), (idx // h) % h, idx % h], -1).float()
    half = bound / h
    world = (2.0 * xyz / (h - 1) - 1.0) * (bound - half)
    rot = poses[:, :3, :3]
    trans = torch.einsum("bc,bcd->bd", poses[:, :3, 3], rot)
    seen = []
    for i in range(0, world.shape[0], chunk):
        cam = torch.einsum("nc,bcd->bnd", world[i:i + chunk], rot) \
            - trans[:, None, :]
        z = cam[..., 2]
        seen.append(((z > 0) & (cam[..., 0].abs() < cx / fx * z + 2 * half)
                     & (cam[..., 1].abs() < cy / fy * z + 2 * half))
                    .any(dim=0))
    return torch.cat(seen)


def cells_of(pts, h: int, bound: float):
    """The cells [N] (raster order) whose jittered query points `pts` [N, 3]
    are: each cell's centre (2 i / (H - 1) - 1) (bound - bound / H) with
    the point within half a cell of it; and whether each point is."""
    half = bound / h
    c = torch.round((pts / (bound - half) + 1.0) * (h - 1) / 2.0)
    c = c.clamp(0, h - 1)
    centre = (2.0 * c / (h - 1) - 1.0) * (bound - half)
    inside = ((pts - centre).abs() <= half * (1 + 1e-4)).all(-1)
    c = c.long()
    return c[:, 0] * h * h + c[:, 1] * h + c[:, 2], inside


def updated_rows(queries, rows_before: dict, covered: dict, h: int,
                 bounds: dict, decay: float, total_after: float,
                 after_sums: dict, n_cells: int, thresh: float):
    """The occupancy of the rows that one grid update queried, worked out
    again: per row, the densities `sigma` at its points `pts` (queries:
    (row, pts, sigma)) on their cells (a cell queried twice keeps its
    lower density), then max(old * decay, new) on every cell that a
    training camera sees (`covered`; the old value of such a cell is at
    least 0), and the threshold min(mean density over the whole grid,
    thresh), where the rows not queried add what the grid holds after the
    update (`total_after` less the queried rows' `after_sums`, of n_cells
    cells) -> {row: occupancy [H^3]}."""
    new_rows = {}
    for row, pts, sigma in queries:
        cells, inside = cells_of(pts, h, bounds[row])
        new = torch.full((h ** 3,), float("inf"), device=sigma.device)
        new.scatter_reduce_(0, cells[inside], sigma[inside], reduce="amin")
        new = torch.where(torch.isfinite(new), new, torch.full_like(new, -1))
        old = torch.where(covered[row], rows_before[row].clamp(min=0),
                          torch.full_like(new, -1))
        keep = (old >= 0) & (new >= 0)
        new_rows[row] = torch.where(keep, torch.maximum(old * decay, new),
                                    old)
    total = total_after - sum(after_sums[r] for r in new_rows) + sum(
        float(r.clamp(min=0).sum(dtype=torch.float64))
        for r in new_rows.values())
    th = min(total / n_cells, thresh)
    return {row: r > th for row, r in new_rows.items()}
