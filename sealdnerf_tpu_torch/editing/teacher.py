"""The edit-aware teacher and the occupancy force-fill (port of
sealdnerf_tpu/editing/teacher.py).

A teacher wraps a trained field so that a sample inside the edit is
answered by the original scene: the mapper's map_to_origin on the spatial
coordinates, then the field (for a time-conditioned field at time t, after
the mapping: the deform tower warps the mapped point), then map_color where
the mask holds. A secondary teacher, when given, answers the mapped samples
instead of the base field.

`make_teacher_field` wraps a models.api Field (the Instant-NGP or D-NeRF
field; the reference's make_teacher_field): a Field with the same
signatures, forward(params, x [S, 3], d [S, 3], *extra) -> (sigma, rgb[,
deform]) and density(params, x, *extra) -> (sigma, geo_feat), and the base
field's colour tower and background, in plain PyTorch.

`TeacherField` wraps a CPField, static or time-conditioned; the field
runs through the port's kernels: K1 (field_forward) for a static field, K3
(dyn_field_forward) for a time-conditioned one, or their plain versions on
CPU tensors. The wrapper is given in the two layouts of the port's
renderers:
- `forward(params, x [S, 3], d [S, 3], *extra) -> (sigma [S], rgb [S, 3])`
  for render/fast.py's render_dense;
- `forward_planar(params, x3 [3, M], d3 [3, M], *extra) -> out [4, M]` for
  render/fast_image.py's render_image_tiled.
`params` are the base field's; `extra` is (t,) for a time-conditioned one.
plain=True runs the kernels' plain versions on any device (to hold the
kernels against them; no kernel launch).

`force_fill_mask` marks the grid cells inside the mapper's force_fill_bound
([CAS, H, H, H], or [T, CAS, H, H, H]: a broadcast view of one [H, H, H]
mask) and `hack_occ` ORs it into an occupancy, so that rays always sample
the edit region, whatever the trained grid says of it.
"""

from typing import Optional

import numpy as np
import torch

from ..models.api import Field
from ..ops.field import (FieldTables, dyn_field_forward,
                         dyn_field_forward_plain, field_forward,
                         field_forward_plain)
from .seal_utils import SealMapper


def make_teacher_field(base: Field, mapper: SealMapper,
                       secondary: Optional[Field] = None) -> Field:
    """`base` wrapped so that the samples inside the edit are answered by
    the original scene (the secondary field where given), recoloured.
    Extra outputs of base.forward (a D-NeRF field's deform) are kept."""

    def forward(params, x, d, *extra):
        xm, dm, mask = mapper.map_to_origin_compact(x, d)
        out = base.forward(params, xm, dm, *extra)
        sigma, rgb = out[0], out[1]
        idx = mask.nonzero()[:, 0]
        if idx.numel():
            sigma, rgb = sigma.clone(), rgb.clone()
            if secondary is not None:
                out2 = secondary.forward(secondary.params, xm[idx], dm[idx],
                                         *extra)
                sigma[idx], rgb[idx] = out2[0], out2[1]
            v_means = mapper.color_means(xm, rgb)
            rgb[idx] = mapper.map_color(xm[idx], dm[idx], rgb[idx], v_means)
        return (sigma, rgb) + tuple(out[2:])

    def density(params, x, *extra):
        xm, _, mask = mapper.map_to_origin_compact(x)
        out = base.density(params, xm, *extra)
        idx = mask.nonzero()[:, 0]
        if secondary is None or not idx.numel():
            return out
        sigma = out[0].clone()
        sigma[idx] = secondary.density(secondary.params, xm[idx], *extra)[0]
        return (sigma,) + tuple(out[1:])

    return Field(base.params, base.cfg, forward, density, base.color,
                 base.background)


class TeacherField:
    def __init__(self, base, mapper: SealMapper, secondary=None,
                 time_conditioned: bool = False, plain: bool = False):
        self.base = base
        self.mapper = mapper
        self.secondary = secondary
        self.time_conditioned = time_conditioned
        self.plain = plain

    def _field(self, field, params, x3, d3, extra, density_only=False):
        tables = params if isinstance(params, FieldTables) \
            else field.kernel_tables(params)
        if self.time_conditioned:
            fn = dyn_field_forward_plain if self.plain else dyn_field_forward
            return fn(tables, field.cfg, x3, d3, extra[0],
                      density_only=density_only)
        fn = field_forward_plain if self.plain else field_forward
        return fn(tables, field.cfg, x3, d3, density_only=density_only)

    def _mapped(self, x3, d3):
        """Planar mapped positions and directions and the edit mask."""
        xm, dm, mask = self.mapper.map_to_origin_compact(
            x3.t(), None if d3 is None else d3.t())
        return (xm.t().contiguous(),
                None if dm is None else dm.t().contiguous(), mask)

    def forward_planar(self, params, x3, d3, *extra, density_only=False):
        xm3, dm3, mask = self._mapped(x3, None if density_only else d3)
        out = self._field(self.base, params, xm3, dm3, extra, density_only)
        idx = mask.nonzero()[:, 0]
        if self.secondary is not None and idx.numel():
            out[:, idx] = self._field(
                self.secondary, self.secondary.params,
                xm3[:, idx].contiguous(),
                None if density_only else dm3[:, idx].contiguous(), extra,
                density_only)
        if not density_only and idx.numel():
            rgb = out[1:4].t()
            v_means = self.mapper.color_means(xm3.t(), rgb)
            sel = xm3[:, idx].t()
            out[1:4, idx] = self.mapper.map_color(
                sel, dm3[:, idx].t(), rgb[idx], v_means).t()
        return out

    def forward(self, params, x, d, *extra):
        out = self.forward_planar(params, x.t().contiguous(),
                                  d.t().contiguous(), *extra)
        return out[0], out[1:4].t()

    def density(self, params, x, *extra):
        """sigma [S] of the edited scene at x [S, 3]."""
        return self.forward_planar(params, x.t().contiguous(), None, *extra,
                                   density_only=True)[0]


def force_fill_mask(mapper: SealMapper, grid_size: int, cascades: int,
                    bound: float, time_size: int = 0, device=None):
    """Bool mask of the grid cells inside the mapper's force_fill_bound,
    [CAS, H, H, H] (or [T, CAS, H, H, H] when time_size > 0), as a
    broadcast view of one [H, H, H] mask on `device`."""
    h = grid_size
    bounds = np.asarray(mapper.map_data["force_fill_bound"].cpu())
    if bounds.ndim == 2:
        bounds = bounds[None]
    mask = np.zeros((h, h, h), dtype=bool)
    for b in bounds:
        bmin = np.clip(b[0], -bound, bound)
        bmax = np.clip(b[1], -bound, bound)
        # the reference floors ((b + bound) / bound / 2) * H
        cmin = np.clip(np.floor((bmin + bound) / (2 * bound) * h).astype(int),
                       0, h - 1)
        cmax = np.clip(np.floor((bmax + bound) / (2 * bound) * h).astype(int),
                       0, h)
        mask[cmin[0]:cmax[0] + 1, cmin[1]:cmax[1] + 1,
             cmin[2]:cmax[2] + 1] = True
    shape = (cascades, h, h, h) if time_size <= 0 \
        else (time_size, cascades, h, h, h)
    return torch.from_numpy(mask).to(device).expand(shape)


def hack_occ(occ, fill_mask: Optional[torch.Tensor]):
    """The occupancy with the edit region forced on (the reference's
    hack_bitfield); `occ` itself is not changed."""
    return occ if fill_mask is None else occ | fill_mask
