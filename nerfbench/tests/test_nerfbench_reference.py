"""The plain reference against the program at tiny sizes on the CPU: the
fields, the training rays and the bucketed frame agree to the program's
bf16 rounding, and the float8 control lies farther from the reference than
the program does."""

import math

import numpy as np
import pytest
import torch

from conftest import TINY_DEFORM, TINY_FIELD
from nerfbench import scene
from nerfbench.fields import cp as fcp
from nerfbench.reference import field as rf
from nerfbench.reference import render as rr


def _program_field(cfg, params):
    from sealdnerf_tpu_torch.models.cp import CPConfig, CPDNeRFConfig
    from sealdnerf_tpu_torch.ops.field import pack_tables
    cls = CPDNeRFConfig if "multires_deform" in cfg else CPConfig
    known = set(cls.__dataclass_fields__)
    pcfg = cls(**{k: (tuple(tuple(x) for x in v) if k in ("scales", "planes")
                      else v) for k, v in cfg.items() if k in known})
    return pcfg, pack_tables(params, pcfg)


def _program_forward(pcfg, tables, t):
    from sealdnerf_tpu_torch.ops.field import (dyn_field_forward,
                                               field_forward)
    if t is None:
        return lambda tabs, x3, d3: field_forward(tabs, pcfg, x3, d3)
    return lambda tabs, x3, d3, tt: dyn_field_forward(tabs, pcfg, x3, d3, tt)


@pytest.mark.parametrize("dynamic", [False, True])
def test_field(dynamic):
    cfg = dict(TINY_FIELD, **(TINY_DEFORM if dynamic else {}))
    params = fcp.make_params(cfg, 3, "cpu")
    if dynamic:     # a warp that moves the samples
        params["deform_mlp"]["w"][-1] = params["deform_mlp"]["w"][-1] * 300
    pcfg, tables = _program_field(cfg, params)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((4096, 3), generator=g) * 2 - 1
    d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g),
                                      dim=-1)
    t = 0.37 if dynamic else None
    out = _program_forward(pcfg, tables, t)(
        tables, x.t().contiguous(), d.t().contiguous(),
        *(() if t is None else (t,)))
    sig, rgb = rf.forward(params, cfg, x, d, t)
    lsig = (torch.log(out[0]) - torch.log(sig)).abs()
    assert float(lsig.max()) < 0.05 and float(lsig.median()) < 5e-3
    assert float((out[1:4].t() - rgb).abs().max()) < 2e-2
    c_sig, _ = rf.forward(params, cfg, x, d, t, rf.fp8)
    assert float((torch.log(c_sig) - torch.log(sig)).abs().median()) > \
        3 * float(lsig.median())


def test_training_rays():
    from sealdnerf_tpu_torch.ops.marching_dense import DenseMarchConfig
    from sealdnerf_tpu_torch.render.fast import render_dense
    cfg = dict(TINY_FIELD, **TINY_DEFORM)
    params = fcp.make_params(cfg, 4, "cpu")
    pcfg, tables = _program_field(cfg, params)
    g = torch.Generator().manual_seed(1)
    occ = torch.rand((8, 8, 8), generator=g) < 0.5
    pose = torch.as_tensor(scene.orbit_pose(1.2, 0.3, 2.0))
    intr = torch.tensor([40.0, 40.0, 16.0, 16.0])
    inds = torch.randint(0, 32 * 32, (256,), generator=g)
    rd = rr.pixel_dirs(pose, intr, 32, 32, inds)
    ro = pose[:3, 3].expand(rd.shape)
    noise = torch.rand(256, generator=g)
    bg = torch.rand((256, 3), generator=g)
    mcfg = DenseMarchConfig(bound=1.0, march_res=8, n_intervals=4,
                            steps_per_interval=4, min_near=0.2)

    def fwd(p, x, dd, tt):
        out = _program_forward(pcfg, tables, tt)(
            tables, x.t().contiguous(), dd.t().contiguous(), tt)
        return out[0], out[1:4].t()
    prog = render_dense(params, occ, ro, rd, mcfg, fwd, bg_color=bg,
                        noise=noise, extra=(0.5,))["image"]
    mc = {"bound": 1.0, "min_near": 0.2, "n_intervals": 4,
          "steps_per_interval": 4, "density_scale": 1.0, "t_thresh": 1e-4}
    ref = rr.render_rays(params, cfg, occ, ro, rd, mc, bg, noise, 0.5)
    assert float((prog - ref).abs().max()) < 1e-2


@pytest.mark.parametrize("tp", [4, 8])
def test_bucketed_frame(tp):
    from sealdnerf_tpu_torch.ops.marching_dense import DenseMarchConfig
    from sealdnerf_tpu_torch.render.fast_image import render_image_bucketed
    cfg = dict(TINY_FIELD)
    params = fcp.make_params(cfg, 5, "cpu")
    pcfg, tables = _program_field(cfg, params)
    g = torch.Generator().manual_seed(2)
    occ = torch.zeros((8, 8, 8), dtype=torch.bool)
    occ[2:6, 2:6, 2:6] = torch.rand((4, 4, 4), generator=g) < 0.7
    pose = torch.as_tensor(scene.orbit_pose(math.pi / 2, 0.4, 2.5))
    intr = torch.tensor([60.0, 60.0, 16.0, 16.0])
    splits = ((0.6, 32), (0.15, 16), (0.15, 4), (0.07, 2), (1.0, 2))
    rcfg = DenseMarchConfig(bound=1.0, march_res=8, n_intervals=8,
                            steps_per_interval=4, min_near=0.2)
    prog, _ = render_image_bucketed(
        tables, occ, pose, intr, 32, 32, rcfg,
        _program_forward(pcfg, tables, None), torch.ones(3), tile_px=tp,
        splits=splits, term_probe=8, term_tau=7.0, term_stride=2)
    mc = {"bound": 1.0, "min_near": 0.2, "n_intervals": 8,
          "steps_per_interval": 4, "density_scale": 1.0, "t_thresh": 1e-4,
          "tile_px": tp, "splits": splits, "term_probe": 8, "term_tau": 7.0,
          "term_stride": 2}
    ref, _ = rr.render_frame(params, cfg, occ, pose, intr, 32, 32, mc,
                             torch.ones(3))
    err = float(((prog - ref) ** 2).mean())
    assert err < 1e-6
    ctl, _ = rr.render_frame(params, cfg, occ, pose, intr, 32, 32, mc,
                             torch.ones(3), q=rf.fp8)
    assert float(((ctl - ref) ** 2).mean()) > 10 * err


def test_pick_tile_is_the_programs():
    from sealdnerf_tpu_torch.ops.marching_dense import DenseMarchConfig
    from sealdnerf_tpu_torch.train.fast import reference_tile, tile_fits
    rcfg = DenseMarchConfig(bound=1.0, march_res=64)
    for h, w, fovy, radius in ((1080, 1920, 50, 5.0), (800, 800, 51.57, 2.0),
                               (1080, 1920, 50, 2.0), (64, 48, 60, 3.0)):
        f = h / (2 * math.tan(math.radians(fovy) / 2))
        intr = np.array([f, f, w / 2, h / 2], np.float32)
        pose = scene.orbit_pose(1.4, 0.2, radius)
        want = 1
        for tp in range(reference_tile(h, w, 8), 1, -1):
            if h % tp == 0 and w % tp == 0 and tile_fits(tp, pose, intr,
                                                          rcfg, 1):
                want = tp
                break
        assert rr.pick_tile(h, w, pose, intr, 1.0, 64) == want
