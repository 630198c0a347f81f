"""The D-NeRF field (models/dnerf.py, the Trainer route of `main_dnerf
--bound 2`) trained at the CLI's own rates, against the JAX package.

A narrow deform field (4 levels, 2^12 entries a level, a 3 x 32 deform
tower) on the procedural dynamic scene at 32 px, a 16^3 grid, 128 rays a
step, 96 steps from the reference's init (carried across by
models/params.py), at main_dnerf's rates for `--bound 2`: 5e-4 for the
tables and 5e-4 for the towers. The reference trains three seeds; the
port's val PSNR must lie within their range widened by 0.75 dB (threefry
and Philox draw different rays), as tests/test_torch_ngp_train.py's band.

What it shows: at these rates the field's val PSNR falls below the seeded
field's in both packages (measured 11.78 -> 6.49-6.55 dB), so the loss that
did not move on the card at these rates is the reference's behaviour at a
cut schedule, not a fault of the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from sealdnerf_tpu.models.api import make_dnerf_field as jax_dnerf_field
from sealdnerf_tpu.models.dnerf import DNeRFConfig as JaxDNeRFConfig
from sealdnerf_tpu.parallel.mesh import make_mesh
from sealdnerf_tpu.render.dynamic_grid import init_dyn_grid_state
from sealdnerf_tpu.train.trainer import Trainer as JaxTrainer
from sealdnerf_tpu.train.trainer import TrainOptions as JaxOptions
from sealdnerf_tpu_torch import main_dnerf
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models.api import make_dnerf_field
from sealdnerf_tpu_torch.models.dnerf import DNeRFConfig
from sealdnerf_tpu_torch.models.params import params_from_jax
from sealdnerf_tpu_torch.train.trainer import Trainer, TrainOptions

NARROW = dict(bound=2.0, num_levels=4, log2_hashmap_size=12,
              num_layers_deform=3, hidden_dim_deform=32)
STEPS = 96
SEEDS = (1, 2, 3)
BAND_DB = 0.75


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cli_rates():
    opt = main_dnerf.parse_args(["synthetic", "-O", "--bound", "2",
                                 "--device", "cpu"])
    return opt.lr, opt.lr_net


def _opts(cls, ws, lr, lr_net):
    return cls(iters=STEPS, num_rays=128, bound=2.0, lr=lr, lr_net=lr_net,
               update_extra_interval=64, eval_interval=1000,
               segment_steps=16, workspace=ws, grid_size=16, max_steps=256)


def test_dnerf_field_at_the_cli_rates_in_jax_band(tmp_path):
    lr, lr_net = _cli_rates()
    assert (lr, lr_net) == (5e-4, 5e-4)
    _, jtrain, jval = jax_scene(n_train=6, n_val=2, res=32, dynamic=True)
    _, train, val = make_synthetic_scene(n_train=6, n_val=2, res=32,
                                         dynamic=True)
    jt = JaxTrainer("t", _opts(JaxOptions, str(tmp_path / "j"), lr, lr_net),
                    jax_dnerf_field(jax.random.PRNGKey(0),
                                    JaxDNeRFConfig(**NARROW)),
                    workspace=str(tmp_path / "j"), use_checkpoint="scratch",
                    mesh=make_mesh(jax.devices()[:1]), time_conditioned=True)
    init = jax.tree_util.tree_map(np.asarray, jt.params)
    band = []
    for seed in SEEDS:
        # the compiled step is kept: the packed budget cannot change before
        # the grid's 16th pass (12 refresh calls in 96 steps)
        jt.rng = jax.random.PRNGKey(seed)
        jt.params = jax.tree_util.tree_map(jnp.asarray, init)
        jt.ema_params = jax.tree_util.tree_map(jnp.asarray, init)
        jt.field.params = jt.params
        jt.opt_state = jt.tx.init(jt.params)
        jt.grid_state = init_dyn_grid_state(jt.dyn_grid_cfg)
        jt.global_step = jt.local_step = jt.epoch = 0
        jt.mean_count, jt._cur_budget = 0.0, jt.opt.samples_per_ray
        jt.train(jtrain, None, max_epochs=STEPS // len(jtrain))
        assert jt.global_step == STEPS
        assert jt._cur_budget == jt.opt.samples_per_ray
        band.append(float(jt.evaluate(jval)))
    field = make_dnerf_field(torch.Generator().manual_seed(0),
                             DNeRFConfig(**NARROW))
    field.params = params_from_jax(init)
    tt = Trainer("t", _opts(TrainOptions, str(tmp_path / "t"), lr, lr_net),
                 field, workspace=str(tmp_path / "t"),
                 use_checkpoint="scratch", device="cpu",
                 time_conditioned=True)
    tt.opt.seed = 1
    seeded = tt.evaluate(val)
    tt.train(train, None, max_epochs=STEPS // 16)
    assert tt.global_step == STEPS
    got = tt.evaluate(val)
    print(f"port {got:.3f} dB (seeded {seeded:.3f}); JAX {band}")
    assert min(band) - BAND_DB <= got <= max(band) + BAND_DB, (got, band)
    # the reference's behaviour at these rates, pinned: the field loses
    # PSNR against its seeded init in both packages
    assert max(band) < seeded - 2.0 and got < seeded - 2.0, (seeded, band)
