"""A short training run of a narrow TensoRF field through the port's Trainer
inside the band of three JAX seeds (as tests/test_torch_ngp_train.py's
test_training_in_jax_band does for the Instant-NGP field).

The narrow VM field (resolution 32, ranks 4 / 8) from the reference's init,
at main_tensoRF's rates (factors 2e-2, towers 1e-3) and bound 1 (dt_gamma
0, one cascade), 128 steps of 256 rays on 8 synthetic views at 32 px. The
port's val PSNR must lie within the band of the reference's three seeds
widened by 0.75 dB (threefry and Philox draw different rays), and above the
seeded field's by 3 dB.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from sealdnerf_tpu.models import tensorf as jt
from sealdnerf_tpu.parallel.mesh import make_mesh
from sealdnerf_tpu.render.grid import init_grid_state
from sealdnerf_tpu.train.trainer import Trainer as JaxTrainer
from sealdnerf_tpu.train.trainer import TrainOptions as JaxOptions
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models import tensorf as tt
from sealdnerf_tpu_torch.models.api import make_tensorf_field
from sealdnerf_tpu_torch.models.params import params_from_jax
from sealdnerf_tpu_torch.train.trainer import Trainer, TrainOptions

NARROW = dict(decomposition="vm", resolution=32, sigma_rank=(4, 4, 4),
              color_rank=(8, 8, 8))
STEPS = 128
SEEDS = (1, 2, 3)
BAND_DB = 0.75


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _opts(cls, ws, **kw):
    return cls(**{**dict(iters=STEPS, num_rays=256, bound=1.0, dt_gamma=0.0,
                         lr=2e-2, lr_net=1e-3, update_extra_interval=8,
                         eval_interval=1000, segment_steps=64, workspace=ws,
                         grid_size=32, max_steps=256), **kw})


def test_training_in_jax_band(tmp_path):
    _, jtrain, jval = jax_scene(n_train=8, n_val=1, res=32)
    _, train, val = make_synthetic_scene(n_train=8, n_val=1, res=32)
    field = jt.make_tensorf_field(jax.random.PRNGKey(0),
                                  jt.TensoRFConfig(bound=1.0, **NARROW))
    ws = str(tmp_path / "j")
    jtr = JaxTrainer("t", _opts(JaxOptions, ws), field, workspace=ws,
                     use_checkpoint="scratch",
                     mesh=make_mesh(jax.devices()[:1]))
    init = jax.tree_util.tree_map(np.asarray, jtr.params)
    band = []
    for seed in SEEDS:
        jtr.rng = jax.random.PRNGKey(seed)
        jtr.params = jax.tree_util.tree_map(jnp.asarray, init)
        jtr.ema_params = jax.tree_util.tree_map(jnp.asarray, init)
        jtr.field.params = jtr.params
        jtr.opt_state = jtr.tx.init(jtr.params)
        jtr.grid_state = init_grid_state(jtr.grid_cfg)
        jtr.global_step = jtr.local_step = jtr.epoch = 0
        jtr.mean_count, jtr._cur_budget = 0.0, jtr.opt.samples_per_ray
        jtr._train_sig = None
        jtr.train(jtrain, None, max_epochs=STEPS // 8)
        assert jtr.global_step == STEPS
        band.append(float(jtr.evaluate(jval)))
    ws = str(tmp_path / "t")
    tfield = make_tensorf_field(None, tt.TensoRFConfig(bound=1.0, **NARROW),
                                params=params_from_jax(init))
    seeded_tr = Trainer("s", _opts(TrainOptions, ws), tfield, workspace=ws,
                        use_checkpoint="scratch", device="cpu")
    seeded_tr.mark_untrained_grid(train.poses, train.intrinsics)
    seeded_tr.rebuild_grid()
    seeded = seeded_tr.evaluate(val)
    ttr = Trainer("t", _opts(TrainOptions, ws, seed=1), tfield, workspace=ws,
                  use_checkpoint="scratch", device="cpu")
    ttr.train(train, None, max_epochs=STEPS // 64)
    assert ttr.global_step == STEPS and len(ttr.history["loss"]) == STEPS
    got = ttr.evaluate(val)
    print(f"port {got:.3f} dB (seeded {seeded:.3f}); JAX {band}")
    assert min(band) - BAND_DB <= got <= max(band) + BAND_DB, (got, band)
    assert got > seeded + 3.0
