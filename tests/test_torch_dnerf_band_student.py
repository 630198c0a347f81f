"""The D-NeRF editing student (StudentTrainer, the `main_seald` route at its
defaults) distilled at the CLI's own rates, against the JAX package.

The narrow D-NeRF teacher of tests/torch_edit_setup.py (trained by the port,
carried to the JAX package by models/params.py), the bbox edit at time
0.5, one pretraining epoch, then 96 ray steps of 128 rays at main_seald's
rates: 5e-4 for the tables and 5e-5 for the towers. The reference distils
three seeds; the port's PSNR against its proxied val views must lie within
their range widened by 0.75 dB, as
tests/test_torch_ngp_edit_cli.py's static band.

What it shows: at these rates both packages' students end far below the
unedited teacher against the edited proxy (measured 7.05-7.11 dB, the
unedited teacher ~20 dB), so the D-NeRF student that missed the reference's
criterion on the card at these rates does so as the reference's does.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu_torch import main_seald
from sealdnerf_tpu_torch.train.metrics import psnr

import torch_edit_setup as setup

SEEDS = (1, 2, 3)
BAND_DB = 0.75
ZONES = dict(local_point_step=0.05, surrounding_point_step=0.1,
             global_point_step=0.5)
PRE_BATCH = 1024
DISTIL_STEPS = 96


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_dnerf_student_at_the_cli_rates_in_jax_band(tmp_path):
    from sealdnerf_tpu.data.synthetic import make_synthetic_scene
    opt = main_seald.parse_args(["synthetic", "-O", "--device", "cpu",
                                 "--teacher_workspace", "t",
                                 "--seal_config", "seal.json"])
    assert (opt.lr, opt.lr_net) == (5e-4, 5e-5)
    tf = setup.TIME_FRAME
    tt = setup.train_ngp_teacher(str(tmp_path / "teacher"), True)
    jt = setup.jax_ngp_teacher(str(tmp_path / "jt"), tt)
    train, val = setup.scene(True)
    jtrain, jval = setup.scene(True, make_synthetic_scene)
    mj, mt = setup.mappers(setup.seal_config())
    kw = dict(iters=10_000, lr=opt.lr, lr_net=opt.lr_net, num_rays=128,
              max_ray_batch=1024, segment_steps=DISTIL_STEPS)
    np.random.seed(0)
    js = setup.jax_ngp_student(jt, str(tmp_path / "js"), mj, **kw)
    init = jax.tree_util.tree_map(np.asarray, js.params)
    grid0 = jax.tree_util.tree_map(lambda x: x.copy(), js.grid_state)
    js.init_pretraining(time_frame=tf, epochs=1, batch_size=PRE_BATCH,
                        **ZONES)
    jgt = js.proxy_dataset(jval, time=tf)
    # the teacher's proxy does not depend on the seed: rendered once
    proxy, cache = js.proxy_dataset, {}

    def proxy_once(ds, time=None):
        if id(ds) not in cache:
            cache[id(ds)] = proxy(ds, time=time)
        return cache[id(ds)]
    js.proxy_dataset = proxy_once
    band = []
    for seed in SEEDS:
        js.rng = jax.random.PRNGKey(seed)
        js.params = jax.tree_util.tree_map(jnp.asarray, init)
        js.ema_params = jax.tree_util.tree_map(jnp.asarray, init)
        js.field.params = js.params
        js.opt_state = js.tx.init(js.params)
        js._pretrain_state = js._pretrain_tx.init(js.params)
        js.grid_state = jax.tree_util.tree_map(lambda x: x.copy(), grid0)
        js.global_step = js.local_step = js.epoch = 0
        js.mean_count, js._cur_budget = 0.0, js.opt.samples_per_ray
        # the pretraining epoch, then epochs of len(jtrain) steps
        js.train(jtrain, None, max_epochs=1 + DISTIL_STEPS // len(jtrain),
                 time_frame=tf)
        band.append(float(js.evaluate(jgt)))
    st = setup.port_ngp_student(tt, str(tmp_path / "s"), mt, **kw)
    st.init_pretraining(time_frame=tf, epochs=1, batch_size=PRE_BATCH,
                        **ZONES)
    st.train(train, None, max_epochs=2, time_frame=tf)
    n_pre = sum(z["points"].shape[0] for z in st.pretraining_data.values())
    assert st.global_step == DISTIL_STEPS + n_pre
    pv = st.proxy_dataset(val)
    got = st.evaluate(pv)
    unedited = np.mean([psnr(st.render_teacher_image(
        pv.poses[i], pv.intrinsics, pv.h, pv.w, time=tf, edited=False)[0],
        pv.images[i]) for i in range(len(pv))])
    print(f"port {got:.3f} dB; JAX {band}; the unedited teacher "
          f"{unedited:.3f} dB")
    assert min(band) - BAND_DB <= got <= max(band) + BAND_DB, (got, band)
    # the reference's behaviour at these rates, pinned: the students lie
    # further from the edited proxy than the unedited teacher does
    assert max(band) < unedited - 3.0 and got < unedited - 3.0
