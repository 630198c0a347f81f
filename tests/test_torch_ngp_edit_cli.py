"""The port's editing student on the Instant-NGP and D-NeRF fields
through its CLIs: a short distillation against the JAX package's, and
main_seald and main_SealNeRF at their defaults, on the teachers of
tests/test_torch_ngp_edit.py (narrow, bound 2, dt_gamma 1/128; trained by
the port on the CPU and carried to the JAX package by models/params.py).
Tolerances:
- a short static distillation (one pretraining epoch, 12 ray steps at the
  reference main_SealNeRF's rate): the port's val PSNR against its proxied
  views within the band of the reference's students over three seeds,
  widened by 0.75 dB (threefry and Philox draw different rays);
- main_seald (`synthetic -O --teacher_workspace T --workspace W
  --seal_config seal.json --time_frame 0.5`) and main_SealNeRF (`synthetic
  -O --teacher_workspace T --workspace W`) at their defaults with --device
  cpu end to end: the StudentTrainer on the D-NeRF (Instant-NGP) field, at
  the reference's rates, its artefacts and frames, the deform tower kept;
- --basis and --hyper route the edit to their D-NeRF variants, and
  --bound 1 --dt_gamma 0 to the CP field.
"""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu_torch import cli, main_seald, main_SealNeRF
from sealdnerf_tpu_torch.editing.student import StudentTrainer
from sealdnerf_tpu_torch.models import dnerf as td
from sealdnerf_tpu_torch.models import ngp as tn
from sealdnerf_tpu_torch.models.dnerf import DNeRFConfig
from sealdnerf_tpu_torch.models.ngp import NGPConfig
from sealdnerf_tpu_torch.models.params import param_leaves

import torch_edit_setup as setup

BAND_DB = 0.75
SEEDS = (1, 2, 3)
ZONES = dict(local_point_step=0.05, surrounding_point_step=0.1,
             global_point_step=0.5)
PRE_BATCH = 1024
DISTIL_STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    return setup.ngp_teachers(tmp_path_factory)


def test_distillation_in_jax_band(teachers, tmp_path):
    """A short static distillation (one pretraining epoch, DISTIL_STEPS
    ray steps at the reference main_SealNeRF's rate): the port's student
    against its proxied val views, within the band of the reference's
    students over three seeds."""
    from sealdnerf_tpu.data.synthetic import make_synthetic_scene
    train, val = setup.scene(False)
    jtrain, jval = setup.scene(False, make_synthetic_scene)
    _, tt, jt = teachers(False)
    mj, mt = setup.mappers(setup.seal_config())
    # the proxy renders a 32 px view (1,024 rays) in one chunk
    kw = dict(iters=10_000, lr=1e-2, max_ray_batch=1024,
              update_extra_interval=16, segment_steps=DISTIL_STEPS)
    np.random.seed(0)
    js = setup.jax_ngp_student(jt, str(tmp_path / "js"), mj, **kw)
    init = jax.tree_util.tree_map(np.asarray, js.params)
    grid0 = jax.tree_util.tree_map(lambda x: x.copy(), js.grid_state)
    js.init_pretraining(epochs=1, batch_size=PRE_BATCH, **ZONES)
    jgt = js.proxy_dataset(jval)
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
        js._train_sig = None
        # the pretraining epoch, then epochs of len(jtrain) steps
        js.train(jtrain, None, max_epochs=1 + DISTIL_STEPS // len(jtrain))
        band.append(float(js.evaluate(jgt)))
    st = setup.port_ngp_student(tt, str(tmp_path / "s"), mt, **kw)
    st.init_pretraining(epochs=1, batch_size=PRE_BATCH, **ZONES)
    st.train(train, None, max_epochs=2)
    n_pre = sum(z["points"].shape[0] for z in st.pretraining_data.values())
    assert st.global_step == DISTIL_STEPS + n_pre
    got = st.evaluate(st.proxy_dataset(val))
    print(f"port {got:.3f} dB; JAX {band}")
    assert min(band) - BAND_DB <= got <= max(band) + BAND_DB, (got, band)


# -------------------------------------------------------------- the CLIs
def _narrow_edit_cli(monkeypatch, module):
    monkeypatch.setattr(tn, "NGPConfig",
                        functools.partial(tn.NGPConfig, **setup.NGP_NARROW))
    monkeypatch.setattr(td, "DNeRFConfig", functools.partial(
        td.DNeRFConfig, **{k: v for k, v in setup.DNERF_FIELD.items()
                           if k != "bound"}))
    monkeypatch.setattr(module, "build_edit_trainers", lambda opt, **kw:
                        cli.build_edit_trainers(opt, **kw, **setup.NGP_GRID,
                                                segment_steps=8))


@pytest.mark.parametrize("dynamic", [True, False],
                         ids=["main_seald", "main_SealNeRF"])
def test_main_edit_at_defaults_on_the_cpu(tmp_path, monkeypatch, teachers,
                                         dynamic):
    """main_seald (`synthetic -O --teacher_workspace T --workspace W
    --seal_config seal.json --time_frame 0.5`) and main_SealNeRF
    (`synthetic -O --teacher_workspace T --workspace W`) at their defaults
    with --device cpu: the StudentTrainer on the D-NeRF (Instant-NGP)
    field, one pretraining epoch and one epoch of distillation, then the
    test frames."""
    mod = main_seald if dynamic else main_SealNeRF
    _narrow_edit_cli(monkeypatch, mod)
    tws = teachers(dynamic)[0] + "/teacher"
    ws = str(tmp_path / "edit")
    os.makedirs(ws)
    with open(os.path.join(ws, "seal.json"), "w") as f:
        json.dump(setup.seal_config(), f)
    argv = ["synthetic", "-O", "--teacher_workspace", tws, "--workspace", ws,
            "--device", "cpu", "--synthetic_res", "16",
            "--pretraining_epochs", "1", "--pretraining_batch_size", "2048",
            "--pretraining_local_point_step", "0.05",
            "--pretraining_surrounding_point_step", "0.1",
            "--extra_epochs", "1", "--num_rays", "128", "--max_steps", "256"]
    if dynamic:
        argv += ["--seal_config", "seal.json", "--time_frame", "0.5"]
    else:
        argv += ["--log2_hashmap_size", "12", "--bg_radius", "4"]
    opt = mod.parse_args(argv)
    assert (opt.bound, opt.dt_gamma, opt.backbone) == (2.0, 1 / 128, "auto")
    if dynamic:
        assert (opt.lr, opt.lr_net) == (5e-4, 5e-5)
    st = mod.main(argv)
    assert type(st) is StudentTrainer and st.time_conditioned == dynamic
    cfg = st.field.cfg
    if dynamic:
        assert isinstance(cfg, DNeRFConfig) and cfg.variant == "deform"
        assert sorted(st.scheduler.base_lrs) == [5e-5, 5e-4]
    else:
        assert isinstance(cfg, NGPConfig) and cfg.bg_radius == 4.0
        assert cfg.log2_hashmap_size == 12
    assert st.march.cascades == 2 and st.march.dt_gamma == 1 / 128
    names = set(os.listdir(ws))
    assert {"seal.json", "options.json", "run.sh", "timer.json",
            "from.obj", "to.obj", "results"} <= names, names
    assert len(os.listdir(os.path.join(ws, "results"))) == 6
    assert len(st.proxied["train"]) == 48 and st.epoch == 2
    assert np.isfinite(st.history["loss"]).all()
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "took over the teacher's grid state: iter_density" in log
    assert "[pretrain epoch 1]" in log
    if dynamic:
        tt = st.teacher_trainer
        for a, b in zip(param_leaves(st.params["deform_mlp"]),
                        param_leaves(tt.params["deform_mlp"])):
            assert torch.equal(a, b)


def test_main_seald_variants_route(tmp_path, monkeypatch):
    """--basis and --hyper select the D-NeRF variant of the edit; the CP
    edit stays at --bound 1 --dt_gamma 0."""
    base = ["synthetic", "-O", "--device", "cpu", "--workspace",
            str(tmp_path)]
    for flags, cp in (([], False), (["--basis"], False),
                      (["--bound", "1", "--dt_gamma", "0"], True),
                      (["--bound", "1"], False)):
        assert cli.edit_cp_route(main_seald.parse_args(base + flags),
                                 dynamic=True) == cp, flags
    assert not cli.edit_cp_route(main_SealNeRF.parse_args(base), False)
    for flag, variant in (("--basis", "basis"), ("--hyper", "hyper")):
        opt = main_seald.parse_args(base + [flag, "--ckpt", "scratch"])
        tr, field = cli.build_trainer(opt, dynamic=True, edit=True,
                                      grid_size=16)
        assert field.cfg.variant == variant and tr.time_conditioned
