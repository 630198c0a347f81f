"""Shared set-up of the editing parity tests (tests/test_torch_edit_*.py):
narrow teachers trained by the port on the CPU and loaded into both
packages, the bbox edit of the reference's own editing tests, and the
trainers of both packages around them.

Narrow sizes: line scales (16, 8), (64, 16); the static field with a
(16, 4) VM plane, the dynamic one without and with a 2 x 16 deform tower
whose last matrix is undamped (x 1e3), so that the warp matters; a 32^3
grid; the synthetic scene at 32 px.
"""

import os

import numpy as np
import jax
import torch

from sealdnerf_tpu.editing import seal_utils as jseal
from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig
from sealdnerf_tpu.models.cp import CPDNeRFConfig as JaxDynConfig
from sealdnerf_tpu.models.cp import make_cp_dnerf_field as jax_dyn_field
from sealdnerf_tpu.models.cp import make_cp_field as jax_cp_field
from sealdnerf_tpu.train.fast import FastTrainer as JaxFastTrainer
from sealdnerf_tpu.train.trainer import TrainOptions as JaxOptions
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.editing import seal_utils as tseal
from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig,
                                           make_cp_dnerf_field, make_cp_field)
from sealdnerf_tpu_torch.train.fast import FastTrainer
from sealdnerf_tpu_torch.train.trainer import TrainOptions

NARROW = dict(grid_size=32, march_res=16, n_intervals=6, steps_per_interval=3)
STATIC_FIELD = dict(bound=1.0, scales=((16, 8), (64, 16)), planes=((16, 4),))
DYN_FIELD = dict(bound=1.0, scales=((16, 8), (64, 16)), planes=(),
                 num_layers_deform=2, hidden_dim_deform=16)
TEACHER_STEPS = 64
TIME_FRAME = 0.5


def seal_config(hsv=(0.3, 0.0, 0.0), dy=0.3):
    """The bbox edit of tests/test_editing.py: the content of a shell of
    radius 0.36 around (0, 0.1, 0) moved by dy in y, recoloured in HSV."""
    t = np.eye(4)
    t[1, 3] = dy
    gr = np.random.default_rng(3).normal(size=(256, 3))
    gr /= np.linalg.norm(gr, axis=-1, keepdims=True)
    shell = gr * 0.36 + np.array([0, 0.1, 0])
    return {"type": "bbox", "raw": shell.tolist(), "transform": t.tolist(),
            "scale": [1, 1, 1], "boundType": "both", "hsv": list(hsv)}


def scene(dynamic, package=make_synthetic_scene):
    """(train, val) of the synthetic scene at 32 px (the port's datasets;
    package=the reference's make_synthetic_scene for its own, which hold
    the same images)."""
    return package(n_train=6, n_val=2, res=32, dynamic=dynamic)[1:]


def port_options(ws, dynamic, **kw):
    base = dict(iters=TEACHER_STEPS, num_rays=256, bound=1.0, dt_gamma=0.0,
                update_extra_interval=8, segment_steps=16, workspace=ws,
                eval_interval=1000, **NARROW)
    if dynamic:
        base.update(lr_net=1e-3, dyn_anneal_steps=0,
                    time_curriculum_steps=0)
    base.update(kw)
    return TrainOptions(**base)


def train_port_teacher(ws, dynamic):
    """A narrow teacher trained TEACHER_STEPS steps by the port on the CPU;
    its full checkpoint is written to ws/checkpoints. Returns the trainer."""
    gen = torch.Generator().manual_seed(0)
    if dynamic:
        field = make_cp_dnerf_field(gen, CPDNeRFConfig(**DYN_FIELD))
        w = field.params["deform_mlp"]["w"]
        w[-1] = w[-1] * 1e3
    else:
        field = make_cp_field(gen, CPConfig(**STATIC_FIELD))
    tr = FastTrainer("ngp", port_options(ws, dynamic), field, workspace=ws,
                     use_checkpoint="scratch", device="cpu",
                     time_conditioned=dynamic)
    train, _ = scene(dynamic)
    tr.train(train, None, max_epochs=TEACHER_STEPS // 16)
    assert tr.global_step == TEACHER_STEPS
    return tr


def jax_options(ws, **kw):
    return JaxOptions(**{**dict(
        iters=TEACHER_STEPS, num_rays=256, bound=1.0, dt_gamma=0.0,
        update_extra_interval=8, segment_steps=16, workspace=ws,
        eval_interval=1000, **NARROW), **kw})


def jax_teacher(ws, dynamic):
    """The JAX FastTrainer of the port teacher's latest checkpoint in ws."""
    if dynamic:
        field = jax_dyn_field(jax.random.PRNGKey(0), JaxDynConfig(**DYN_FIELD))
    else:
        field = jax_cp_field(jax.random.PRNGKey(0), JaxCPConfig(**STATIC_FIELD))
    tr = JaxFastTrainer("ngp", jax_options(ws + "_jax"), field,
                        workspace=ws + "_jax", use_checkpoint="scratch",
                        time_conditioned=dynamic)
    ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
    tr.load_checkpoint(os.path.join(ws, "checkpoints", ckpts[-1]))
    return tr


def mappers(cfg, ws=""):
    """(JAX mapper, port mapper) of one config."""
    return jseal.get_seal_mapper(ws, cfg), tseal.get_seal_mapper(ws, cfg)
