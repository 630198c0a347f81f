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


# ------------------------------------------- Instant-NGP / D-NeRF teachers
# Narrow widths (4 levels, 2^12 entries a level, 32-wide towers, a 2 x 32
# deform tower) at the edit CLIs' defaults: bound 2, dt_gamma 1/128, two
# cascades, on a 16^3 grid; the static field with the background sphere.
NGP_NARROW = dict(num_levels=4, log2_hashmap_size=12, hidden_dim=32,
                  hidden_dim_color=32)
NGP_FIELD = dict(bound=2.0, bg_radius=4.0, **NGP_NARROW)
DNERF_FIELD = dict(bound=2.0, num_layers_deform=2, hidden_dim_deform=32,
                   **NGP_NARROW)
NGP_GRID = dict(grid_size=16, max_steps=256)
NGP_TEACHER_STEPS = 32


def ngp_options(cls, ws, dynamic, **kw):
    """Options of a narrow NGP-family trainer (cls: either package's
    TrainOptions). The dynamic grid refreshes every 8 steps."""
    base = dict(iters=NGP_TEACHER_STEPS, num_rays=256, bound=2.0,
                update_extra_interval=64 if dynamic else 8, segment_steps=16,
                eval_interval=1000, workspace=ws, lr=1e-2, **NGP_GRID)
    if dynamic:
        base.update(lr_net=1e-3)
    else:
        base.update(bg_radius=NGP_FIELD["bg_radius"])
    base.update(kw)
    return cls(**base)


def ngp_field(dynamic, seed=0):
    """A seeded narrow field of the port: D-NeRF (deform) or Instant-NGP."""
    from sealdnerf_tpu_torch.models.api import make_dnerf_field, \
        make_ngp_field
    from sealdnerf_tpu_torch.models.dnerf import DNeRFConfig
    from sealdnerf_tpu_torch.models.ngp import NGPConfig
    gen = torch.Generator().manual_seed(seed)
    if dynamic:
        return make_dnerf_field(gen, DNeRFConfig(**DNERF_FIELD))
    return make_ngp_field(gen, NGPConfig(**NGP_FIELD))


def jax_ngp_field(dynamic, seed=0):
    from sealdnerf_tpu.models.api import make_dnerf_field, make_ngp_field
    from sealdnerf_tpu.models.dnerf import DNeRFConfig
    from sealdnerf_tpu.models.ngp import NGPConfig
    key = jax.random.PRNGKey(seed)
    if dynamic:
        return make_dnerf_field(key, DNeRFConfig(**DNERF_FIELD))
    return make_ngp_field(key, NGPConfig(**NGP_FIELD))


def train_ngp_teacher(ws, dynamic):
    """A narrow NGP-family teacher trained NGP_TEACHER_STEPS steps by the
    port's Trainer on the CPU (training in the JAX package would spend
    most of a test's time compiling); its full checkpoint is in
    ws/checkpoints."""
    from sealdnerf_tpu_torch.train.trainer import Trainer
    tr = Trainer("ngp", ngp_options(TrainOptions, ws, dynamic),
                 ngp_field(dynamic), workspace=ws, use_checkpoint="scratch",
                 device="cpu", time_conditioned=dynamic)
    train, _ = scene(dynamic)
    tr.train(train, None, max_epochs=NGP_TEACHER_STEPS // 16)
    assert tr.global_step == NGP_TEACHER_STEPS
    return tr


def jax_ngp_teacher(ws, tt):
    """The JAX package's Trainer on one device holding the port teacher
    tt's params (carried across by models/params.py) and grid state."""
    from sealdnerf_tpu.parallel.mesh import make_mesh
    from sealdnerf_tpu.train.trainer import Trainer as JaxTrainer
    from sealdnerf_tpu_torch.models.params import params_to_numpy
    dynamic = tt.time_conditioned
    jt = JaxTrainer("ngp", ngp_options(JaxOptions, ws, dynamic),
                    jax_ngp_field(dynamic), workspace=ws,
                    use_checkpoint="scratch",
                    mesh=make_mesh(jax.devices()[:1]),
                    time_conditioned=dynamic)
    jt.params = jax.tree_util.tree_map(jax.numpy.asarray,
                                       params_to_numpy(tt.params))
    jt.field.params = jt.params
    jt.grid_state = {k: jax.numpy.asarray(v.numpy())
                     for k, v in tt.grid_state.items()}
    return jt


def edit_points(mj, n=3000, seed=0, bound=1.0):
    """Points [N, 3] half in [-bound, bound]^3, half in the edit's fill
    bounds, away from the edit mesh's faces (where the two packages' inside
    tests may disagree), and unit directions."""
    from sealdnerf_tpu.editing.geometry import points_mesh_distance
    rng = np.random.default_rng(seed)
    b = np.asarray(mj.map_data["force_fill_bound"])
    pts = np.concatenate([rng.uniform(-bound, bound, (n // 2, 3)),
                          rng.uniform(b[:, 0].min(0), b[:, 1].max(0),
                                      (n - n // 2, 3))]).astype(np.float32)
    far = np.asarray(points_mesh_distance(
        jax.numpy.asarray(pts), jax.numpy.asarray(mj.map_triangles))) > 1e-4
    pts = pts[far]
    d = rng.normal(size=pts.shape).astype(np.float32)
    return pts, d / np.linalg.norm(d, axis=-1, keepdims=True)


def ngp_teachers(tmp_path_factory):
    """For a module-scoped fixture: get(dynamic) -> (workspace, port
    teacher, JAX teacher), trained once per module; the port teacher's
    checkpoint is in workspace/teacher."""
    cache = {}

    def get(dynamic):
        if dynamic not in cache:
            ws = str(tmp_path_factory.mktemp("dnerf" if dynamic else "ngp"))
            tt = train_ngp_teacher(ws + "/teacher", dynamic)
            cache[dynamic] = (ws, tt, jax_ngp_teacher(ws + "/jt", tt))
        return cache[dynamic]
    return get


def port_ngp_student(tt, ws, mapper, **kw):
    """The port's StudentTrainer on a copy of the teacher tt, with its grid
    state; kw go to its options."""
    from sealdnerf_tpu_torch.editing.student import StudentTrainer
    from sealdnerf_tpu_torch.models.params import map_params
    dynamic = tt.time_conditioned
    field = ngp_field(dynamic, seed=1)
    field.params = map_params(lambda t: t.detach().clone(), tt.params)
    st = StudentTrainer("ngp", ngp_options(TrainOptions, ws, dynamic, **kw),
                        field, tt, mapper=mapper, workspace=ws,
                        use_checkpoint="scratch", device="cpu",
                        time_conditioned=dynamic)
    st.adopt_grid_state(tt.grid_state)
    return st


def jax_ngp_student(jt, ws, mapper, **kw):
    """The JAX package's StudentTrainer (one device) on a copy of the
    teacher jt, with its grid state."""
    from sealdnerf_tpu.editing.student import StudentTrainer as JaxStudent
    from sealdnerf_tpu.parallel.mesh import make_mesh
    dynamic = jt.time_conditioned
    field = jax_ngp_field(dynamic, seed=1)
    field.params = jax.tree_util.tree_map(lambda x: x.copy(), jt.params)
    js = JaxStudent("ngp", ngp_options(JaxOptions, ws, dynamic, **kw), field,
                    jt, mapper=mapper, workspace=ws,
                    use_checkpoint="scratch", time_conditioned=dynamic,
                    mesh=make_mesh(jax.devices()[:1]))
    js.params = field.params
    js.grid_state = jax.tree_util.tree_map(lambda x: x.copy(), jt.grid_state)
    return js
