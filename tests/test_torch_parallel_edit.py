"""The Seal edits of the CP field on the port's data mesh, at 2 ranks of a
gloo mesh on the CPU (tests/torch_parallel_ranks.py spawns them), against
the port on one rank and the JAX package's unsharded StudentTrainer.
test_torch_parallel_edit_ngp.py runs the same checks on the Instant-NGP
student, test_torch_parallel_edit_cli.py the edit CLIs.

Narrow teachers trained by the port (tests/torch_edit_setup.py): the CP
field, static and dynamic, with the bbox edit of the reference's own
tests, their proxies marching at most MAX_STEPS samples a ray; the
teacher's point queries in chunks of QUERY_CHUNK points, so that the 2
ranks share them.

Tolerances:
- share, gather_shares and broadcast_object: exact, the same on every
  rank.
- The proxy of the val views: the 2-rank proxy equal to the 1-rank proxy
  bit for bit, and on both ranks; against the reference's proxy_dataset
  max |diff| <= 2e-2 (test_torch_edit_teacher.py::
  test_proxy_dataset_matches, test_torch_ngp_edit.py).
- The zones (points, directions, the teacher's sigma and colour, the
  weights): the 2-rank zones equal to the 1-rank zones bit for bit.
- One pretraining step on a full batch and on a padded last batch: the
  same bits on both ranks; against the reference's jitted unsharded step
  on the whole batch the tolerances of test_torch_ngp_edit.py::
  test_one_pretraining_step_matches: loss rtol 1e-4, the encoder tables
  within 1e-4 apart from the entries whose reference gradient lies within
  f32 noise of 0 (at most 1 % of them: Adam's first step moves an entry by
  the lr times the sign of its gradient, and two ranks' partial sums round
  the gradient of an entry that both touch in another order), the other
  leaves unchanged.
- One distillation step of the dynamic CP student (and of the Instant-NGP
  student) on given per-rank batches: params, EMA and Adam moments within
  1e-6 of one Adam step on the mean of the two one-rank gradients
  (test_torch_parallel_train.py), the same bits on both ranks, the frozen
  deform leaves the teacher's bit for bit.
"""

import contextlib
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.editing.student import StudentTrainer as JaxStudent
from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig
from sealdnerf_tpu.models.cp import CPDNeRFConfig as JaxDynConfig
from sealdnerf_tpu.models.cp import make_cp_dnerf_field as jax_dyn_field
from sealdnerf_tpu.models.cp import make_cp_field as jax_cp_field
from sealdnerf_tpu.ops.pallas_field import (make_fused_dyn_train_forward,
                                            make_fused_train_forward)
from sealdnerf_tpu.train.fast import FastTrainer as JaxFastTrainer
from sealdnerf_tpu_torch.editing.student import freeze_labels
from sealdnerf_tpu_torch.models.params import (map_params, param_leaves,
                                               params_to_numpy)
from sealdnerf_tpu_torch.train.trainer import TrainOptions

import torch_edit_setup as setup
import torch_parallel_ranks as ranks

FRAME_TOL = 2e-2
STEP_TOL = 1e-4
FLIP_SHARE = 1e-2
DISTIL_ATOL = 1e-6
QUERY_CHUNK = 700
PRE_BATCH = 1024
ZONES = dict(local_point_step=0.05, surrounding_point_step=0.1,
             global_point_step=0.5)
KINDS = ("cp_static", "cp_dynamic")
MAX_STEPS = 128
GATHERS = (5, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread, as each rank runs, so that the one-rank runs here sum
    in the ranks' order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def threads(n):
    """n torch threads inside (the teachers' training, which nothing
    compares bit for bit)."""
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def _distil_batches(dynamic, seed):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(2):
        n = 64
        xy = rng.uniform(-0.3, 0.3, (n, 2))
        d = np.concatenate([xy, np.ones((n, 1))], 1)
        b = {"rays_o": np.tile(np.array([[0.05 * r, 0.0, -2.0]]), (n, 1))
             .astype(np.float32),
             "rays_d": (d / np.linalg.norm(d, axis=1, keepdims=True))
             .astype(np.float32),
             "gt": rng.random((n, 3)).astype(np.float32),
             "bg": np.ones(3, np.float32),
             "noise": rng.random(n).astype(np.float32)}
        if dynamic:
            b["t"] = np.float32(setup.TIME_FRAME)
            b["x_reg"] = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
        out.append(b)
    return out


def build_env(root, kinds, gathers=()):
    """The teachers of `kinds` (trained here), the spec of the ranks, their
    2-rank results and the one-rank results of the same. The CP teachers
    and their students march at most MAX_STEPS samples a ray in the proxy
    (as the reference's teacher does in _jax_cp_student)."""
    spec_kinds, teachers = {}, {}
    for kind in kinds:
        ws = str(root / kind)
        dynamic = kind == "cp_dynamic"
        if kind == "ngp":
            with threads(2):
                tt = setup.train_ngp_teacher(ws + "/teacher", False)
            field = setup.NGP_FIELD
            topt = setup.ngp_options(TrainOptions, ws + "/teacher", False)
            sopt = setup.ngp_options(TrainOptions, ws + "/s", False)
        else:
            with threads(2):
                tt = setup.train_port_teacher(ws + "/teacher", dynamic)
            field = setup.DYN_FIELD if dynamic else setup.STATIC_FIELD
            topt = setup.port_options(ws + "/teacher", dynamic,
                                      max_steps=MAX_STEPS)
            sopt = setup.port_options(ws + "/s", dynamic,
                                      max_steps=MAX_STEPS)
        teachers[kind] = tt
        spec_kinds[kind] = {"dynamic": dynamic, "cp": kind != "ngp",
                            "field": dict(field),
                            "teacher_opts": dataclasses.asdict(topt),
                            "student_opts": dataclasses.asdict(sopt)}
    distil = {"cp_dynamic": _distil_batches(True, 5),
              "ngp": _distil_batches(False, 6)}
    spec = {"kinds": spec_kinds, "seal": setup.seal_config(),
            "time_frame": setup.TIME_FRAME, "query_chunk": QUERY_CHUNK,
            "pre_batch": PRE_BATCH, "zones": ZONES,
            "pre_batches": [("local", 0), ("local", -1)],
            "distil": {k: v for k, v in distil.items() if k in kinds},
            "gathers": gathers}
    runs = ranks.run_ranks(ranks.edit_checks, 2, root, spec)
    one = {}
    for kind in kinds:
        _, st = ranks.edit_teacher_and_student(spec, kind)
        assert st.ndev == 1
        proxy = st.proxy_dataset(ranks.edit_val(spec, kind))
        zones, steps = ranks.edit_pretraining(st, spec)
        one[kind] = {"proxy": proxy.images, "zones": zones, "steps": steps,
                     "student": st}
    return {"root": root, "spec": spec, "runs": runs, "one": one,
            "teachers": teachers}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return build_env(tmp_path_factory.mktemp("edit"), KINDS, GATHERS)


def test_shares_gather_and_broadcast(env):
    """share / gather_shares of ragged items (n = 5, and n = 1: rank 1
    holds none) and broadcast_object, in the ranks of the edit."""
    r0, r1 = (r["gathers"] for r in env["runs"])
    for n in GATHERS:
        assert r0[n]["share"] == list(range(0, n, 2))
        assert r1[n]["share"] == list(range(1, n, 2))
        want = [np.arange(3 * (i % 3 + 1), dtype=np.float32).reshape(-1, 3)
                + 10 * i for i in range(n)]
        for got in (r0[n]["gathered"], r1[n]["gathered"]):
            assert len(got) == n
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert r0[n]["object"] == r1[n]["object"] == {"rank": 0,
                                                      "call": ("x", (1,))}


def _jax_cp_student(env, kind):
    dynamic = env["spec"]["kinds"][kind]["dynamic"]
    ws = str(env["root"] / kind)
    # setup.jax_teacher at MAX_STEPS
    jt = JaxFastTrainer("ngp", setup.jax_options(ws + "/jt",
                                                 max_steps=MAX_STEPS),
                        (jax_dyn_field if dynamic else jax_cp_field)(
                            jax.random.PRNGKey(0),
                            JaxDynConfig(**setup.DYN_FIELD) if dynamic
                            else JaxCPConfig(**setup.STATIC_FIELD)),
                        workspace=ws + "/jt", use_checkpoint="scratch",
                        time_conditioned=dynamic)
    ckpts = sorted(os.listdir(os.path.join(ws, "teacher", "checkpoints")))
    jt.load_checkpoint(os.path.join(ws, "teacher", "checkpoints", ckpts[-1]))
    mj, _ = setup.mappers(setup.seal_config())
    cfg = JaxDynConfig(**setup.DYN_FIELD) if dynamic \
        else JaxCPConfig(**setup.STATIC_FIELD)
    field = (jax_dyn_field if dynamic else jax_cp_field)(
        jax.random.PRNGKey(1), cfg)
    field.params = jax.tree_util.tree_map(lambda x: x.copy(), jt.params)
    js = JaxStudent("ngp", setup.jax_options(ws + "/js"), field, jt,
                    mapper=mj, workspace=ws + "/js",
                    use_checkpoint="scratch", time_conditioned=dynamic)
    js.params = field.params
    js.grid_state = jax.tree_util.tree_map(lambda x: x.copy(), jt.grid_state)
    js.time_frame = setup.TIME_FRAME if dynamic else None
    # the reference's pretraining step through its kernels (interpret mode)
    js.field.forward = (make_fused_dyn_train_forward if dynamic
                        else make_fused_train_forward)(cfg, interpret=True,
                                                       tile=256)
    return js


def _jax_student(env, kind):
    if kind != "ngp":
        return _jax_cp_student(env, kind)
    ws = str(env["root"] / kind)
    jt = setup.jax_ngp_teacher(ws + "/jt", env["teachers"][kind])
    mj, _ = setup.mappers(setup.seal_config())
    return setup.jax_ngp_student(jt, ws + "/js", mj)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_proxy_is_the_one_rank_proxy(env, kind):
    check_proxy(env, kind)


def check_proxy(env, kind):
    """The 2 ranks' proxy (each rendered 1 of the 2 val views) equals the
    one-rank proxy bit for bit on both ranks, and the reference's within
    its tolerance."""
    got = [r[kind]["proxy"] for r in env["runs"]]
    one = env["one"][kind]["proxy"]
    assert got[0].shape == one.shape == (2, 32, 32, 3)
    for g in got:
        assert g.tobytes() == one.tobytes()
    if kind == "cp_dynamic":
        for r in env["runs"]:
            np.testing.assert_array_equal(r[kind]["times"],
                                          np.full(2, setup.TIME_FRAME))
    js = _jax_student(env, kind)
    val = setup.scene(env["spec"]["kinds"][kind]["dynamic"])[1]
    ref = js.proxy_dataset(val, time=js.time_frame)
    diff = np.abs(got[0] - np.asarray(ref.images)).max()
    print(f"{kind}: proxy max |2 ranks - reference| {diff:.3g}")
    assert diff <= FRAME_TOL


@pytest.mark.parametrize("kind", KINDS)
def test_gathered_zones_are_the_one_rank_zones(env, kind):
    check_zones(env, kind)


def check_zones(env, kind):
    got = [r[kind]["zones"] for r in env["runs"]]
    one = env["one"][kind]["zones"]
    assert set(one) == {"local", "surrounding", "global"}
    # the queries of the larger zones were split over the ranks by chunk
    sizes = {z: int(w["weight"].sum()) for z, w in one.items()}
    assert max(sizes.values()) > 2 * QUERY_CHUNK, sizes
    for zone, want in one.items():
        for g in got:
            assert set(g[zone]) == set(want)
            for k, v in want.items():
                assert g[zone][k].tobytes() == v.tobytes(), (zone, k)


@pytest.mark.parametrize("kind", KINDS)
def test_two_rank_pretraining_step_is_the_unsharded_step(env, kind):
    check_pretraining_step(env, kind)


def check_pretraining_step(env, kind):
    """The first batch of the local zone (whole) and its padded last batch,
    each one step from the student's params, on 2 ranks against the
    reference's jitted step on the whole batch."""
    runs, spec = env["runs"], env["spec"]
    st = env["one"][kind]["student"]
    js = _jax_student(env, kind)
    js.pretraining_lr = st.pretraining_lr
    js._build_pretrain_step()
    before = map_params(np.copy, params_to_numpy(st.params))
    jparams = jax.tree_util.tree_map(jnp.asarray, before)
    labels = freeze_labels(st.params)
    t = jnp.float32(js.time_frame or 0.0)
    zones = runs[0][kind]["zones"]
    for j, (zone, i) in enumerate(spec["pre_batches"]):
        a, b = runs[0][kind]["steps"][j], runs[1][kind]["steps"][j]
        assert a["loss"] == b["loss"]
        for x, y in zip(a["params"], b["params"]):
            assert x.tobytes() == y.tobytes()
        batch = {k: v[i] for k, v in zones[zone].items()}
        pad = int((batch["weight"] == 0).sum())
        assert (pad > 0) == (i == -1), (zone, i, pad)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        new_j, _, loss_j = js._pretrain_step_fn(jparams, js._pretrain_state,
                                                jbatch, t)
        np.testing.assert_allclose(a["loss"], float(loss_j), rtol=STEP_TOL)
        # the reference's gradient, to name the entries whose sign is noise
        g_j = jax.grad(lambda p: _jax_l1(js, p, jbatch, t))(jparams)
        after = iter(a["params"])
        for k in sorted(before):
            for ref, p, g in zip(jax.tree_util.tree_leaves(new_j[k]),
                                 jax.tree_util.tree_leaves(before[k]),
                                 jax.tree_util.tree_leaves(g_j[k])):
                got = next(after)
                if labels[k] != "enc":
                    np.testing.assert_array_equal(got, p, err_msg=k)
                    continue
                off = np.abs(got - np.asarray(ref)) > STEP_TOL
                g = np.abs(np.asarray(g))
                assert not (off & ~(g <= 1e-5 * g.max())).any(), (zone, k)
                assert off.mean() <= FLIP_SHARE, (zone, k, off.mean())
        assert next(after, None) is None


def _jax_l1(js, params, batch, t):
    """The reference's pretraining loss (editing/student.py:357-366)."""
    extra = (t,) if js.time_conditioned else ()
    out = js.field.forward(params, batch["points"], batch["dirs"], *extra)
    w = batch["weight"]
    l_sig = jnp.sum(jnp.abs(out[0] - batch["sigma"]) * w) / \
        jnp.maximum(jnp.sum(w), 1.0)
    l_col = jnp.sum(jnp.abs(out[1] - batch["color"]) * w[:, None]) / \
        jnp.maximum(jnp.sum(w) * 3, 1.0)
    return l_sig + l_col


def test_distillation_step_is_the_mean_gradient_step(env):
    check_distillation_step(env, "cp_dynamic")


def check_distillation_step(env, kind):
    spec, runs = env["spec"], env["runs"]
    got = [r[kind]["distil"] for r in runs]
    # one rank: the mean of the two ranks' gradients, one Adam step
    tt, st = ranks.edit_teacher_and_student(spec, kind)
    st._ensure_deform_frozen()
    st.global_step = 1
    leaves = param_leaves(st.params)
    grads, losses = [], []
    for b in spec["distil"][kind]:
        st.optimizer.zero_grad(set_to_none=True)
        loss, _ = st.loss_on(*ranks.distil_batch(b))
        loss.backward()
        grads.append([None if p.grad is None else p.grad.clone()
                      for p in leaves])
        losses.append(float(loss.detach()))
    for p, g0, g1 in zip(leaves, *grads):
        p.grad = None if g0 is None else (g0 + g1) / 2
    st.apply_gradients()
    want = ranks.edit_state(st)
    assert got[0]["loss"] == got[1]["loss"]
    np.testing.assert_allclose(got[0]["loss"], np.mean(losses), rtol=1e-6)
    for key in ("params", "ema", "mu", "nu"):
        for a, b, w in zip(got[0][key], got[1][key], want[key]):
            assert (a is None) == (b is None) == (w is None), key
            if a is None:
                continue
            assert a.tobytes() == b.tobytes(), key
            np.testing.assert_allclose(a, w, atol=DISTIL_ATOL, rtol=0,
                                       err_msg=key)
    # the frozen leaves are the teacher's, and there are some in the
    # dynamic student; the step moved the others
    deform = got[0]["deform"]
    assert (len(deform) > 0) == (kind == "cp_dynamic")
    for a, b in zip(deform, runs[0][kind]["teacher_deform"]):
        assert a.tobytes() == b.tobytes()
    init = param_leaves(ranks.edit_teacher_and_student(spec, kind)[1].params)
    assert any(np.abs(a - b.detach().numpy()).max() > 1e-4
               for a, b in zip(got[0]["params"], init))
