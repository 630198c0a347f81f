"""main_seald and main_SealNeRF on the port's data mesh, at 2 ranks of a
gloo mesh on the CPU (tests/torch_parallel_ranks.py spawns them), against
the port on one rank.

The CLIs edit the narrow CP teachers of tests/torch_edit_setup.py (dynamic
for main_seald, static for main_SealNeRF) with --device cpu, the bbox edit
of the reference's own tests, one pretraining epoch, one distillation
epoch, and the proxy's march cut to 128 samples a ray (--max_steps).
Tolerances: the proxied images, params and EMA the same bits on both
ranks; one checkpoint, the 6 test frames and timer.json written once; a
one-rank student of the same edit that loads the checkpoint renders the
frame that the 2 ranks render by row bands within image atol 1e-5 and
depth atol 1e-4 (test_torch_parallel.py's row-band tolerances).
"""

import json
import os

import numpy as np
import pytest

from sealdnerf_tpu_torch import cli, main_seald, main_SealNeRF

import test_torch_parallel_edit as edit
import torch_edit_setup as setup
import torch_parallel_ranks as ranks

IMG_ATOL, DEP_ATOL = 1e-5, 1e-4
NARROW = dict(setup.NARROW, segment_steps=16)
CLIS = {"main_seald": (main_seald, True), "main_SealNeRF": (main_SealNeRF,
                                                            False)}


_one_thread = edit._one_thread


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs on 2 ranks -> (root, argv by CLI, each rank's results by
    CLI, the camera)."""
    root = tmp_path_factory.mktemp("edit_cli")
    seal = str(root / "seal.json")
    with open(seal, "w") as f:
        json.dump(setup.seal_config(), f)
    common = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0",
              "--device", "cpu", "--synthetic_res", "32", "--num_rays",
              "128", "--max_steps", "128", "--seal_config", seal,
              "--pretraining_epochs", "1", "--pretraining_batch_size",
              "1024", "--pretraining_local_point_step", "0.05",
              "--pretraining_surrounding_point_step", "0.1",
              "--extra_epochs", "1", "--eval_interval", "1000"]
    argvs, runs = {}, []
    for name, (_, dynamic) in CLIS.items():
        teacher = str(root / name / "teacher")
        with edit.threads(2):
            setup.train_port_teacher(teacher, dynamic)
        argvs[name] = common + [
            "--teacher_workspace", teacher,
            "--workspace", str(root / name / "student")] + (
            ["--time_frame", str(setup.TIME_FRAME)] if dynamic else [])
        runs.append((name, argvs[name], NARROW))
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3], pose[0, 3] = -2.5, 0.2
    intr = np.array([40.0, 40.0, 16.0, 16.0], np.float32)
    out = ranks.run_ranks(ranks.edit_cli, 2, root, runs, pose, intr)
    by_cli = {name: [r[j] for r in out] for j, name in enumerate(CLIS)}
    return root, argvs, by_cli, (pose, intr)


@pytest.mark.parametrize("name", list(CLIS))
def test_edit_cli_on_two_ranks_writes_one_checkpoint(cli_runs, name,
                                                     tmp_path):
    root, argvs, by_cli, (pose, intr) = cli_runs
    r0, r1 = by_cli[name]
    assert r0["ndev"] == r1["ndev"] == 2
    assert r0["img"].tobytes() == r1["img"].tobytes()
    assert r0["proxy"].tobytes() == r1["proxy"].tobytes()
    for key in ("params", "ema", "mu", "nu"):
        for a, b in zip(r0[key], r1[key]):
            assert (a is None and b is None) or a.tobytes() == b.tobytes(), \
                key
    ws = str(root / name / "student")
    ckpts = os.listdir(os.path.join(ws, "checkpoints"))
    assert len(ckpts) == 1, ckpts
    assert len([f for f in os.listdir(os.path.join(ws, "results"))
                if f.endswith(".png")]) == 6
    assert os.path.exists(os.path.join(ws, "timer.json"))
    mod, dynamic = CLIS[name]
    opt = mod.parse_args(argvs[name] + ["--workspace", str(tmp_path)])
    _, st, _ = cli.build_edit_trainers(opt, dynamic=dynamic, **NARROW)
    assert st.ndev == 1
    st.load_checkpoint(os.path.join(ws, "checkpoints", ckpts[0]))
    img, dep = st.render_image(pose, intr, 32, 32, buckets=False)
    np.testing.assert_allclose(r0["img"], img, atol=IMG_ATOL)
    np.testing.assert_allclose(r0["dep"], dep, atol=DEP_ATOL)
    assert img.min() < 0.9 * img.max()
