"""The six CLIs with --gui --device cpu, at narrow sizes.

main_nerf (train and --test), main_dnerf (train and --test) and main_seald
open their viewers on the port's trainers, on the headless dearpygui
backend (dearpygui is not installed here), and reach the viewer's frame
loop: the frame cap of the headless backend is set as the viewport opens.
main_SealNeRF, main_tensoRF and main_CCNeRF have no viewer in the reference
either; with --gui they run as without it and say so in one line.

Narrow sizes: the port-trained teachers of tests/torch_edit_setup.py served
from their checkpoints (a CP field takes the checkpoint's shapes), their
32^3 grid and 16^3 march, a 32 x 24 viewer, the synthetic scene at 32 px.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_edit_setup as setup
from sealdnerf_tpu_torch import (cli, main_CCNeRF, main_dnerf, main_nerf,
                                 main_SealNeRF, main_seald, main_tensoRF)
from sealdnerf_tpu_torch.gui import headless_dpg as hdpg

FRAMES = 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """teachers(dynamic) -> the workspace of a narrow teacher trained by the
    port (its checkpoint under checkpoints/)."""
    cache = {}

    def get(dynamic):
        if dynamic not in cache:
            ws = str(tmp_path_factory.mktemp("dyn" if dynamic else "static"))
            setup.train_port_teacher(ws, dynamic)
            cache[dynamic] = ws
        return cache[dynamic]
    return get


@pytest.fixture
def viewer_loop(monkeypatch):
    """Caps the headless frame loop at FRAMES as the viewport opens and
    records, per viewer, the frames run and the texture last shown."""
    runs = []
    show, destroy = hdpg.show_viewport, hdpg.destroy_context

    def capped():
        show()
        hdpg.configure(max_frames=FRAMES)

    def record():
        s = hdpg._S
        runs.append((s.frame_count, s.items["_texture"].value,
                     [it.label for it in s.items.values()]))
        destroy()
    monkeypatch.setattr(hdpg, "show_viewport", capped)
    monkeypatch.setattr(hdpg, "destroy_context", record)
    return runs


def _narrow(fn):
    return lambda opt, **kw: fn(opt, **kw, **setup.NARROW)


VIEW = ["--W", "32", "--H", "24", "--radius", "2", "--synthetic_res", "32",
        "--device", "cpu"]


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["nerf", "dnerf"])
def test_main_nerf_and_dnerf_open_their_viewers(teachers, viewer_loop,
                                               monkeypatch, tmp_path,
                                               dynamic, mode):
    mod = main_dnerf if dynamic else main_nerf
    monkeypatch.setattr(mod, "build_trainer", _narrow(cli.build_trainer))
    src = teachers(dynamic)
    ckpt = sorted(os.listdir(os.path.join(src, "checkpoints")))[-1]
    argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--gui",
            "--ckpt", os.path.join(src, "checkpoints", ckpt),
            "--workspace", str(tmp_path)] + VIEW
    if mode == "test":
        argv.append("--test")
    trainer = mod.main(argv)
    assert trainer.time_conditioned == dynamic
    assert trainer.global_step == setup.TEACHER_STEPS   # no training
    [(frames, tex, labels)] = viewer_loop
    assert frames == FRAMES
    assert tex.shape == (24, 32, 3) and np.isfinite(tex).all()
    assert tex.min() < 0.99                      # the teacher is in view
    assert ("start" in labels) == (mode == "train")
    assert ("time" in labels) == dynamic
    # no test frames: the viewer replaced the CLI's serving
    assert not os.path.exists(os.path.join(str(tmp_path), "results"))


def test_main_seald_opens_the_editor(teachers, viewer_loop, monkeypatch,
                                     tmp_path):
    monkeypatch.setattr(main_seald, "build_edit_trainers",
                        _narrow(cli.build_edit_trainers))
    src = teachers(True)
    st = main_seald.main(["synthetic", "-O", "--bound", "1", "--dt_gamma",
                          "0", "--gui", "--teacher_workspace", src,
                          "--workspace", str(tmp_path)] + VIEW)
    assert st.time_conditioned and st.mapper is None and st.global_step == 0
    [(frames, tex, labels)] = viewer_loop
    assert frames == FRAMES and tex.min() < 0.99
    assert {"brush", "start edit", "override teacher", "time"} <= set(labels)


def test_the_clis_without_a_viewer_run(teachers, monkeypatch, tmp_path,
                                       capsys):
    """main_SealNeRF, main_tensoRF and main_CCNeRF with --gui run as without
    it (here their shortest runs: --test, or a few steps)."""
    monkeypatch.setattr(main_SealNeRF, "build_edit_trainers",
                        _narrow(cli.build_edit_trainers))
    ws = str(tmp_path / "seal")
    os.makedirs(ws)
    with open(os.path.join(ws, "seal.json"), "w") as f:
        json.dump(setup.seal_config(), f)
    st = main_SealNeRF.main(["synthetic", "-O", "--bound", "1", "--dt_gamma",
                             "0", "--gui", "--test", "--teacher_workspace",
                             teachers(False), "--workspace", ws] + VIEW)
    assert len([f for f in os.listdir(os.path.join(ws, "results"))
                if f.endswith(".png")]) == 6 and not st.time_conditioned
    for mod in (main_tensoRF, main_CCNeRF):
        monkeypatch.setattr(mod, "to_train_options",
                            lambda opt, _f=mod.to_train_options, **kw: _f(
                                opt, **kw, grid_size=32, segment_steps=8))
    monkeypatch.setattr(main_tensoRF, "UPSAMPLE_STEPS", ())
    base = ["synthetic", "--gui", "--device", "cpu", "--synthetic_res", "32",
            "--num_rays", "64", "--max_steps", "128", "--ckpt", "scratch",
            "--iters", "8"]
    tr = main_tensoRF.main(base + ["--workspace", str(tmp_path / "tf"),
                                   "--resolution0", "16", "--resolution1",
                                   "16"])
    assert tr.global_step > 0 and np.isfinite(tr.history["loss"]).all()
    tr = main_CCNeRF.main(base + ["--workspace", str(tmp_path / "cc"),
                                  "--rank", "4"])
    assert tr.global_step > 0 and np.isfinite(tr.history["loss"]).all()
    out = capsys.readouterr().out
    for name in ("main_SealNeRF", "main_tensoRF", "main_CCNeRF"):
        assert f"[INFO] {name} has no viewer, as in the reference: --gui " \
            "is ignored" in out
