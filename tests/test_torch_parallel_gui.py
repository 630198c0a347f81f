"""The viewers and the editor on the port's data mesh, at 2 ranks of a gloo
mesh on the CPU (tests/torch_parallel_ranks.py spawns them): rank 0 opens
the view on the headless dearpygui backend and its calls drive rank 1's
controller (gui/follow.py), against the same scripted sessions on one
rank.

The sessions (torch_parallel_ranks.gui_sessions): NeRFGUI serving the
narrow static CP teacher of tests/torch_edit_setup.py (drag, wheel, pan),
then training it (the start button, 3 frames); DNeRFGUI serving the
dynamic teacher with the time slider at 0, 0.5 and 1; SealDGUI at t = 0.5:
the brush, strokes, "start edit", two pretraining frames and a
distillation frame, "override teacher". A 32 x 32 viewer at downscale 1,
its pacing on a clock of 0.1 s a call.

Tolerances: rank 0's served frames (and the editor's frames before the
edit) equal the one-rank session's within image atol 1e-5, the row-band
tolerance of test_torch_parallel.py (a band's shifted principal point
changes the float arithmetic of its rays); every rank's state the same
bits after each session (params, EMA, Adam moments; the trained grid;
after the override the teacher's params the student's); rank 1 has no
view and returns when rank 0's window closes.
"""

import os

import numpy as np
import pytest

import test_torch_parallel_edit as edit
import torch_edit_setup as setup
import torch_parallel_ranks as ranks

IMG_ATOL = 1e-5
TIMEOUT = 600

_one_thread = edit._one_thread


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    root = tmp_path_factory.mktemp("gui")
    spec = {"ws": str(root), "narrow": setup.NARROW}
    for kind, dynamic in (("static", False), ("dynamic", True)):
        ws = str(root / f"{kind}_teacher")
        with edit.threads(2):
            setup.train_port_teacher(ws, dynamic)
        ckpt = sorted(os.listdir(os.path.join(ws, "checkpoints")))[-1]
        spec[kind] = os.path.join(ws, "checkpoints", ckpt)
        spec[f"{kind}_ws"] = ws
    (root / "two").mkdir()
    spec["ws"] = str(root / "two")
    two = ranks.run_ranks(ranks.gui_sessions, 2, root / "two", spec,
                          timeout=TIMEOUT)
    spec["ws"] = str(root / "one")
    one = ranks.gui_sessions(None, spec)
    print({k: (round(two[0][k]["seconds"], 2), round(v["seconds"], 2))
           for k, v in one.items()})
    return two, one


def _same(a, b):
    for x, y in zip(a, b):
        assert (x is None and y is None) or x.tobytes() == y.tobytes()


def _check_state(two, name):
    r0, r1 = two[0][name], two[1][name]
    assert r0["view"] and not r1["view"]
    assert r0["time"] == r1["time"] and r0["step"] == r1["step"]
    for key in ("params", "ema", "mu", "nu"):
        _same(r0[key], r1[key])


@pytest.mark.parametrize("name", ["nerf", "dnerf"])
def test_served_frames_equal_one_rank(sessions, name):
    two, one = sessions
    _check_state(two, name)
    got, want = two[0][name]["frames"], one[name]["frames"]
    assert len(got) == len(want) >= 3
    # the 2 ranks rendered by row bands, the one rank whole
    assert two[0][name]["bands"] >= len(got) and one[name]["bands"] == 0
    for a, b in zip(got, want):
        assert a.shape == (32, 32, 3) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=IMG_ATOL, rtol=0)
    # the camera moves and the time slider changed the frame
    assert np.abs(got[-1] - got[0]).max() > 1e-2
    if name == "dnerf":
        assert two[0][name]["time"] == two[1][name]["time"] == 1.0


def test_training_frames_keep_the_ranks_equal(sessions):
    two, _ = sessions
    _check_state(two, "nerf_train")
    r0, r1 = two[0]["nerf_train"], two[1]["nerf_train"]
    assert r0["step"] > 0
    for k in r0["grid"]:
        assert r0["grid"][k].tobytes() == r1["grid"][k].tobytes(), k


def test_editor_on_two_ranks(sessions):
    two, one = sessions
    _check_state(two, "seald")
    r0, r1 = two[0]["seald"], two[1]["seald"]
    assert r0["time"] == 0.5 and r0["step"] > 0
    assert r0["pretraining"] == r1["pretraining"] == 2
    # the override made the teacher the student, on both ranks
    for r in (r0, r1):
        _same(r["teacher"]["params"], r["params"])
    _same(r0["teacher"]["params"], r1["teacher"]["params"])
    # the frames before the edit (the teacher's preview) are one rank's
    for a, b in zip(r0["frames"][:2], one["seald"]["frames"][:2]):
        np.testing.assert_allclose(a, b, atol=IMG_ATOL, rtol=0)
