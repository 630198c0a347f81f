"""--profile (utils/profiling.py): every CLI of the port with --device cpu
--profile writes a torch.profiler trace of its train and test calls to
<workspace>/trace/rank0.pt.trace.json, a Chrome / Perfetto trace that
parses as JSON and names the run's operators and the program's "sdn."
spans, and the session's tally of spans and counters to
rank0.counters.json; without --profile no trace/ is written. The reference parses --profile and never reads it (ROADMAP,
faults of the reference); here the trace is what its help promises.

Narrow runs: main_nerf and main_dnerf train a few steps of a narrow CP
field on 8 views at 32 px; main_seald and main_SealNeRF serve (--test) a
seeded narrow teacher's checkpoint; main_tensoRF and main_CCNeRF train 8
steps at resolution 16 / rank 4; main_sdf exports a 32^3 mesh of its
seeded network (--test).
"""

import json
import os

import pytest
import torch

from sealdnerf_tpu_torch import (cli, main_CCNeRF, main_dnerf, main_nerf,
                                 main_sdf, main_SealNeRF, main_seald,
                                 main_tensoRF)
from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig,
                                           make_cp_dnerf_field,
                                           make_cp_field)
from sealdnerf_tpu_torch.train.fast import FastTrainer
from sealdnerf_tpu_torch.utils import profiling
from sealdnerf_tpu_torch.utils.profiling import (counters_path,
                                                 profile_trace, trace_path)

import torch_edit_setup as setup

VIEW = ["--device", "cpu", "--synthetic_res", "32"]
CP = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0"] + VIEW


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _narrow(fn, **extra):
    return lambda opt, **kw: fn(opt, **kw, **setup.NARROW, **extra)


def _seeded_teacher(ws, dynamic):
    """A seeded narrow CP teacher's checkpoint in ws (untrained)."""
    gen = torch.Generator().manual_seed(0)
    field = make_cp_dnerf_field(gen, CPDNeRFConfig(**setup.DYN_FIELD)) \
        if dynamic else make_cp_field(gen, CPConfig(**setup.STATIC_FIELD))
    tr = FastTrainer("ngp", setup.port_options(ws, dynamic), field,
                     workspace=ws, use_checkpoint="scratch", device="cpu",
                     time_conditioned=dynamic)
    tr.save_checkpoint(full=True)
    return ws


def _small_scene(opt, with_time=False):
    """cli.load_datasets' synthetic scene cut to 8 training views and 2
    val / test views."""
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    _, train, val = make_synthetic_scene(n_train=8, n_val=2,
                                         res=opt.synthetic_res,
                                         dynamic=with_time)
    return train, val, val


def _run(name, ws, monkeypatch, profile=True):
    """The CLI `name`'s narrow run in ws (with --profile)."""
    flag = ["--profile"] if profile else []
    if name in ("main_nerf", "main_dnerf"):
        mod = main_nerf if name == "main_nerf" else main_dnerf
        monkeypatch.setattr(mod, "build_trainer", _narrow(
            cli.build_trainer, segment_steps=8))
        monkeypatch.setattr(main_nerf, "MESH_RESOLUTION", 32)
        monkeypatch.setattr(mod, "load_datasets", _small_scene)
        return mod.main(CP + flag + ["--ckpt", "scratch", "--iters", "8",
                                     "--num_rays", "64", "--workspace", ws])
    if name in ("main_seald", "main_SealNeRF"):
        mod = main_seald if name == "main_seald" else main_SealNeRF
        monkeypatch.setattr(mod, "build_edit_trainers",
                            _narrow(cli.build_edit_trainers))
        teacher = _seeded_teacher(ws + "_teacher", name == "main_seald")
        os.makedirs(ws, exist_ok=True)
        with open(os.path.join(ws, "seal.json"), "w") as f:
            json.dump(setup.seal_config(), f)
        return mod.main(CP + flag + ["--test", "--max_steps", "64",
                                     "--teacher_workspace", teacher,
                                     "--workspace", ws])
    if name in ("main_tensoRF", "main_CCNeRF"):
        mod = main_tensoRF if name == "main_tensoRF" else main_CCNeRF
        monkeypatch.setattr(mod, "to_train_options",
                            lambda opt, _f=mod.to_train_options, **kw: _f(
                                opt, **kw, grid_size=32, segment_steps=8))
        monkeypatch.setattr(main_tensoRF, "UPSAMPLE_STEPS", ())
        extra = (["--resolution0", "16", "--resolution1", "16"]
                 if name == "main_tensoRF" else ["--rank", "4"])
        return mod.main(["synthetic"] + VIEW + flag + extra + [
            "--num_rays", "64", "--max_steps", "64", "--ckpt", "scratch",
            "--iters", "8", "--workspace", ws])
    return main_sdf.main(["synthetic", "--device", "cpu", "--test",
                          "--mesh_resolution", "32", "--workspace", ws]
                         + flag)


# each CLI and an operator its run must have made
CLIS = {"main_nerf": "Optimizer.step#Adam.step",
        "main_dnerf": "Optimizer.step#Adam.step",
        "main_seald": "aten::mm", "main_SealNeRF": "aten::mm",
        "main_tensoRF": "Optimizer.step#Adam.step",
        "main_CCNeRF": "Optimizer.step#Adam.step", "main_sdf": "aten::mm"}


@pytest.mark.parametrize("name", list(CLIS))
def test_profile_writes_a_trace(name, tmp_path, monkeypatch):
    ws = str(tmp_path / "ws")
    _run(name, ws, monkeypatch)
    path = os.path.join(ws, "trace", "rank0.pt.trace.json")
    assert sorted(os.listdir(os.path.join(ws, "trace"))) == [
        "rank0.counters.json", "rank0.pt.trace.json"]
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert CLIS[name] in names, sorted(n for n in names if n)[:50]
    with open(counters_path(os.path.join(ws, "trace"), 0)) as f:
        tally = json.load(f)
    assert set(tally) == {"counters", "spans"}
    if name in ("main_nerf", "main_dnerf"):
        # the step's backward ran under the trace
        assert any(n and n.startswith("autograd::engine::evaluate_function")
                   for n in names)
        # and so did the program's spans, which the tally counts
        assert {"sdn.step", "sdn.step.backward", "sdn.composite"} <= names
        assert tally["spans"]["step"]["n"] == 8
        k = "k3" if name == "main_dnerf" else "k1"
        assert tally["counters"][k + ".samples"] > 0
    assert profiling.tally() == {"counters": {}, "spans": {}}


def test_no_trace_without_profile(tmp_path, monkeypatch):
    ws = str(tmp_path / "ws")
    tr = _run("main_nerf", ws, monkeypatch, profile=False)
    assert tr.global_step > 0
    assert not os.path.exists(os.path.join(ws, "trace"))


def test_profile_trace_names_its_rank_and_raises(tmp_path):
    """The rank's own file; an exception in the body still writes the
    trace, then propagates."""
    with profile_trace(str(tmp_path), "cpu", rank=3):
        torch.ones(4).sum()
    assert sorted(os.listdir(tmp_path)) == ["rank3.counters.json",
                                            "rank3.pt.trace.json"]
    assert trace_path(str(tmp_path), 3) == str(tmp_path /
                                               "rank3.pt.trace.json")
    assert counters_path(str(tmp_path), 3) == str(tmp_path /
                                                  "rank3.counters.json")
    with pytest.raises(ValueError, match="in the body"):
        with profile_trace(str(tmp_path / "x"), "cpu", rank=0):
            raise ValueError("in the body")
    assert sorted(os.listdir(tmp_path / "x")) == ["rank0.counters.json",
                                                  "rank0.pt.trace.json"]


def test_profile_trace_writes_the_tally_and_resets_it(tmp_path):
    """rank{r}.counters.json holds the session's traced tally (its spans
    and the counters added while it recorded, not before) and the tally is
    empty after it, while the process's counters keep their totals."""
    profiling.count("tracing_test", 5)
    with profile_trace(str(tmp_path), "cpu", rank=1):
        profiling.count("tracing_test", 2)
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
        with profiling.span("inner"):
            pass
    with open(counters_path(str(tmp_path), 1)) as f:
        tally = json.load(f)
    assert tally["counters"] == {"tracing_test": 2}
    assert set(tally["spans"]) == {"outer", "inner"}
    assert tally["spans"]["inner"]["n"] == 2
    assert tally["spans"]["outer"]["n"] == 1
    assert tally["spans"]["outer"]["host_s"] > 0.0
    assert tally["spans"]["outer"]["stream_s"] is None
    assert profiling.tally() == {"counters": {}, "spans": {}}
    assert profiling.tally(traced=False)["counters"]["tracing_test"] >= 7
    with open(trace_path(str(tmp_path), 1)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sdn.outer", "sdn.inner"} <= names
