"""BENCHMARK.json and the files it names: the contract's keys and limits,
every cell's files found by name, the configuration files holding the
configurations that the program's CLI runs, and the modules that a run and
the reference load."""

import json
import os
import re
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["nerfbench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            # the cell reports the metric that this one moves
            mv = [x for x in b["end_to_end"] if x["name"] == m["moves"]][0]
            assert w in mv.get("workloads", [w])
        if m["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_found_by_name(cell):
    from nerfbench import harness
    c = harness.Cell(cell)
    assert hasattr(c.loop_module(), "Loop")
    assert hasattr(c.field_module(), "build_trainer")
    assert set(c.limits) >= {"loss_gap", "grad_gap", "change_gap",
                             "grid_occ_miss", "grid_query_shortfall"}
    assert c.end_to_end and c.per_layer
    for m in c.per_layer:
        assert callable(c.metric_reader(m["name"]))


def test_configs_are_what_the_cli_runs():
    """Each configuration file's field is the one that its flags give
    through the program's CLI (its defaults)."""
    from nerfbench import harness
    from sealdnerf_tpu_torch import cli, main_dnerf
    from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig,
                                               parse_planes)
    for c in bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        dynamic = "multires_deform" in cfg["field"]
        argv = cfg["cli"] + ["--device", "cpu"]
        if dynamic:
            opt, cls = main_dnerf.parse_args(argv), CPDNeRFConfig
        else:
            opt = cli.postprocess(cli.base_parser().parse_args(argv))
            cls = CPConfig
        run = cls(bound=opt.bound, planes=parse_planes(opt.planes,
                                                       opt.bound))
        fields = {k: getattr(run, k) for k in run.__dataclass_fields__}
        want = {k: ([list(x) for x in v] if k in ("scales", "planes")
                    else v) for k, v in fields.items()}
        assert cfg["field"] == want, c["name"]
        assert not cfg.get("options"), "the cells run the CLI's options"
        assert c["reduced"] == cfg["reduced"] == []
        assert cfg["model"] == "cp"
        assert harness.load_module(BENCH, "fields", "cp").param_shapes(
            cfg["field"])


def _modules_of(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


FORBIDDEN = {"jax", "jaxlib", "flax", "sealdnerf_tpu"}


def test_a_run_loads_no_jax(tiny_bench):
    """A whole (tiny, CPU) run, its check and its traced slice load no
    module whose top-level name is jax's or the JAX package's."""
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        f"sys.path.insert(0, {os.path.dirname(tiny_bench)!r})\n"
        "import nerfbench.run\n"
        "from nerfbench import harness\n"
        f"c = harness.Cell('tiny_dyn.train', {tiny_bench!r})\n"
        "harness.run_cell(c, 5, 0.5, True, 'cpu', time.perf_counter())\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    mods = _modules_of(code)
    assert "sealdnerf_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import nerfbench.reference.field, nerfbench.reference.render, "
            "nerfbench.reference.train, nerfbench.reference.grid\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            "\n")
    mods = _modules_of(code)
    assert not mods & (FORBIDDEN | {"sealdnerf_tpu_torch"})


def test_run_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "cp_static.view1080", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
