"""On the card, at each cell's own size: the program's run passes its
check, and the control (the reference in float8 in the program's place)
and each fault that the cell can have fail it. Marked `cuda`: they skip
without a card.

    python3 -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        nerfbench/tests/test_nerfbench_card.py

(run from the checkout's root; --noconftest keeps the repository's tests/
conftest, which imports JAX, out; this file's fixtures are its own.)
"""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

pytestmark = pytest.mark.cuda

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.fixture
def device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _fails(reading: dict, limits: dict) -> bool:
    return any(reading[k] > limits[k] for k in limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_the_check(device, name):
    from nerfbench import calibrate, harness
    cell = harness.Cell(name)
    r = calibrate.readings(cell, 2 ** 31 + 101, 4.0, device)
    assert not _fails(r["program"], cell.limits), r["program"]
    assert _fails(r["control"], cell.limits), r["control"]
    for fault in ("fault_unchanged", "fault_half_batch", "fault_altered",
                  "fault_sparser_grid"):
        if fault in r:
            assert _fails(r[fault], cell.limits), (fault, r[fault])
