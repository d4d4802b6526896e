"""On the card (`-m gpu`; each test skips where torch sees no CUDA
device): a short run of every cell through the command is correct, and
the control and the planted faults are not."""
import json
import subprocess
import sys

import pytest

from portbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    _card()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 33 + 17), "--seconds", "2", "--trace", "0"],
        cwd=str(spec.ROOT), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_on_the_card(cell):
    _card()
    from portbench import control
    out = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", cell,
         "--seeds", "5", "--seconds", "2", "--faults"],
        cwd=str(spec.ROOT), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert {r["in_place"] for r in rows} == {"control_int4", "fault_alter",
                                             "fault_half"}
    assert not any(r["correct"] for r in rows), control.__doc__
