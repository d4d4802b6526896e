"""On the card (`-m gpu`; each test skips where torch sees no CUDA
device): a short run of every cell through the command is correct, and
the control and the planted faults are not; a language model at the
published widths and 2 layers is correct in process."""
import json
import subprocess
import sys

import pytest

from portbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CAPS_CELLS = [c for c in CELLS if spec.family(spec.cell(c).config) == "capsnet"]
LM_CELL = "mixtral_8x22b_w8a8_14L-offline"


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
@pytest.mark.parametrize("cell", CAPS_CELLS)
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


@pytest.mark.gpu
def test_lm_at_published_widths_two_layers_is_correct():
    _card()
    from portbench import lm_harness
    c = spec.cell(LM_CELL)
    cell = spec.Cell(**{**c.__dict__, "config": {**c.config,
                                                  "num_layers": 2}})
    res, det = lm_harness.run_cell(cell, 2 ** 33 + 29, 1.0, False)
    assert res["correct"] is True, res["checks"]
    assert det["waves"] >= 1 and res["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_lm_traced_two_layers_reads_every_metric():
    """A traced LM run at the published widths and 2 layers reads every
    per-layer metric, both rooflines within 100 %, and the program's
    routes against the reference's."""
    _card()
    from portbench import lm_harness
    c = spec.cell(LM_CELL)
    cell = spec.Cell(**{**c.__dict__, "config": {**c.config,
                                                  "num_layers": 2}})
    res, det = lm_harness.run_cell(cell, 2 ** 33 + 31, 1.0, True)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    for name in ("w8a8_bmm_roofline.offline", "w8a8_dense_roofline.offline"):
        assert 0 < res["metrics"][name]["value"] <= 100
    # read, not held: the W8A8 program's routes part from the float32
    # reference's (16.5 % of them at 2 layers on the card, PERF.md)
    assert 0 <= det["route_mismatch"]["route_mismatch"] <= 1
    steps = det["profiled_steps"] + 1
    assert det["exponent_flips"]["inputs"] == steps * (4 * 2 + 1)
    assert sum(det["experts_hit_per_moe_call"].values()) == steps * 2
    assert res["device"]["busy_s"] > 0

