"""BENCHMARK.json against the benchmark's contract, and each
configuration, workload and metric found by name in a file of its own,
a new one added without editing a file that is there."""
import json
import re
import shutil

import pytest

from portbench import spec
from portbench.lm_data import Waves
from portbench.loadgen import Traffic

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_used_and_files_load():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = spec.load_config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["name"] in used


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_and_reports(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] == 1
    c = spec.cell(cell)
    (Waves if spec.family(c.config) == "lm" else Traffic).of(c.traffic)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_entry_and_reader(metric):
    m = next(m for m in METRICS if m["name"] == metric)
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m.get("workloads", [])) <= set(CELLS)
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and "bound" not in m
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert callable(spec.reader(metric))


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_new_cell_config_and_metric_are_files(tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    and new entries, no existing file edited, are found by name."""
    pkg = tmp_path / "portbench"
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    cfg = json.loads((pkg / "configs" / "capsnet_mnist_L.json").read_text())
    cfg["name"] = "capsnet_smallnorb_M"
    cfg.update(input_shape=[32, 32, 2], conv_filters=[32], num_classes=5)
    (pkg / "configs" / "capsnet_smallnorb_M.json").write_text(json.dumps(cfg))
    (pkg / "workloads" / "capsnet_smallnorb_M-bulk.json").write_text(
        json.dumps({"kind": "closed", "refill_to": 64,
                    "buckets": [1, 4, 16, 64], "pool": 1024}))
    (pkg / "metrics" / "extra.count.bulk.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "capsnet_smallnorb_M", "source": "x",
                             "file": "portbench/configs/capsnet_smallnorb_M.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "capsnet_smallnorb_M-bulk",
                               "config": "capsnet_smallnorb_M",
                               "traffic": "bulk", "chips": 1, "why": "x"})
    bench["end_to_end"][1]["workloads"].append("capsnet_smallnorb_M-bulk")
    bench["per_layer"].append({"name": "extra.count.bulk", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "engine", "moves": "images_per_s",
                               "workloads": ["capsnet_smallnorb_M-bulk"]})
    c = spec.cell("capsnet_smallnorb_M-bulk", bench, pkg)
    assert c.config["num_classes"] == 5
    assert Traffic.of(c.traffic).wave_buckets() == (64,)
    assert [m["name"] for m in c.per_layer] == ["extra.count.bulk"]
    assert spec.reader("extra.count.bulk", pkg)(None) == 42.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.cell("no_such_cell")
