"""What `BENCHMARK.json` names, found by name in files of their own.

  * a configuration: `configs/<config>.json`, the geometry as it is run
    (a CapsNet's, or with `"family": "lm"` a language model's sizes, its
    block kinds' references in `references/<kind>.py`);
  * a cell: the `workloads` entry of `BENCHMARK.json` (configuration,
    traffic label, chips) and `workloads/<cell>.json`, the parameters the
    one traffic generator (`loadgen.py`) reads;
  * a metric: `metrics/<metric>.py`, whose `read(run)` returns a number,
    or None where the run holds nothing for it to read.

Adding a cell, a configuration or a metric adds files and entries; no
file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
CONFIG_KEYS = ("input_shape", "conv_filters", "conv_kernels", "conv_strides",
               "pcap_caps", "pcap_dim", "pcap_kernel", "pcap_stride",
               "num_classes", "caps_dim", "routings")
# a language model's (`"family": "lm"`): the port's architecture it runs
# and every size the plain reference reads
LM_KEYS = ("arch", "precision", "num_layers", "d_model", "num_heads",
           "num_kv_heads", "head_dim", "d_ff", "vocab_size", "blocks",
           "norm_eps", "rope_theta")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # workloads/<cell>.json
    end_to_end: tuple       # metric entries of BENCHMARK.json this cell reports
    per_layer: tuple


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def family(cfg: dict) -> str:
    """A configuration's family: "lm" where its file says so, else the
    CapsNet's."""
    return cfg.get("family", "capsnet")


def load_config(name: str, pkg: Path = PKG) -> dict:
    cfg = load_json(pkg / "configs" / f"{name}.json")
    keys = LM_KEYS if family(cfg) == "lm" else CONFIG_KEYS
    missing = [k for k in keys if k not in cfg]
    if missing:
        raise ValueError(f"configuration {name} lacks {missing}")
    return cfg


def load_traffic(cell: str, pkg: Path = PKG) -> dict:
    return load_json(pkg / "workloads" / f"{cell}.json")


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric with no list is read in every cell that reports
    # the end-to-end metric it moves; an end-to-end one in every cell
    moves = metric.get("moves")
    return moves is None or moves in e2e_of_cell


def cell(name: str, bench: dict | None = None, pkg: Path = PKG) -> Cell:
    bench = benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}; cells: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = entries[0]
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name, set()))
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"]
                      if _reports(m, name, names))
    return Cell(name=name, config_name=w["config"], chips=int(w["chips"]),
                config=load_config(w["config"], pkg),
                traffic=load_traffic(name, pkg), end_to_end=e2e,
                per_layer=per_layer)


def reader(metric: str, pkg: Path = PKG):
    """`read` of metrics/<metric>.py (loaded by path: a metric's name
    may hold dots)."""
    path = pkg / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
