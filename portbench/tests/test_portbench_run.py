"""Whole runs on the CPU (the harness's look for a card skipped: the
`torch` backend in the program's place of the `cuda` one), at a small
pool: the result's keys, the comparison passing on the program and
failing on the control and on each planted fault, no module of JAX or
the JAX package loaded, and a new metric reading a span that the harness
does not name."""
import functools
import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import faults, harness, spec

TINY = {"name": "tiny", "input_shape": [16, 16, 1],
        "conv_filters": [8], "conv_kernels": [5], "conv_strides": [2],
        "pcap_caps": 4, "pcap_dim": 4, "pcap_kernel": 3, "pcap_stride": 2,
        "num_classes": 4, "caps_dim": 4, "routings": 2}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _cell(per_layer=None):
    c = spec.cell("capsnet_mnist_L-bulk")
    traffic = {"kind": "closed", "refill_to": 16, "buckets": [1, 4, 16],
               "pool": 32}
    return spec.Cell(name="tiny-bulk", config_name="tiny", chips=1,
                     config=TINY, traffic=traffic, end_to_end=c.end_to_end,
                     per_layer=c.per_layer if per_layer is None
                     else per_layer)


def _run(cell, seed=12345, trace=False, seconds=0.6):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            backend="torch")


@pytest.mark.parametrize("trace", [False, True])
def test_program_is_correct_and_result_keys(trace):
    res, det = _run(_cell(), trace=trace)
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert det["compared"] > 0 and res["attempted"] == det["sent"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = [m["name"] for m in (_cell().per_layer if trace
                                 else _cell().end_to_end)]
    assert set(res["metrics"]) <= set(names)
    if not trace:
        assert "setup_s" in res["metrics"]
        assert len(res["metrics"]) == 2
    else:
        assert {"ptq_s", "wave.execute_ms.bulk",
                "engine.host_ms_per_wave.bulk"} <= set(res["metrics"])
    assert set(det["setup_parts_s"]) == {"imports", "device_init",
                                         "kernels_load", "draw", "ptq",
                                         "warmup", "rest"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_new_metric_reads_any_span(tmp_path, monkeypatch):
    """A metric added as a file reads a span (`serve.complete`, a wave's
    completions) that the harness names nowhere; one that reads the
    profile finds nothing to read on the CPU and is left out."""
    pkg = tmp_path / "portbench"
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (pkg / "metrics" / "engine.complete_ms.bulk.py").write_text(
        "def read(run):\n"
        "    t = (run.spans or {}).get('serve.complete')\n"
        "    return sum(t) / len(t) * 1e3 if t else None\n")
    (pkg / "metrics" / "engine.enqueue_ranges.bulk.py").write_text(
        "def read(run):\n"
        "    if run.profile is None:\n"
        "        return None\n"
        "    return float(sum(1 for r in run.profile.host_ranges\n"
        "                     if r[0] == 'serve.enqueue'))\n")
    monkeypatch.setattr(spec, "reader",
                        functools.partial(spec.reader, pkg=pkg))
    extra = tuple({"name": n, "unit": "ms"} for n in (
        "engine.complete_ms.bulk", "engine.enqueue_ranges.bulk"))
    res, det = _run(_cell(per_layer=extra), trace=True)
    assert res["correct"]
    assert res["metrics"]["engine.complete_ms.bulk"]["value"] > 0
    assert "engine.enqueue_ranges.bulk" not in res["metrics"]


def test_mnist_cell_at_its_geometry():
    c = spec.cell("capsnet_mnist_L-bulk")
    c = spec.Cell(**{**c.__dict__, "traffic": {**c.traffic, "pool": 16,
                                               "refill_to": 4,
                                               "buckets": [4]}})
    res, det = _run(c, seconds=0.3)
    assert res["correct"] and det["compared"] >= 4


def test_control_fails():
    with faults.control():
        res, _ = _run(_cell())
    assert res["correct"] is False
    assert res["checks"]["vq_mismatch"]["value"] > 0


@pytest.mark.parametrize("kind", ["alter", "half"])
def test_planted_fault_fails(kind):
    with faults.fault(kind):
        res, _ = _run(_cell())
    assert res["correct"] is False


def test_no_jax_module_loaded():
    """A CPU run in a fresh interpreter loads no top-level `jax`, `jaxlib`,
    `flax` or `repro` (compared whole: `repro_torch` is the port)."""
    code = textwrap.dedent("""
        import json, sys
        sys.path[:0] = ["src", "."]
        import portbench.run, portbench.control
        from portbench.tests.test_portbench_run import _cell, _run
        _run(_cell())
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(spec.ROOT),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.nn", sys)
    assert "repro" in harness.forbidden_modules()


def test_run_py_refuses_without_card_or_sources(tmp_path):
    """No card here: exit code not 0, no result line.  In a directory with
    only BENCHMARK.json and portbench/: the same."""
    import shutil
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "capsnet_mnist_L-bulk", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=str(spec.ROOT), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "portbench")
    out = subprocess.run(cmd, cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout
