"""The port stands alone: `src/repro_torch`, `chip_smoke.py` and the
port's examples (`examples/torch_*.py`) import neither JAX nor anything
of the reference package `repro`, the serving entry point and the
examples import in a process where both are blocked, and every entry
point asked for the default device on a host without a GPU raises instead
of quietly running on the CPU.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.launch import serve_caps
from repro_torch.nn import EDGE_TINY, CapsPipeline
from repro_torch.serving import ModelRegistry, default_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_or_reference_import_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
    assert len(files) > 20 and len(EXAMPLES) == 4
    bad = {str(p.relative_to(ROOT)): sorted(imported_roots(p) & set(FORBIDDEN))
           for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_port_imports_with_jax_and_the_reference_blocked():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{m!r}] = None" for m in FORBIDDEN),
        "import importlib",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "import repro_torch.launch.serve_caps",
        "import repro_torch.launch.serve",
        "import repro_torch.models.transformer",
        "import importlib.util",
        f"for p in {[str(p) for p in EXAMPLES]!r}:",
        "    spec = importlib.util.spec_from_file_location('ex', p)",
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "assert not any(m.split('.')[0] in " + repr(FORBIDDEN)
        + " for m in sys.modules if sys.modules[m] is not None)",
        "print('ok', len(" + repr(modules) + "))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_a_gpu_raises(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CapsPipeline.from_config(EDGE_TINY).init(torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_specs()["edge_tiny@torch"].build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_caps.main(["--model", "edge_tiny@torch", "--requests", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_the_lm_entry_points_default_to_the_card(no_gpu):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps, train
    from repro_torch.launch.train import reduced
    from repro_torch.models.transformer import build_model
    cfg = reduced(get_config("qwen3_14b"), d_model=64)
    for call in (lambda: serve.serve(cfg, requests=1, prompt_len=4, gen=2),
                 lambda: serve.main(["--requests", "1", "--gen", "2"]),
                 lambda: build_model(cfg).init(torch.Generator()),
                 lambda: train.main(["--reduce", "--d-model", "64",
                                     "--steps", "1"]),
                 lambda: steps.init_train_state(cfg, torch.Generator())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_the_artifact_entry_points_default_to_the_card(no_gpu, tmp_path):
    from repro_torch.edge import load_qnet, lower, to_qnet
    from repro_torch.launch import export_caps
    reg = ModelRegistry({"e": default_specs()["edge_tiny@torch"]},
                        device="cpu")
    program = lower(reg.model("e"))
    path = program.save(tmp_path / "e")["capsbin"]
    for call in (lambda: to_qnet(program), lambda: load_qnet(path),
                 lambda: ModelRegistry(specs={}).install_artifact(path),
                 lambda: export_caps.main(["--out", str(tmp_path / "o")]),
                 lambda: serve_caps.main(["--capsbin", str(path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert to_qnet(program, device="cpu").backend == "torch"


def test_the_search_entry_points_default_to_the_card(no_gpu, tmp_path):
    from repro_torch.launch import export_caps, search_caps
    from repro_torch.search import SearchConfig, run_search, save_doc
    doc = run_search(SearchConfig(budget=2, float_steps=1, eval_n=8,
                                  calib_n=8, numerics_n=8, verify_n=1),
                     device="cpu")
    save_doc(doc, tmp_path / "doc.json")
    for call in (
            lambda: search_caps.main(["--out", str(tmp_path / "s.json")]),
            lambda: run_search(SearchConfig(budget=2, float_steps=1)),
            lambda: export_caps.main(["--from-search",
                                      str(tmp_path / "doc.json"),
                                      "--out", str(tmp_path / "o")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "s.json").exists()
    assert not (tmp_path / "o").exists()


def test_chip_smoke_alone_fails_without_printing_a_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes(
        (ROOT / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_the_examples_default_to_the_card(no_gpu, tmp_path):
    """Each example's `main` with its default device raises before it
    draws a weight or writes a file."""
    import importlib.util
    argv = {"torch_quickstart": [],
            "torch_train_capsnet": ["--dataset", "edge_tiny", "--steps", "1",
                                    "--ckpt-dir", str(tmp_path / "c")],
            "torch_serve_quantized_lm": ["--d-model", "64", "--gen", "2"],
            "torch_train_lm": ["--params", "1e6", "--steps", "1",
                               "--ckpt-dir", str(tmp_path / "l")]}
    assert sorted(argv) == [p.stem for p in EXAMPLES]
    for path in EXAMPLES:
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(argv[path.stem])
    assert not any(tmp_path.iterdir())
