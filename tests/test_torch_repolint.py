"""`repro_torch.analysis.repolint` against `repro.analysis.repolint`: the
same findings, by (path, line, rule) and message, on the reference's
own lint cases and on every source file of both packages; the port's
sources are clean, and the CLI's exit codes are the reference's.
"""
import pathlib
import subprocess
import sys

import pytest

from repro.analysis import repolint as R
from repro_torch.analysis import repolint as T

ROOT = pathlib.Path(__file__).resolve().parents[1]

SHIMS = ("from repro.quant import ptq\n"
         "import repro.core.capsnet_q7\n"
         "from repro.core.capsnet import CAPSNET_CONFIGS\n")
VARIANTS = ('spec = ModelSpec(softmax_impl="turbo")\n'
            'VariantSet(squash="approx")\n'
            'REGISTRY.get("squash", "nope")\n')
# (source, path): the reference's lint cases (tests/test_analysis.py)
CASES = {
    "shims": (SHIMS, "src/repro/somewhere.py"),
    "shims-in-tests": (SHIMS, "tests/test_whatever.py"),
    "shims-in-compat": (SHIMS, "src/repro/nn/compat.py"),
    "variants": (VARIANTS, "src/repro/somewhere.py"),
    "syntax-error": ("def broken(:\n", "src/repro/x.py"),
    "clean": ("x = 1\n", "src/repro_torch/x.py"),
}


def key(findings) -> list:
    return [(f.path, f.line, f.rule, f.message) for f in findings]


@pytest.mark.parametrize("case", sorted(CASES))
def test_lint_source_gives_the_references_findings(case):
    src, path = CASES[case]
    got = T.lint_source(src, path)
    assert key(got) == key(R.lint_source(src, path))
    want_rules = {"shims": ["shim-import"] * 3,
                  "variants": ["unregistered-variant-string"] * 2,
                  "syntax-error": ["syntax-error"]}.get(case, [])
    assert [f.rule for f in got] == want_rules


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_every_source_file_gives_the_references_findings(package):
    files = sorted((ROOT / "src" / package).rglob("*.py"))
    assert len(files) > 40
    for f in files:
        src = f.read_text()
        assert key(T.lint_source(src, str(f))) == \
            key(R.lint_source(src, str(f))), f


def test_the_port_is_clean():
    assert T.lint_paths([ROOT / "src" / "repro_torch"]) == []


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.quant.ptq\n")
    assert T.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "shim-import" in out and "[repolint] 1 finding(s)" in out
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert T.main([str(good)]) == 0
    assert f"[repolint] clean: {good}" in capsys.readouterr().out


def test_module_cli_runs_without_jax():
    """`python -m repro_torch.analysis.repolint src/repro_torch` with JAX
    and the reference blocked, as on a host without them: exit 0."""
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['repolint', 'src/repro_torch']\n"
            "runpy.run_module('repro_torch.analysis.repolint', "
            "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[repolint] clean: src/repro_torch" in proc.stdout
