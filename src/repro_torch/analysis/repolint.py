"""AST-based repo lint for the rules a generic linter can't know; the
counterpart of `repro.analysis.repolint`, with the same rules, findings
and exit codes, checked against the port's variant registry.

    PYTHONPATH=src python -m repro_torch.analysis.repolint src/repro_torch [more paths...]

Rules:

  shim-import
      ROADMAP: "never build against the compat shims".  New code must
      not import `repro.core.capsnet`, `repro.core.capsnet_q7` or
      `repro.quant.ptq` — frozen translation layers over the reference's
      typed API, which the port does not carry (it has no shims).
      Allowed locations: anything under `tests/`, `nn/compat.py`, and
      the shim modules themselves.

  unregistered-variant-string
      Operator-variant references are validated registry keys
      (`repro_torch.nn.variants.REGISTRY`), but a string literal passed
      as `softmax_impl=` / `squash_impl=` / `softmax=` / `squash=` (or
      to `REGISTRY.get/validate("softmax", "...")`) only fails at run
      time.  This rule rejects unknown literals at lint time.

Exit status 1 when any finding survives the allow-list, 0 when clean.
Needs no JAX: it parses sources and reads the port's registry.
"""
from __future__ import annotations

import ast
import dataclasses
import sys
from pathlib import Path

SHIM_MODULES = ("repro.core.capsnet", "repro.core.capsnet_q7",
                "repro.quant.ptq")
# (package, submodule) pairs for `from repro.core import capsnet` forms
_SHIM_FROM = {("repro.core", "capsnet"), ("repro.core", "capsnet_q7"),
              ("repro.quant", "ptq")}
_ALLOWED_SUFFIXES = ("nn/compat.py", "core/capsnet.py",
                     "core/capsnet_q7.py", "quant/ptq.py")
_VARIANT_KWARGS = {"softmax_impl": "softmax", "squash_impl": "squash",
                   "softmax": "softmax", "squash": "squash"}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def _shim_allowed(path: str) -> bool:
    p = Path(path).as_posix()
    return "tests" in Path(p).parts or p.endswith(_ALLOWED_SUFFIXES)


def _registry():
    from repro_torch.nn.variants import REGISTRY
    return REGISTRY


def _is_shim(module: str) -> bool:
    return any(module == s or module.startswith(s + ".")
               for s in SHIM_MODULES)


def _iter_shim_imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _is_shim(alias.name):
                    yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            if _is_shim(node.module):
                yield node.lineno, node.module
            else:
                for alias in node.names:
                    if (node.module, alias.name) in _SHIM_FROM:
                        yield node.lineno, f"{node.module}.{alias.name}"


def _iter_variant_strings(tree):
    """(lineno, kind, name) for every string-literal variant reference."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            kind = _VARIANT_KWARGS.get(kw.arg)
            if kind and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                yield kw.value.lineno, kind, kw.value.value
        # REGISTRY.get("softmax", "name") / .validate / .is_registered
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("get", "validate", "is_registered") \
                and len(node.args) >= 2 \
                and all(isinstance(a, ast.Constant)
                        and isinstance(a.value, str)
                        for a in node.args[:2]) \
                and node.args[0].value in ("softmax", "squash"):
            yield node.args[1].lineno, node.args[0].value, \
                node.args[1].value


def lint_source(source: str, path: str) -> list:
    """All findings in one file's source text."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "syntax-error", str(e.msg))]
    findings = []
    if not _shim_allowed(path):
        for line, module in _iter_shim_imports(tree):
            findings.append(Finding(
                path, line, "shim-import",
                f"import of compat shim {module!r} — build against the "
                f"typed API (repro.nn / repro.quant.qformat) instead; "
                f"only tests/ and nn/compat.py may touch shims"))
    for line, kind, name in _iter_variant_strings(tree):
        if not _registry().is_registered(kind, name):
            findings.append(Finding(
                path, line, "unregistered-variant-string",
                f"{kind} variant {name!r} is not registered in "
                f"nn.variants.REGISTRY "
                f"(have: {', '.join(_registry().names(kind))})"))
    return findings


def lint_paths(paths) -> list:
    """Lint every .py file under the given files/directories."""
    findings = []
    for p in paths:
        p = Path(p)
        files = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in files:
            findings.extend(lint_source(f.read_text(), str(f)))
    return findings


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    paths = argv or ["src"]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    scanned = ", ".join(paths)
    if findings:
        print(f"[repolint] {len(findings)} finding(s) in {scanned}")
        return 1
    print(f"[repolint] clean: {scanned}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
