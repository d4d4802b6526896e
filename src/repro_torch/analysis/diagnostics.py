"""Structured findings for the static verifier (repro_torch.analysis),
the same records, check ids and messages as the reference's.

Every check in this package reports problems as `Diagnostic` records —
machine-readable (check id, op index, op name, tensor id, numeric
detail) so the mutation-corpus tests can pin WHICH defect was found
WHERE, and printable so a human reading `export_caps` output sees one
line per finding instead of a bit-mismatch at verify time.

`CheckResult` aggregates the diagnostics of one subject (a program, a
plan, an arena); `raise_if_failed()` turns a non-clean result into a
`CheckError`.  `CheckError` subclasses BOTH `AssertionError` (so the
CLIs' existing "verification failed -> exit 1" handlers catch it) and
`ValueError` (so importer callers that treat a bad `.capsbin` as a
malformed-artifact error keep working).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: which check fired, where, and the offending values.

    `check` ids are dotted `<module>.<rule>` slugs (e.g.
    "ranges.acc-overflow", "plan.out-shift-mismatch", "arena.overlap") —
    stable strings tests and tooling match on.
    """
    check: str
    message: str
    op_index: int | None = None     # schedule position, when op-scoped
    op_name: str | None = None      # e.g. "conv0", "caps"
    tensor: int | None = None       # offending tensor id, when known
    detail: tuple = ()              # sorted (key, value) pairs

    @classmethod
    def of(cls, check: str, message: str, *, op_index=None, op_name=None,
           tensor=None, **detail) -> "Diagnostic":
        return cls(check=check, message=message, op_index=op_index,
                   op_name=op_name, tensor=tensor,
                   detail=tuple(sorted(detail.items())))

    def __str__(self) -> str:
        where = []
        if self.op_index is not None:
            where.append(f"op[{self.op_index}]")
        if self.op_name:
            where.append(self.op_name)
        if self.tensor is not None:
            where.append(f"tid={self.tensor}")
        loc = " ".join(where)
        extra = "".join(f" {k}={v}" for k, v in self.detail)
        return f"{self.check}: {loc + ': ' if loc else ''}" \
               f"{self.message}{extra}"


@dataclasses.dataclass
class CheckResult:
    """All diagnostics one verification pass produced for `subject`."""
    subject: str
    diagnostics: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags) -> None:
        self.diagnostics.extend(diags)

    def by_check(self, check: str) -> list:
        """The findings of one rule (tests pin op/tensor through this)."""
        return [d for d in self.diagnostics if d.check == check]

    def format(self) -> str:
        if self.ok:
            return f"[{self.subject}] static checks clean"
        lines = [f"[{self.subject}] {len(self.diagnostics)} static "
                 f"finding(s):"]
        lines += [f"  {d}" for d in self.diagnostics]
        return "\n".join(lines)

    def raise_if_failed(self) -> "CheckResult":
        if not self.ok:
            raise CheckError(self)
        return self


class CheckError(AssertionError, ValueError):
    """A static check failed.  Carries the full `CheckResult`."""

    def __init__(self, result: CheckResult):
        self.result = result
        super().__init__(result.format())
