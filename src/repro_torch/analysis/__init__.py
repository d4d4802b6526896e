"""Static verification for the port's edge stack, the counterpart of
the reference's `repro.analysis` with the same checks, check ids,
messages and order:

    from repro_torch.analysis import check_program
    check_program(lower(qnet)).raise_if_failed()

Submodules: `ranges` (interval/overflow proofs), `plancheck` (Qm.n
shift algebra), `arenacheck` (arena aliasing), `checker` (the one-call
program verifier).  The reference's `repolint` is a lint of the
repository's sources, not of a program, and has no counterpart here.
"""
from repro_torch.analysis.arenacheck import check_arena
from repro_torch.analysis.checker import check_program, check_structure
from repro_torch.analysis.diagnostics import (CheckError, CheckResult,
                                              Diagnostic)
from repro_torch.analysis.plancheck import check_pipeline_plan
from repro_torch.analysis.ranges import annotate_acc_bounds, check_ranges

__all__ = ["CheckError", "CheckResult", "Diagnostic", "annotate_acc_bounds",
           "check_arena", "check_pipeline_plan", "check_program",
           "check_ranges", "check_structure"]
