"""Candidate evaluation: one spec -> scored, verified `Candidate` (the
port of the reference's `repro.search.objective`).

The objective is where the search meets every verification layer the
port has.  A candidate is only `ok` if its lowered program passes the
static checker (`repro_torch.analysis.check_program`), its probed int8
run shows no int32 clipping and bounded saturation
(`repro_torch.obs.numerics`, the EdgeVM on the host), and the static
bounds actually contained the observed extremes (`check_containment`).
Scoring covers the paper's three axes — accuracy (`captrain.eval_q7`,
on the space's device and backend: the kernels on the card), memory
(`edge.arena`), and estimated MCU latency (`edge.costmodel`) — plus
`flash_packed_bytes`, the virtual-bit-packed weight footprint that makes
Q-CapsNets-style frac reduction visible as a memory win even though the
on-device container stays int8.  Every metric is a plain Python int or
float, so a doc dumps as the reference's does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch import obs
from repro_torch.analysis import check_program
from repro_torch.captrain.evalq import eval_q7
from repro_torch.edge import lower, total_latency_ms
from repro_torch.edge.arena import memory_report
from repro_torch.obs.numerics import check_containment, run_numerics
from repro_torch.search.space import CandidateSpec, SearchSpace

# reject candidates whose worst per-site saturation rate exceeds this
# (the numerics telemetry's "red" band; the default plan sits well below)
SAT_THRESHOLD = 0.35


def flash_packed_bytes(program) -> int:
    """Flash footprint with each weight blob packed at its *virtual*
    bit-width: the smallest signed width (>= 2 bits) holding the blob's
    actual int range.  Frac-bit reduction shrinks the occupied grid, so
    this is the memory axis where Q-CapsNets-style coarsening pays off
    — the int8-container `flash_bytes` only credits per-tensor pruning.
    Attr tables (the non-weight flash) are counted as-is."""
    packed = 0
    for op in program.ops:
        for w in op.weights.values():
            if w.dtype == np.int8:
                peak = int(np.abs(w.astype(np.int32)).max())
                bits = max(2, 1 + math.ceil(math.log2(peak + 1))) \
                    if peak else 2
                packed += math.ceil(int(w.size) * bits / 8)
            else:                       # int32 bias etc.: container width
                packed += int(w.nbytes)
    return int(packed + (program.flash_bytes - program.weight_bytes))


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One evaluated spec: metrics + the verification verdict.  Rejected
    candidates keep their metrics (when computable) so the result doc
    shows *why* the space's edges are infeasible."""
    spec: CandidateSpec
    metrics: dict
    ok: bool
    reject_reason: str = ""

    def to_json(self) -> dict:
        return {"spec": self.spec.to_json(), "metrics": self.metrics,
                "ok": self.ok, "reject_reason": self.reject_reason}


class Objective:
    """Scores specs against one trained network + eval set, caching by
    spec identity so strategies can revisit points for free (the budget
    counts *unique* evaluations)."""

    def __init__(self, space: SearchSpace, images, labels, *,
                 rounding: str = "floor", numerics_n: int = 64,
                 sat_threshold: float = SAT_THRESHOLD, qat_eval=None):
        self.space = space
        self.images = np.asarray(images)
        self.labels = np.asarray(labels)
        self.rounding = rounding
        self.numerics_n = numerics_n
        self.sat_threshold = sat_threshold
        self.qat_eval = qat_eval        # spec -> QAT-refined accuracy
        self.cache: dict = {}
        self.evaluations = 0            # unique (non-cached) evaluations

    def evaluate(self, spec: CandidateSpec) -> Candidate:
        if spec.key in self.cache:
            return self.cache[spec.key]
        with obs.span("search.candidate", spec=spec.key):
            with obs.span("search.evaluate"):
                cand = self._evaluate(spec)
        self.evaluations += 1
        self.cache[spec.key] = cand
        return cand

    def _evaluate(self, spec: CandidateSpec) -> Candidate:
        qnet = self.space.build_qnet(spec, rounding=self.rounding)
        program = lower(qnet)
        metrics: dict = {}

        result = check_program(program)
        metrics["checker_findings"] = len(result.diagnostics)
        if not result.ok:
            return Candidate(spec, metrics, False,
                             "static checker: " + "; ".join(
                                 str(d) for d in result.diagnostics[:3]))

        mem = memory_report(program)
        metrics.update(
            flash_bytes=int(mem["flash_bytes"]),
            flash_packed_bytes=flash_packed_bytes(program),
            ram_bytes=int(mem["ram_bytes"]),
            arena_bytes=int(mem["arena_bytes"]),
            est_ms_m7=float(total_latency_ms(program, "cortex-m7")),
            est_ms_gap8=float(total_latency_ms(program, "gap8")))

        # probed pass: saturation/clip telemetry + q7-vs-f32 SNR, and the
        # static ranges must have contained what actually happened
        health = run_numerics(qnet, self.images[:self.numerics_n],
                              params=self.space.params, program=program)
        metrics.update(
            int32_clip=int(health.total_int32_clip()),
            sat_rate=float(health.worst_saturation_rate()),
            snr_db=float(health.min_snr_db()))
        if metrics["int32_clip"] > 0:
            return Candidate(spec, metrics, False,
                             f"numerics: {metrics['int32_clip']} int32 "
                             f"clip events")
        if metrics["sat_rate"] > self.sat_threshold:
            return Candidate(spec, metrics, False,
                             f"numerics: saturation {metrics['sat_rate']:.3f}"
                             f" > {self.sat_threshold}")
        contain = check_containment(program, health)
        if contain:
            return Candidate(spec, metrics, False,
                             "containment: " + "; ".join(contain[:3]))

        metrics["acc"] = float(eval_q7(qnet, self.images, self.labels))
        if self.qat_eval is not None:   # optional QAT-refined face
            metrics["acc_qat"] = float(self.qat_eval(spec))
        return Candidate(spec, metrics, True)
