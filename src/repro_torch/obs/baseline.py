"""Perf baselines: a direction-aware regression gate over
`repro.bench/v1` BENCH_*.json documents — the "regress" leg of the
observe -> analyze -> regress loop, ported from the reference's
`repro.obs.baseline` with the same policy and the same findings.

    PYTHONPATH=src python -m repro_torch.obs.baseline compare RUN_DIR \
        --baselines BASELINE_DIR
    PYTHONPATH=src python -m repro_torch.obs.baseline record RUN_DIR \
        --baselines BASELINE_DIR [--sections serving,edge_vm]

The port has no committed baselines of its own yet, so the baseline
directory is always the caller's: nothing here has a default that
points into the repository.

Tolerance policy (METRIC_POLICY): every gated metric declares a
DIRECTION — "higher" means only a decrease is a regression (img/s,
speedup, occupancy), "lower" means only growth is (latency, us/call),
"exact" means any change is (deterministic counters: waves scheduled,
variant fallbacks) — and a relative tolerance in the bad direction.
Timing tolerances are generous (the trajectory is about catching 2-3x
cliffs, not 10% wobble) and scale with `--slack`; exact metrics never
do.  Metrics without a policy entry are ignored.

Only sections with a baseline are compared; extra sections in the run
are reported as notes, and `record` is the deliberate act that starts
gating one.  An improved number never fails the gate.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import shutil

BENCH_SCHEMA = "repro.bench/v1"


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """Direction-aware relative tolerance for one metric.

    direction: "higher" (better; gate on decrease), "lower" (better;
    gate on increase), or "exact" (deterministic; gate on any change).
    rel: allowed relative change in the bad direction (0.60 on a
    "higher" metric = may regress up to 60%; 1.5 on a "lower" metric =
    may grow up to 150%, i.e. 2.5x).  `timing` marks wall-clock-derived
    metrics whose rel scales with the CLI --slack factor.
    """
    direction: str
    rel: float
    timing: bool = False

    def bound(self, base: float, slack: float) -> float | None:
        """The worst acceptable new value, or None for exact metrics.
        Relative to |base| so negative-valued metrics (snr_db) gate in
        the same direction as positive ones."""
        if self.direction == "exact":
            return None
        rel = self.rel * (slack if self.timing else 1.0)
        if self.direction == "higher":
            return base - abs(base) * min(rel, 1.0)
        return base + abs(base) * rel


# The gated metrics.  Row `us_per_call` is implicitly "lower"/timing
# (US_PER_CALL below); everything else must appear here to be gated.
METRIC_POLICY = {
    # throughput figures: may only regress
    "images_per_s": Tolerance("higher", 0.60, timing=True),
    "speedup": Tolerance("higher", 0.60, timing=True),
    # latency figures: may only grow
    "p95_ms": Tolerance("lower", 1.5, timing=True),
    # accuracy: may only drop, and not by much (seeded eval; the small
    # rel absorbs cross-platform float wobble, not real regressions)
    "acc": Tolerance("higher", 0.05),
    # deterministic scheduling/counter figures: must not move at all
    "occupancy": Tolerance("exact", 0.0),
    "waves": Tolerance("exact", 0.0),
    "total_fallback_decisions": Tolerance("exact", 0.0),
    "default_variant_fallbacks": Tolerance("exact", 0.0),
    "total": Tolerance("exact", 0.0),
    "default": Tolerance("exact", 0.0),
    # deterministic memory-plan figures (edge_vm arena rows)
    "arena_bytes": Tolerance("exact", 0.0),
    "naive_bytes": Tolerance("exact", 0.0),
    "flash_bytes": Tolerance("exact", 0.0),
    "ram_bytes": Tolerance("exact", 0.0),
    # numeric health (numerics rows): saturation may only shrink, SNR
    # may only improve (small rel absorbs float wobble in the f32
    # oracle), int32 clips are proven-impossible and must stay 0
    "saturation_rate": Tolerance("lower", 1.0),
    "snr_db": Tolerance("higher", 0.25),
    "int32_clip": Tolerance("exact", 0.0),
}

US_PER_CALL = Tolerance("lower", 1.5, timing=True)

_EXACT_EPS = 1e-9


def _check_metric(where: str, metric: str, tol: Tolerance,
                  base, new, slack: float) -> list:
    if not isinstance(base, (int, float)) or isinstance(base, bool):
        return []                                # non-numeric: not gated
    if not isinstance(new, (int, float)) or isinstance(new, bool):
        return [f"{where}: {metric} was {base!r}, is now "
                f"non-numeric {new!r}"]
    if tol.direction == "exact":
        if abs(new - base) > _EXACT_EPS + _EXACT_EPS * abs(base):
            return [f"{where}: {metric} changed {base!r} -> {new!r} "
                    "(deterministic metric; any change is a finding — "
                    "re-record the baseline if deliberate)"]
        return []
    bound = tol.bound(base, slack)
    if tol.direction == "higher" and new < bound:
        return [f"{where}: {metric} regressed {base:g} -> {new:g} "
                f"(allowed >= {bound:g}; may regress "
                f"{tol.rel * (slack if tol.timing else 1) * 100:.0f}%)"]
    if tol.direction == "lower" and new > bound:
        return [f"{where}: {metric} grew {base:g} -> {new:g} "
                f"(allowed <= {bound:g}; may grow "
                f"{tol.rel * (slack if tol.timing else 1) * 100:.0f}%)"]
    return []


def compare_docs(base: dict, new: dict, slack: float = 1.0) -> list:
    """Findings from comparing one section's run doc against its
    baseline (empty list = within tolerance)."""
    section = base.get("section", "?")
    where = f"BENCH_{section}"
    findings = []
    if new.get("section") != section:
        return [f"{where}: run doc is for section "
                f"{new.get('section')!r}, baseline for {section!r}"]
    if bool(new.get("smoke")) != bool(base.get("smoke")):
        findings.append(
            f"{where}: smoke={new.get('smoke')!r} run compared against "
            f"smoke={base.get('smoke')!r} baseline — record a matching "
            "baseline instead")
    # section-level figures
    base_figs = base.get("figures", {})
    new_figs = new.get("figures", {})
    for metric, tol in METRIC_POLICY.items():
        if metric in base_figs:
            if metric not in new_figs:
                findings.append(f"{where}: figure {metric!r} "
                                "disappeared from the run")
            else:
                findings += _check_metric(where, metric, tol,
                                          base_figs[metric],
                                          new_figs[metric], slack)
    # rows, joined by name
    new_rows = {r.get("name"): r for r in new.get("rows", [])}
    for brow in base.get("rows", []):
        name = brow.get("name")
        nrow = new_rows.get(name)
        rwhere = f"{where}.{name}"
        if nrow is None:
            findings.append(f"{rwhere}: row disappeared from the run")
            continue
        b_us = brow.get("us_per_call", 0)
        if isinstance(b_us, (int, float)) and b_us > 0:
            findings += _check_metric(rwhere, "us_per_call",
                                      US_PER_CALL, b_us,
                                      nrow.get("us_per_call"), slack)
        bf, nf = brow.get("figures", {}), nrow.get("figures", {})
        for metric, tol in METRIC_POLICY.items():
            if metric in bf:
                if metric not in nf:
                    findings.append(f"{rwhere}: figure {metric!r} "
                                    "disappeared from the run")
                else:
                    findings += _check_metric(rwhere, metric, tol,
                                              bf[metric], nf[metric],
                                              slack)
    return findings


def _load_dir(d) -> dict:
    """section -> parsed BENCH doc, for every BENCH_*.json in `d`."""
    out = {}
    for path in sorted(pathlib.Path(d).glob("BENCH_*.json")):
        doc = json.loads(path.read_text())
        out[doc.get("section", path.stem)] = doc
    return out


def compare_dirs(out_dir, baseline_dir, slack: float = 1.0) -> tuple:
    """(findings, notes) comparing a bench run against the baselines in
    `baseline_dir`.  Sections without a baseline are notes, not findings —
    `record` is what opts a section into the gate."""
    base_docs = _load_dir(baseline_dir)
    new_docs = _load_dir(out_dir)
    findings: list = []
    notes: list = []
    if not base_docs:
        findings.append(f"{baseline_dir}: no BENCH_*.json baselines "
                        "(run `record` first)")
    for section, base in sorted(base_docs.items()):
        new = new_docs.get(section)
        if new is None:
            findings.append(f"BENCH_{section}: baselined section "
                            "missing from the run")
            continue
        findings += compare_docs(base, new, slack=slack)
    for section in sorted(set(new_docs) - set(base_docs)):
        notes.append(f"BENCH_{section}: no baseline committed — not "
                     "gated (record it to start the trajectory)")
    return findings, notes


# ---------------------------------------------------------------------------
# the repro.bench/v1 schema and its deterministic invariants (what a
# document must satisfy before `record` makes it a yardstick)
# ---------------------------------------------------------------------------
KNOWN_SECTIONS = frozenset({
    "quantization", "matmul", "primary_caps", "capsule_layer",
    "serving", "edge_vm", "numerics", "training", "variants",
    "observability", "search",
})

_TOP_KEYS = {"schema": str, "section": str, "stamp": str, "smoke": bool,
             "config": dict, "figures": dict, "rows": list}
_ROW_KEYS = {"name": str, "us_per_call": (int, float), "derived": str,
             "figures": dict}


def validate_doc(doc: dict, where: str) -> list:
    """Schema findings for one parsed artifact (empty list = clean)."""
    findings = []
    for key, typ in _TOP_KEYS.items():
        if key not in doc:
            findings.append(f"{where}: missing key {key!r}")
        elif not isinstance(doc[key], typ):
            findings.append(f"{where}: {key!r} is {type(doc[key]).__name__},"
                            f" wanted {typ}")
    if doc.get("schema") not in (None, BENCH_SCHEMA):
        findings.append(f"{where}: schema {doc.get('schema')!r} != "
                        f"{BENCH_SCHEMA!r}")
    section = doc.get("section")
    if isinstance(section, str) and section not in KNOWN_SECTIONS:
        findings.append(f"{where}: unknown section {section!r}; known: "
                        f"{sorted(KNOWN_SECTIONS)}")
    stamp = doc.get("stamp")
    if isinstance(stamp, str) and not stamp.strip():
        findings.append(f"{where}: empty stamp — the artifact cannot be "
                        "tied back to a commit")
    for i, row in enumerate(doc.get("rows", [])):
        if not isinstance(row, dict):
            findings.append(f"{where}: rows[{i}] is not an object")
            continue
        for key, typ in _ROW_KEYS.items():
            if key not in row:
                findings.append(f"{where}: rows[{i}] missing {key!r}")
            elif not isinstance(row[key], typ):
                findings.append(f"{where}: rows[{i}].{key} is "
                                f"{type(row[key]).__name__}, wanted {typ}")
    return findings


def validate_invariants(doc: dict, where: str) -> list:
    """Deterministic gates (machine-speed independent)."""
    findings = []
    figs = doc.get("figures", {})
    if doc.get("section") == "serving":
        for row in doc.get("rows", []):
            if not str(row.get("name", "")).startswith("serve_batched_"):
                continue
            occ = row.get("figures", {}).get("occupancy")
            if not isinstance(occ, (int, float)) or not occ > 0:
                findings.append(
                    f"{where}: {row.get('name')}: occupancy {occ!r} "
                    "is not > 0 (engine served nothing?)")
    if doc.get("section") == "observability":
        dflt = figs.get("default_variant_fallbacks")
        if dflt != 0:
            findings.append(
                f"{where}: default_variant_fallbacks == {dflt!r}, "
                "wanted 0 — the kernels no longer cover the default "
                "softmax/squash plan")
    if doc.get("section") == "numerics":
        clips = figs.get("int32_clip_total")
        if clips != 0:
            findings.append(
                f"{where}: int32_clip_total == {clips!r}, wanted 0 — "
                "runtime int32 clipping contradicts the static range "
                "proofs (analysis.ranges)")
    if doc.get("section") == "search":
        points = figs.get("frontier_points")
        if not isinstance(points, int) or points < 1:
            findings.append(
                f"{where}: frontier_points == {points!r}, wanted >= 1 — "
                "the search produced no verified operating point")
        for key in ("checker_findings", "frontier_dominated_pairs",
                    "unverified_points"):
            val = figs.get(key)
            if val != 0:
                findings.append(
                    f"{where}: {key} == {val!r}, wanted 0 — the search "
                    "frontier is not clean")
    return findings


def record(out_dir, baseline_dir, sections=None) -> list:
    """Snapshot BENCH docs from a run into `baseline_dir` (the
    deliberate re-baseline action; the caller names the directory).
    Validates each doc against the bench schema first — a malformed
    artifact must not become the yardstick.  Returns the written
    paths."""
    out_dir = pathlib.Path(out_dir)
    baseline_dir = pathlib.Path(baseline_dir)
    baseline_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for path in sorted(out_dir.glob("BENCH_*.json")):
        doc = json.loads(path.read_text())
        section = doc.get("section")
        if sections is not None and section not in sections:
            continue
        findings = validate_doc(doc, path.name)
        findings += validate_invariants(doc, path.name)
        if findings:
            raise ValueError(
                f"refusing to baseline {path.name}: " + "; ".join(findings))
        dst = baseline_dir / path.name
        shutil.copyfile(path, dst)
        written.append(dst)
    if not written:
        raise ValueError(f"{out_dir}: nothing to record "
                         f"(sections={sections})")
    return written


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Record / compare perf baselines (BENCH_*.json, "
        "schema repro.bench/v1)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cmp_p = sub.add_parser("compare", help="gate a bench run against "
                           "the committed baselines (exit 1 on any "
                           "out-of-tolerance metric)")
    cmp_p.add_argument("out_dir", help="directory with the run's "
                       "BENCH_*.json artifacts")
    cmp_p.add_argument("--baselines", required=True,
                       help="directory with the baseline BENCH_*.json")
    cmp_p.add_argument("--slack", type=float, default=1.0,
                       help="multiplier on the timing tolerances "
                       "(exact metrics are unaffected); CI uses > 1 on "
                       "noisy shared runners")
    rec_p = sub.add_parser("record", help="snapshot a bench run as the "
                           "new committed baselines")
    rec_p.add_argument("out_dir")
    rec_p.add_argument("--baselines", required=True,
                       help="directory the baselines are written to")
    rec_p.add_argument("--sections", default=None,
                       help="comma-separated sections to record "
                       "(default: every BENCH_*.json in the run)")
    args = ap.parse_args(argv)

    if args.cmd == "record":
        sections = (None if args.sections is None
                    else set(args.sections.split(",")))
        written = record(args.out_dir, args.baselines, sections)
        for p in written:
            print(f"recorded {p}")
        return 0

    findings, notes = compare_dirs(args.out_dir, args.baselines,
                                   slack=args.slack)
    for n in notes:
        print(f"NOTE: {n}")
    for f in findings:
        print(f"REGRESSION: {f}")
    print(f"obs.baseline: compared {args.out_dir} vs {args.baselines} "
          f"(slack {args.slack:g}) -> {len(findings)} findings "
          f"{'FAIL' if findings else 'ok'}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
