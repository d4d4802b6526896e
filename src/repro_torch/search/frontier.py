"""Pareto frontier over evaluated candidates + the `repro.search/v1` doc
(the port of the reference's `repro.search.frontier`).

The frontier is computed over the paper's axes — accuracy up,
virtual-bit-packed flash down, RAM down, estimated Cortex-M7 latency
down — and every surviving point is *re-verified at selection time*:
exported to `.capsbin`, re-imported, statically checked, and bit-exact
EdgeVM-verified against the model on its device
(`edge.export.export_artifacts`).  A frontier point in the doc is
therefore a deployment-ready claim, not a score.  `rebuild_point`
re-derives a point's model from the doc's search config and asserts the
plan matches bit-for-bit — the drift guard behind
`export_caps --from-search`.
"""
from __future__ import annotations

import json
import tempfile

from repro_torch.nn.plans import plan_to_json
from repro_torch.search.objective import Candidate
from repro_torch.search.space import CandidateSpec

SEARCH_SCHEMA = "repro.search/v1"

# (metric, sign): +1 = higher is better, -1 = lower is better
AXES = (("acc", 1), ("flash_packed_bytes", -1), ("ram_bytes", -1),
        ("est_ms_m7", -1))


def dominates(a: dict, b: dict, axes=AXES) -> bool:
    """True if metrics `a` Pareto-dominates `b`: no worse on every axis,
    strictly better on at least one."""
    strict = False
    for key, sign in axes:
        da, db = sign * a[key], sign * b[key]
        if da < db:
            return False
        if da > db:
            strict = True
    return strict


def pareto(candidates, axes=AXES) -> list:
    """The non-dominated subset of the `ok` candidates, in their given
    (deterministic) order.  Duplicate metric vectors keep the first."""
    scored = [c for c in candidates if c.ok and "acc" in c.metrics]
    front = []
    seen = set()
    for c in scored:
        key = tuple(c.metrics[k] for k, _ in axes)
        if key in seen:
            continue
        if any(dominates(o.metrics, c.metrics, axes) for o in scored):
            continue
        seen.add(key)
        front.append(c)
    return front


def dominated_pairs(points, axes=AXES) -> int:
    """Number of (i, j) pairs within `points` (metric dicts or frontier
    point dicts) where one dominates the other — 0 for a true frontier
    (the bench invariant)."""
    ms = [p["metrics"] if "metrics" in p else p for p in points]
    return sum(1 for a in ms for b in ms
               if a is not b and dominates(a, b, axes))


# ---------------------------------------------------------------------------
# frontier-point verification (export -> reload -> re-verify)
# ---------------------------------------------------------------------------
def verify_point(space, cand: Candidate, *, rounding: str,
                 verify_images, out_dir=None) -> dict:
    """Export the candidate's model as `.capsbin` + plan JSON and run
    the full export gauntlet: static checker on the lowered program and
    bit-exact EdgeVM-vs-model verification of the reloaded artifact
    (the model runs on the space's device and backend).  Returns
    export_artifacts' report dict (raises on any failure)."""
    from repro_torch.edge.export import export_artifacts
    qnet = space.build_qnet(cand.spec, rounding=rounding)
    if out_dir is not None:
        return export_artifacts(qnet, out_dir,
                                verify_images=verify_images, check=True)
    with tempfile.TemporaryDirectory() as tmp:
        return export_artifacts(qnet, tmp,
                                verify_images=verify_images, check=True)


# ---------------------------------------------------------------------------
# result doc
# ---------------------------------------------------------------------------
def build_doc(config: dict, baseline: Candidate, candidates,
              frontier, *, verification=None) -> dict:
    """Assemble the `repro.search/v1` result document.  `frontier` is
    the pareto() output; `verification[i]` (optional) is the export
    report of frontier point i."""
    points = []
    for i, c in enumerate(frontier):
        ver = (verification or {}).get(i, {})
        points.append({
            "point": i,
            "spec": c.spec.to_json(),
            "metrics": c.metrics,
            "plan": ver.get("plan"),
            "verified": bool(ver.get("verified", False)),
            "checked": bool(ver.get("checked", False)),
        })
    return {
        "schema": SEARCH_SCHEMA,
        "config": config,
        "baseline": baseline.to_json(),
        "evaluated": [c.to_json() for c in candidates],
        "frontier": points,
    }


def load_doc(path) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SEARCH_SCHEMA:
        raise ValueError(f"{path}: schema {doc.get('schema')!r} is not "
                         f"{SEARCH_SCHEMA!r}")
    return doc


def frontier_table_rows(doc: dict) -> list:
    """Frontier points as `captrain.evalq.Table2Row`s (source="search")
    so searched operating points print alongside the PTQ/QAT baselines
    in the Table-2 harness format."""
    from repro_torch.captrain.evalq import Table2Row
    cfg = doc["config"]
    base = doc["baseline"]["metrics"]
    rows = []
    for p in doc["frontier"]:
        spec = CandidateSpec.from_json(p["spec"])
        m = p["metrics"]
        rows.append(Table2Row(
            name=f"{cfg.get('model', '?')}#p{p['point']}",
            rounding=cfg.get("rounding", "floor"),
            acc_f32=float(doc.get("float_acc", float("nan"))),
            acc_ptq=float(m["acc"]),
            acc_qat=float(m.get("acc_qat", m["acc"])),
            saving_pct=100.0 * (1 - m["flash_packed_bytes"]
                                / max(1, base["flash_bytes"])),
            variant=(f"{spec.softmax or 'q7'}+"
                     f"{spec.squash or 'exact'}"),
            est_ms_m7=float(m["est_ms_m7"]),
            est_ms_gap8=float(m["est_ms_gap8"]),
            sat_pct=100.0 * float(m.get("sat_rate", float("nan"))),
            snr_db=float(m.get("snr_db", float("nan"))),
            flash_bytes=int(m["flash_bytes"]),
            ram_bytes=int(m["ram_bytes"]),
            source="search"))
    return rows


# ---------------------------------------------------------------------------
# point rebuild (the --from-search export path)
# ---------------------------------------------------------------------------
def rebuild_point(doc: dict, point: int, *, device=None):
    """Deterministically re-derive frontier point `point` from the doc's
    search config: re-run the seeded setup (train + calibrate) on
    `device` (the card unless told otherwise), rebuild the candidate
    model, and assert its plan matches the stored one bit-for-bit.
    Returns (qnet, point_entry, setup).  A doc written on another
    device or by the reference may honestly drift at a calibration
    max's power-of-two boundary; that raises like any drift."""
    entries = {p["point"]: p for p in doc["frontier"]}
    if point not in entries:
        raise ValueError(f"no frontier point {point}; doc has "
                         f"{sorted(entries)}")
    entry = entries[point]
    from repro_torch.search.driver import SearchConfig, setup_space
    cfg = SearchConfig.from_json(doc["config"])
    st = setup_space(cfg, device=device)
    spec = CandidateSpec.from_json(entry["spec"])
    qnet = st.space.build_qnet(spec, rounding=cfg.rounding)
    if plan_to_json(qnet.plan) != entry["plan"]:
        raise RuntimeError(
            f"rebuilt plan for point {point} drifted from the result "
            f"doc — the training/calibration path is no longer "
            f"deterministic for seed {cfg.seed}")
    return qnet, entry, st
