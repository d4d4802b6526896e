"""Trace analytics: turn a recorded span forest into "where the time
went" — plus the cost-model drift report that keeps the static MCU
estimates honest against what the EdgeVM measures.  The port of the
reference's `repro.obs.analyze`: the same report for the same trace.

  * `analyze(source)` ingests a live `Tracer` or a Chrome trace-event
    JSON (dict or path — the exact format `Tracer.write_chrome_trace`
    emits) and produces per-span-name statistics (count / total / mean /
    p50 / p95 / max, self-time vs child time), the critical path of
    every `serve.wave`, a queue/compile/execute wall-time breakdown per
    (model, bucket), and — from the `req_id`/`req_ids` args the serving
    engine stamps — the reconstructed enqueue -> complete timeline of
    every request, from the trace alone;
  * `costmodel_drift(program, measured_rows)` joins
    `EdgeVM.run(profile=rows)` measured rows against
    `costmodel.estimate_program` estimated rows on their shared
    `op_index`/name/kind join key and reports, per MCU profile, each
    op's estimated-vs-measured share of the program and how far its
    est/meas ratio drifts from the program-wide ratio.

Both sources normalize to the same epoch-relative timeline, so
analyzing a tracer and analyzing its own Chrome export produce the same
report bit for bit under a fake clock.  Percentiles follow the
tiny-sample policy of `obs.Histogram.percentile`: nearest rank,
n < 3 -> exact max, never interpolated.

CLI:

    PYTHONPATH=src python -m repro_torch.obs.analyze trace.json \
        [--metrics metrics.json] [--json]

where `trace.json` comes from `serve_caps --trace` and `metrics.json`
from `serve_caps --metrics-out`.  The positional argument also accepts
a `repro.numerics/v1` numeric-health doc (export_caps / serve_caps
`--numerics-out`); `--gate-clips` then exits 1 on any recorded
int32-clip event.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

# float-noise tolerance for interval containment when rebuilding the
# span forest from Chrome microsecond timestamps (exact under the fake
# clocks tests use; real clocks carry ~ns rounding from the us export)
_EPS_S = 1e-7


@dataclasses.dataclass
class TraceNode:
    """One span, source-independent: times are epoch-relative seconds
    (the earliest span in the forest starts at 0.0)."""
    name: str
    t0: float
    t1: float
    args: dict
    children: list

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    @property
    def self_s(self) -> float:
        """Duration minus the time spent inside child spans."""
        return self.dur_s - sum(c.dur_s for c in self.children)


# ---------------------------------------------------------------------------
# ingestion: Tracer forest | Chrome trace JSON | path
# ---------------------------------------------------------------------------
def nodes_from_tracer(tracer) -> list:
    """Copy a Tracer's forest into epoch-relative TraceNodes (open spans
    are closed at their own t0, matching the Chrome export)."""
    def starts(s):
        if s.t0 is not None:
            yield s.t0
        for c in s.children:
            yield from starts(c)

    epoch = min((t for r in tracer.roots for t in starts(r)), default=0.0)

    def copy(s):
        t0 = (s.t0 if s.t0 is not None else epoch) - epoch
        t1 = (s.t1 if s.t1 is not None else s.t0 or epoch) - epoch
        return TraceNode(s.name, t0, t1, dict(s.args),
                         [copy(c) for c in s.children])

    return [copy(r) for r in tracer.roots]


def nodes_from_chrome(doc: dict) -> list:
    """Rebuild the span forest from Chrome "X" events by interval
    containment, in file order (the exporter writes parents depth-first
    before their children)."""
    roots: list = []
    stack: list = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        t0 = ev["ts"] / 1e6
        node = TraceNode(ev["name"], t0, t0 + ev.get("dur", 0.0) / 1e6,
                         dict(ev.get("args", {})), [])
        while stack and not (node.t0 >= stack[-1].t0 - _EPS_S
                             and node.t1 <= stack[-1].t1 + _EPS_S):
            stack.pop()
        (stack[-1].children if stack else roots).append(node)
        stack.append(node)
    return roots


def load_trace(source) -> list:
    """TraceNode roots from a Tracer, a Chrome trace dict, or a path to
    a Chrome trace JSON file."""
    if isinstance(source, (str, pathlib.Path)):
        source = json.loads(pathlib.Path(source).read_text())
    if isinstance(source, dict):
        return nodes_from_chrome(source)
    if hasattr(source, "roots"):                 # a Tracer
        return nodes_from_tracer(source)
    raise TypeError(f"cannot load a trace from {type(source).__name__}; "
                    "want a Tracer, a Chrome trace dict, or a path")


def walk(roots) -> list:
    out: list = []
    stack = list(reversed(roots))
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(reversed(n.children))
    return out


# ---------------------------------------------------------------------------
# per-span-name statistics
# ---------------------------------------------------------------------------
def _pctl(sorted_vals: list, p: float):
    """Repo-wide pinned percentile: None on empty, exact max below 3
    samples, nearest rank otherwise (no interpolation anywhere)."""
    n = len(sorted_vals)
    if n == 0:
        return None
    if n < 3:
        return sorted_vals[-1]
    rank = max(1, min(n, -(-int(p * n) // 100)))
    return sorted_vals[rank - 1]


def span_stats(roots) -> dict:
    """name -> {count, total_s, mean_s, p50_s, p95_s, max_s, self_s}."""
    durs: dict = {}
    selfs: dict = {}
    for n in walk(roots):
        durs.setdefault(n.name, []).append(n.dur_s)
        selfs[n.name] = selfs.get(n.name, 0.0) + n.self_s
    out = {}
    for name in sorted(durs):
        d = sorted(durs[name])
        total = sum(d)
        out[name] = {"count": len(d), "total_s": total,
                     "mean_s": total / len(d),
                     "p50_s": _pctl(d, 50), "p95_s": _pctl(d, 95),
                     "max_s": d[-1], "self_s": selfs[name]}
    return out


# ---------------------------------------------------------------------------
# serve.wave critical paths + per-(model, bucket) breakdown
# ---------------------------------------------------------------------------
def critical_path(node: TraceNode) -> list:
    """Longest-child chain from `node` down: the serial spans are
    nested, so the heaviest child at every level IS the critical path."""
    path = []
    while True:
        path.append({"name": node.name, "dur_s": node.dur_s,
                     "self_s": node.self_s})
        if not node.children:
            return path
        node = max(node.children, key=lambda c: c.dur_s)


def _req_ids(args: dict) -> list:
    ids = args.get("req_ids")
    if ids is None or ids == "":
        return []
    if isinstance(ids, (list, tuple)):
        return [int(i) for i in ids]
    return [int(i) for i in str(ids).split(",")]


def wave_summaries(roots) -> list:
    """One entry per serve.wave span, in schedule order: identity args +
    duration + critical path."""
    out = []
    for n in walk(roots):
        if n.name != "serve.wave":
            continue
        out.append({"wave": n.args.get("wave"),
                    "model": n.args.get("model"),
                    "bucket": n.args.get("bucket"),
                    "n_real": n.args.get("n_real"),
                    "req_ids": _req_ids(n.args),
                    "dur_s": n.dur_s,
                    "critical_path": critical_path(n)})
    return out


def request_timelines(roots) -> list:
    """Reconstruct every request's end-to-end timeline from the trace
    alone: `serve.enqueue` (req_id arg) gives t_enq, the serve.wave
    whose req_ids membership names the request gives the wave identity,
    and its serve.complete child's exit gives t_done."""
    enq = {}
    for n in walk(roots):
        if n.name == "serve.enqueue" and "req_id" in n.args:
            enq[int(n.args["req_id"])] = n
    out = []
    for n in walk(roots):
        if n.name != "serve.wave":
            continue
        complete = [c for c in n.children if c.name == "serve.complete"]
        t_done = complete[-1].t1 if complete else n.t1
        for rid in _req_ids(n.args):
            e = enq.get(rid)
            row = {"req_id": rid, "model": n.args.get("model"),
                   "wave": n.args.get("wave"),
                   "bucket": n.args.get("bucket"), "t_done": t_done}
            if e is not None:
                row.update(t_enq=e.t0, e2e_s=t_done - e.t0,
                           queue_s=max(0.0, n.t0 - e.t1))
            out.append(row)
    return sorted(out, key=lambda r: r["req_id"])


_WAVE_PHASES = {"serve.bucket": "bucket_s", "serve.compile": "compile_s",
                "serve.execute": "execute_s", "serve.complete": "complete_s"}


def wave_breakdown(roots) -> list:
    """Queue/bucket/compile/execute/complete wall time per (model,
    bucket): where a serving run's wall clock went, per wave shape."""
    agg: dict = {}
    for w in walk(roots):
        if w.name != "serve.wave":
            continue
        key = (w.args.get("model"), w.args.get("bucket"))
        a = agg.setdefault(key, {"model": key[0], "bucket": key[1],
                                 "waves": 0, "images": 0, "wave_s": 0.0,
                                 "queue_s": 0.0, "bucket_s": 0.0,
                                 "compile_s": 0.0, "execute_s": 0.0,
                                 "complete_s": 0.0})
        a["waves"] += 1
        a["images"] += int(w.args.get("n_real") or 0)
        a["wave_s"] += w.dur_s
        for c in w.children:
            phase = _WAVE_PHASES.get(c.name)
            if phase is not None:
                a[phase] += c.dur_s
    for r in request_timelines(roots):
        key = (r.get("model"), r.get("bucket"))
        if key in agg and "queue_s" in agg[key] and "e2e_s" in r:
            agg[key]["queue_s"] += r["queue_s"]
    return [agg[k] for k in sorted(agg, key=lambda k: (str(k[0]),
                                                       str(k[1])))]


# ---------------------------------------------------------------------------
# the one-call report
# ---------------------------------------------------------------------------
def analyze(source, metrics: dict | None = None) -> dict:
    """The full analysis of one trace (and optionally the metrics
    snapshot recorded by the same run), as one JSON-safe dict."""
    roots = load_trace(source)
    report = {
        "span_count": len(walk(roots)),
        "spans": span_stats(roots),
        "waves": wave_summaries(roots),
        "requests": request_timelines(roots),
        "breakdown": wave_breakdown(roots),
    }
    if metrics is not None:
        report["metrics"] = metrics
    return report


def _ms(x) -> str:
    return "n/a" if x is None else f"{x * 1e3:.3f}"


def format_analysis(report: dict) -> str:
    lines = [f"trace: {report['span_count']} spans, "
             f"{len(report['spans'])} distinct names"]
    lines.append(f"  {'span':<24}{'count':>6}{'total_ms':>10}"
                 f"{'mean_ms':>9}{'p50_ms':>9}{'p95_ms':>9}{'max_ms':>9}"
                 f"{'self_ms':>9}")
    by_total = sorted(report["spans"].items(),
                      key=lambda kv: -kv[1]["total_s"])
    for name, s in by_total:
        lines.append(f"  {name:<24}{s['count']:>6}"
                     f"{_ms(s['total_s']):>10}{_ms(s['mean_s']):>9}"
                     f"{_ms(s['p50_s']):>9}{_ms(s['p95_s']):>9}"
                     f"{_ms(s['max_s']):>9}{_ms(s['self_s']):>9}")
    if report["waves"]:
        lines.append("waves (critical path):")
        for w in report["waves"]:
            path = " > ".join(p["name"] for p in w["critical_path"])
            lines.append(f"  wave {w['wave']} model={w['model']} "
                         f"bucket={w['bucket']} n_real={w['n_real']} "
                         f"{_ms(w['dur_s'])}ms: {path}")
    if report["breakdown"]:
        lines.append("breakdown per (model, bucket), wall ms:")
        lines.append(f"  {'model':<16}{'bucket':>7}{'waves':>6}"
                     f"{'imgs':>5}{'queue':>9}{'compile':>9}"
                     f"{'execute':>9}{'complete':>9}")
        for b in report["breakdown"]:
            lines.append(f"  {str(b['model']):<16}{str(b['bucket']):>7}"
                         f"{b['waves']:>6}{b['images']:>5}"
                         f"{_ms(b['queue_s']):>9}{_ms(b['compile_s']):>9}"
                         f"{_ms(b['execute_s']):>9}"
                         f"{_ms(b['complete_s']):>9}")
    reqs = [r for r in report["requests"] if "e2e_s" in r]
    if reqs:
        e2e = sorted(r["e2e_s"] for r in reqs)
        lines.append(f"requests: {len(reqs)} reconstructed | e2e "
                     f"p50 {_ms(_pctl(e2e, 50))} / "
                     f"p95 {_ms(_pctl(e2e, 95))} / "
                     f"max {_ms(e2e[-1])} ms")
    m = report.get("metrics")
    if m is not None:
        lines.append(_format_metrics(m))
    return "\n".join(lines)


def _format_metrics(doc: dict) -> str:
    """Compact rendering of a metrics snapshot — either a raw
    `MetricsRegistry.snapshot()` or the `repro.metrics/v1` document
    `serve_caps --metrics-out` writes."""
    if doc.get("schema") == "repro.metrics/v1":
        lines = ["metrics (repro.metrics/v1):"]
        for part in ("run", "process"):
            snap = doc.get(part) or {}
            if snap:
                lines.append(f"  [{part}]")
                lines.extend("  " + ln
                             for ln in _snap_lines(snap))
        s = doc.get("serve_summary")
        if s:
            lines.append(f"  serve window: images={s.get('images')} "
                         f"waves={s.get('waves')} "
                         f"p95_ms={s.get('p95_ms')} "
                         f"img/s={s.get('images_per_s')}")
        return "\n".join(lines)
    return "\n".join(["metrics snapshot:"] +
                     ["  " + ln for ln in _snap_lines(doc)])


def _snap_lines(snap: dict) -> list:
    lines = []
    for name, entry in sorted(snap.items()):
        if entry.get("kind") == "histogram":
            tot = sum(s["value"].get("count", 0)
                      for s in entry.get("series", []))
            lines.append(f"{name} (histogram): {tot} observations")
        else:
            tot = sum(s.get("value", 0) or 0
                      for s in entry.get("series", [])
                      if isinstance(s.get("value"), (int, float)))
            lines.append(f"{name} ({entry.get('kind')}): {tot:g}")
    return lines


# ---------------------------------------------------------------------------
# cost-model drift: estimated vs measured, per op and per program
# ---------------------------------------------------------------------------
def costmodel_drift(program, measured_rows, profiles=None,
                    batch: int = 1) -> dict:
    """Join `EdgeVM.run(profile=rows)` measured rows against
    `costmodel.estimate_program(program, ...)` estimated rows on their
    shared (op_index, name, kind) key.

    Absolute est/meas ratios are expected to be large (MCU cycles vs a
    host NumPy interpreter); the drift signal is scale-free: each op's
    `est_share` vs `meas_share` of the program total, and `rel_drift` =
    how far the op's est/meas ratio sits from the program-wide ratio.
    A cost model that ranks ops the way the VM measures them has every
    rel_drift near 0 regardless of the host's speed.

    `batch` is the number of images the measured rows covered (wall
    time is normalized per image; the estimate is per inference).
    Returns coverage over the schedule — the drift gate requires 100%.
    """
    from repro_torch.edge import costmodel

    if profiles is None:
        profiles = sorted(costmodel.MCU_PROFILES)
    measured = {}
    for row in measured_rows:
        key = row.get("op_index")
        if key is None:                          # pre-join-key rows
            key = row["name"]
        measured[key] = row

    out_profiles = {}
    unmatched: list = []
    n_joined = 0
    for pname in profiles:
        est = costmodel.estimate_program(program, pname)
        rows = []
        unmatched = []
        for erow in est["rows"]:
            mrow = measured.get(erow["op_index"],
                                measured.get(erow["name"]))
            if mrow is None or mrow["name"] != erow["name"] \
                    or mrow["kind"] != erow["kind"]:
                unmatched.append({"op_index": erow["op_index"],
                                  "name": erow["name"],
                                  "kind": erow["kind"]})
                continue
            meas_ms = mrow["wall_s"] * 1e3 / max(batch, 1)
            rows.append({"op_index": erow["op_index"],
                         "name": erow["name"], "kind": erow["kind"],
                         "est_ms": erow["ms"], "meas_ms": meas_ms})
        total_est = sum(r["est_ms"] for r in rows)
        total_meas = sum(r["meas_ms"] for r in rows)
        ratio = total_est / total_meas if total_meas > 0 else None
        for r in rows:
            r["est_share"] = r["est_ms"] / total_est if total_est else 0.0
            r["meas_share"] = (r["meas_ms"] / total_meas
                               if total_meas else 0.0)
            if ratio and r["meas_ms"] > 0:
                r["ratio"] = r["est_ms"] / r["meas_ms"]
                r["rel_drift"] = r["ratio"] / ratio - 1.0
            else:
                r["ratio"] = None
                r["rel_drift"] = None
        drifts = [abs(r["rel_drift"]) for r in rows
                  if r["rel_drift"] is not None]
        out_profiles[pname] = {
            "rows": rows, "total_est_ms": total_est,
            "total_meas_ms": total_meas, "ratio": ratio,
            "max_abs_rel_drift": max(drifts) if drifts else None,
        }
        n_joined = len(rows)
    n_ops = len(program.ops)
    return {"program": program.name, "batch": batch,
            "n_ops": n_ops, "n_joined": n_joined,
            "coverage": n_joined / n_ops if n_ops else 1.0,
            "unmatched": unmatched, "profiles": out_profiles}


def format_drift(drift: dict) -> str:
    lines = [f"[{drift['program']}] cost-model drift: estimate vs "
             f"EdgeVM-measured (batch {drift['batch']}, join coverage "
             f"{drift['n_joined']}/{drift['n_ops']} ops = "
             f"{drift['coverage'] * 100:.0f}%)"]
    if drift["unmatched"]:
        lines.append(f"  UNMATCHED schedule ops: {drift['unmatched']}")
    for pname, p in drift["profiles"].items():
        ratio = "n/a" if p["ratio"] is None else f"{p['ratio']:.1f}x"
        mx = ("n/a" if p["max_abs_rel_drift"] is None
              else f"{p['max_abs_rel_drift'] * 100:.1f}%")
        lines.append(f"  profile {pname}: est {p['total_est_ms']:.2f} ms"
                     f" vs meas {p['total_meas_ms']:.3f} ms/img "
                     f"(ratio {ratio}, max |rel drift| {mx})")
        lines.append(f"    {'op':<8}{'kind':<18}{'est_ms':>10}"
                     f"{'meas_ms':>10}{'est%':>7}{'meas%':>7}"
                     f"{'drift':>9}")
        for r in p["rows"]:
            d = ("n/a" if r["rel_drift"] is None
                 else f"{r['rel_drift'] * 100:+.1f}%")
            lines.append(f"    {r['name']:<8}{r['kind']:<18}"
                         f"{r['est_ms']:>10.2f}{r['meas_ms']:>10.3f}"
                         f"{r['est_share'] * 100:>6.1f}%"
                         f"{r['meas_share'] * 100:>6.1f}%{d:>9}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Analyze an observability artifact: a Chrome trace "
        "recorded by serve_caps --trace (span stats, wave critical "
        "paths, per-request timelines) or a repro.numerics/v1 doc "
        "(export_caps --numerics-out / serve_caps --numerics-out)")
    ap.add_argument("trace", help="Chrome trace-event JSON "
                    "(serve_caps --trace PATH) or a repro.numerics/v1 "
                    "numeric-health doc")
    ap.add_argument("--metrics", metavar="PATH", default=None,
                    help="metrics snapshot JSON to fold into the report "
                    "(serve_caps --metrics-out PATH)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    ap.add_argument("--gate-clips", action="store_true",
                    help="numerics docs only: exit 1 when the doc "
                    "records any int32-clip event (the CI gate — clips "
                    "are statically proven impossible on shipped "
                    "configs)")
    args = ap.parse_args(argv)
    try:
        doc = json.loads(pathlib.Path(args.trace).read_text())
    except (ValueError, OSError):
        doc = None
    if isinstance(doc, dict) and doc.get("schema") == "repro.numerics/v1":
        from repro_torch.obs.numerics import NumericsReport
        report = NumericsReport.from_doc(doc)
        if args.json:
            print(json.dumps(report.to_doc(), indent=1, sort_keys=True))
        else:
            print(report.format())
        clips = report.total_int32_clip()
        if args.gate_clips and clips:
            print(f"analyze: GATE FAILED — {clips} int32-clip event(s) "
                  "recorded (expected 0)", file=sys.stderr)
            return 1
        return 0
    if args.gate_clips:
        ap.error("--gate-clips needs a repro.numerics/v1 doc")
    metrics = None
    if args.metrics:
        metrics = json.loads(pathlib.Path(args.metrics).read_text())
    report = analyze(args.trace, metrics=metrics)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(format_analysis(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
