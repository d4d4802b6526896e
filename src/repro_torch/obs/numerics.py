"""Numeric-health probes for the quantized stack (saturation, range
utilization, bound tightness, q7-vs-f32 SNR): the port of the
reference's `repro.obs.numerics`, with the same rows and the same
`repro.numerics/v1` document for the same computation.

`repro_torch.analysis.ranges` PROVES static int32 bounds; this module
OBSERVES what the quantized dataflow actually does at runtime, so the
two can cross-validate each other.

The probe is ambient, exactly like the span tracer (`obs.trace`):
instrumented sites — the EdgeVM runners, `quant.int8_ops.rshift_sat8`
and `rshift_sat8_vec`, `CapsPipeline.forward_q7` — guard on
`numerics._PROBE is not None` and otherwise touch nothing, so probes-off
execution stays the untouched hot path (no object allocated, no call
made, no copy off the card; the EdgeVM keeps its plain loop).  Probes
are pure observers: every statistic is recomputed in int64 on the host
NEXT TO the real int32 computation, never inside it, so probed and
unprobed runs are bit-identical.  A torch tensor is read as
`t.detach().cpu().numpy()`, on whatever device it lies, and only while
a probe is installed.  Requantizations inside the CUDA kernels (the
primary caps' squash, routing's `s[r]`/`agree[r]`) are invisible to the
hooks, as the Pallas kernels' interiors are to the reference's.

Per requantization point the probe records, in exact integer arithmetic:

  * saturation — elements whose shifted value falls outside [-128, 127]
    before the int8 clamp (`sat_lo` / `sat_hi`);
  * int32 clipping — elements whose int32-domain intermediate (the
    half-LSB add on right shifts, the shifted value on left shifts)
    exceeds int32 when recomputed in int64.  On a verifier-clean
    program this is provably zero;
  * `acc_peak`, the raw pre-shift |accumulator| peak, and its ratio to
    the statically proven `acc_bound` (bound tightness: how much of the
    proof's headroom reality uses).

Per op output it records the int8 range and its utilization of the Qm.n
grid (optionally into a `MetricsRegistry` histogram); fake-quant sites
(`qformat.fake_quant*`) count STE-clipped activations (`observe_fq`).
`snr_rows` runs `fwd_q7` against the `fwd_f32` oracle layer by layer
and reports signal-to-quantization-noise per layer.  Everything rolls up into a `NumericsReport`
(`repro.numerics/v1`), consumed by `export_caps --numerics`,
`serve_caps --numerics-out` and `python -m repro_torch.obs.analyze`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

NUMERICS_SCHEMA = "repro.numerics/v1"
INT8_MIN, INT8_MAX = -128, 127
INT32_MAX = 2 ** 31 - 1

# range-utilization histogram buckets: fractions of the int8 grid
_UTIL_BUCKETS = (0.125, 0.25, 0.5, 0.75, 0.9, 1.0, float("inf"))


def _host(x) -> np.ndarray:
    """A probed value as a host array: a torch tensor (any device) is
    copied off with `.detach().cpu().numpy()`, anything else goes
    through `np.asarray`."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class NumericsProbe:
    """Accumulates numeric-health observations keyed by (op, site).

    Instrumented code attributes observations to the CURRENT op context
    (`begin_op` / the `scope` context manager); the EdgeVM sets it per
    schedule entry, `forward_q7` per layer.  Pass a
    `MetricsRegistry` to also stream range-utilization histograms and
    saturation/clip counters into labeled metric series.
    """

    def __init__(self, metrics=None):
        self.metrics = metrics
        self._recs: dict = {}           # (family, op, site) -> record
        self._op = (None, "<unscoped>", None)
        self._seq = 0
        if metrics is not None:
            self._h_util = metrics.histogram(
                "numerics.range_utilization",
                help="per-call peak |out| / 127 per op output",
                buckets=_UTIL_BUCKETS)
            self._c_sat = metrics.counter(
                "numerics.saturations",
                help="values clamped at the int8 rails per requant site")
            self._c_clip = metrics.counter(
                "numerics.int32_clips",
                help="int32-domain overflows recomputed in int64 "
                "(zero on verifier-clean programs)")

    # ------------------------------------------------------------------
    # op context
    # ------------------------------------------------------------------
    def begin_op(self, index, name: str, kind: str | None = None) -> None:
        self._op = (index, name, kind)
        self._seq = 0

    def _rec(self, family: str, site: str) -> dict:
        idx, op, kind = self._op
        key = (family, op, site)
        r = self._recs.get(key)
        if r is None:
            r = self._recs[key] = {
                "family": family, "op": op, "site": site,
                "op_index": idx, "kind": kind, "calls": 0, "n": 0}
        return r

    # ------------------------------------------------------------------
    # observation points (pure int64 recomputation; never mutates input)
    # ------------------------------------------------------------------
    def observe_requant(self, acc, shift, rounding: str, *,
                        site: str | None = None, bound=None) -> None:
        """One `rshift_sat8[_vec]` call: int32 accumulator `acc` about
        to be shifted by `shift` (scalar or per-lane array)."""
        a = _host(acc)
        if a.size == 0:
            return
        if site is None:
            site = f"requant[{self._seq}]"
            self._seq += 1
        a64 = a.astype(np.int64)
        peak = int(np.abs(a64).max())
        sh = _host(shift).astype(np.int64)
        if rounding == "nearest":
            half = np.where(sh > 0,
                            np.left_shift(np.int64(1),
                                          np.maximum(sh - 1, 0)),
                            np.int64(0))
            pre = a64 + half
        else:
            pre = a64
        # the int32-domain intermediates, recomputed wide: the half-add
        # sum (right shifts) and the left-shifted value (negative sh)
        over = np.abs(pre) > INT32_MAX
        shifted = np.right_shift(pre, np.maximum(sh, 0))
        shifted = np.left_shift(shifted, np.maximum(-sh, 0))
        over |= np.abs(shifted) > INT32_MAX
        sat_hi = int((shifted > INT8_MAX).sum())
        sat_lo = int((shifted < INT8_MIN).sum())
        clips = int(over.sum())

        r = self._rec("requant", site)
        r["calls"] += 1
        r["n"] += int(a.size)
        r["sat_lo"] = r.get("sat_lo", 0) + sat_lo
        r["sat_hi"] = r.get("sat_hi", 0) + sat_hi
        r["int32_clip"] = r.get("int32_clip", 0) + clips
        r["acc_peak"] = max(r.get("acc_peak", 0), peak)
        if bound is not None:
            r["acc_bound"] = int(bound)
        if self.metrics is not None:
            if sat_lo or sat_hi:
                self._c_sat.inc(sat_lo + sat_hi, op=r["op"], site=site)
            if clips:
                self._c_clip.inc(clips, op=r["op"], site=site)

    def observe_output(self, y, *, frac=None, site: str = "out") -> None:
        """An op's int8 output tensor: range + grid utilization."""
        a = _host(y)
        if a.size == 0:
            return
        lo = int(a.min())
        hi = int(a.max())
        util = max(abs(lo), abs(hi)) / float(INT8_MAX)
        r = self._rec("output", site)
        r["calls"] += 1
        r["n"] += int(a.size)
        r["out_min"] = min(r.get("out_min", lo), lo)
        r["out_max"] = max(r.get("out_max", hi), hi)
        r["util_sum"] = r.get("util_sum", 0.0) + util
        if frac is not None:
            r["frac"] = int(frac)
        if self.metrics is not None:
            self._h_util.observe(util, op=r["op"])

    def observe_fq(self, r_scaled) -> None:
        """One fake-quant call: `r_scaled` is the rounded pre-clip grid
        value; elements outside [-128, 127] are STE-clipped."""
        a = _host(r_scaled)
        if a.size == 0:
            return
        clipped = int(((a < INT8_MIN) | (a > INT8_MAX)).sum())
        r = self._rec("fq", "fq")
        r["calls"] += 1
        r["n"] += int(a.size)
        r["clipped"] = r.get("clipped", 0) + clipped

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def rows(self) -> list:
        """JSON-safe per-(op, site) rows with derived health metrics,
        deterministically ordered (schedule position, then name)."""
        out = []
        for r in self._recs.values():
            row = {"family": r["family"], "op": r["op"],
                   "site": r["site"], "op_index": r["op_index"],
                   "kind": r["kind"], "calls": r["calls"], "n": r["n"]}
            if r["family"] == "requant":
                sat = r["sat_lo"] + r["sat_hi"]
                row.update(
                    sat_lo=r["sat_lo"], sat_hi=r["sat_hi"],
                    saturation_rate=sat / r["n"] if r["n"] else 0.0,
                    int32_clip=r["int32_clip"],
                    acc_peak=r["acc_peak"],
                    acc_bits=int(r["acc_peak"]).bit_length())
                bound = r.get("acc_bound")
                row["acc_bound"] = bound
                if bound:
                    row["bound_bits"] = int(bound).bit_length()
                    row["bound_tightness"] = r["acc_peak"] / bound
            elif r["family"] == "output":
                row.update(
                    out_min=r["out_min"], out_max=r["out_max"],
                    frac=r.get("frac"),
                    range_util=max(abs(r["out_min"]),
                                   abs(r["out_max"])) / float(INT8_MAX),
                    util_mean=r["util_sum"] / r["calls"])
            else:                       # fq
                row.update(
                    clipped=r["clipped"],
                    clip_rate=r["clipped"] / r["n"] if r["n"] else 0.0)
            out.append(row)
        big = 1 << 30
        out.sort(key=lambda r: (r["op_index"] if r["op_index"] is not None
                                else big, r["op"], r["family"], r["site"]))
        return out

    def fq_clip_rates(self) -> dict:
        """op (layer scope) -> STE-clipped activation fraction."""
        return {r["op"]: (r["clipped"] / r["n"] if r["n"] else 0.0)
                for r in self._recs.values() if r["family"] == "fq"}


# ---------------------------------------------------------------------------
# ambient probe: what instrumented code guards on
# ---------------------------------------------------------------------------
_PROBE: NumericsProbe | None = None


def get_probe() -> NumericsProbe | None:
    return _PROBE


def set_probe(probe: NumericsProbe | None) -> NumericsProbe | None:
    """Install `probe` as the process-ambient probe; returns the
    previous one (so callers can restore it)."""
    global _PROBE
    prev = _PROBE
    _PROBE = probe
    return prev


@contextlib.contextmanager
def probing(probe: NumericsProbe):
    """Scoped `set_probe`: ambient within the with-block, restored
    after (exception-safe)."""
    prev = set_probe(probe)
    try:
        yield probe
    finally:
        set_probe(prev)


@contextlib.contextmanager
def scope(name: str, *, index=None, kind: str | None = None):
    """Attribute observations inside the block to op `name` (the
    pipeline's probed `forward_q7` wraps each layer in one; no-op when
    probing is off)."""
    p = _PROBE
    if p is None:
        yield
        return
    prev = (p._op, p._seq)
    p.begin_op(index, name, kind)
    try:
        yield
    finally:
        p._op, p._seq = prev


def observe_requant(acc, shift, rounding: str, *,
                    site: str | None = None, bound=None) -> None:
    """Module-level hook for the q7 ops: records on the ambient probe."""
    p = _PROBE
    if p is None:
        return
    p.observe_requant(acc, shift, rounding, site=site, bound=bound)


def observe_fq(r_scaled) -> None:
    """Module-level hook for the fake-quant faces."""
    p = _PROBE
    if p is None:
        return
    p.observe_fq(r_scaled)


# ---------------------------------------------------------------------------
# SNR probe mode: fwd_q7 against the fwd_f32 oracle, layer by layer
# ---------------------------------------------------------------------------
def snr_rows(pipeline, params, qnet, images) -> list:
    """Per-layer signal-to-quantization-noise of the int8 pipeline
    against the float oracle, both walked layer by layer from the same
    input on the model's device.  `params` are the float weights the
    model was quantized from (the oracle); the q7 output is dequantized
    with each layer plan's `out_frac`.  snr_db is None when the error is
    exactly zero."""
    from repro_torch.nn.pipeline import _full_fp32

    with torch.inference_mode(), _full_fp32():
        h_f = torch.as_tensor(np.asarray(images, np.float32),
                              device=qnet.device)
        h_q = qnet.quantize_input(h_f)
        rows = []
        for layer in pipeline.layers:
            h_f, _ = layer.fwd_f32(params[layer.name], h_f)
            h_q = layer.fwd_q7(qnet.qweights[layer.name],
                               qnet.plan[layer.name], h_q,
                               backend=qnet.backend, rounding=qnet.rounding)
            out_frac = qnet.plan[layer.name].out_frac
            ref = _host(h_f).astype(np.float64)
            deq = _host(h_q).astype(np.float64) * (2.0 ** -out_frac)
            sig = float(np.sum(ref * ref))
            err = float(np.sum((ref - deq) ** 2))
            snr_db = 10.0 * math.log10(sig / err) if err > 0 and sig > 0 \
                else None
            rows.append({"layer": layer.name, "out_frac": int(out_frac),
                         "signal_power": sig, "noise_power": err,
                         "snr_db": snr_db})
    return rows


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NumericsReport:
    """Per-op numeric-health rows + per-layer SNR, serializable as a
    `repro.numerics/v1` document that reproduces the rows exactly."""
    program: str
    rounding: str
    batch: int
    rows: list
    snr: list = dataclasses.field(default_factory=list)

    # -- aggregates ----------------------------------------------------
    def total_int32_clip(self) -> int:
        return sum(r.get("int32_clip", 0) for r in self.rows)

    def worst_saturation_rate(self) -> float:
        rates = [r["saturation_rate"] for r in self.rows
                 if r["family"] == "requant"]
        return max(rates) if rates else 0.0

    def max_bound_tightness(self) -> float:
        vals = [r["bound_tightness"] for r in self.rows
                if r.get("bound_tightness") is not None]
        return max(vals) if vals else float("nan")

    def min_snr_db(self) -> float:
        vals = [r["snr_db"] for r in self.snr if r["snr_db"] is not None]
        return min(vals) if vals else float("nan")

    def summary(self) -> dict:
        """Worst offenders, one line per health axis."""
        def _argmax(fam, key):
            rows = [r for r in self.rows
                    if r["family"] == fam and r.get(key) is not None]
            return max(rows, key=lambda r: r[key]) if rows else None

        sat = _argmax("requant", "saturation_rate")
        tight = _argmax("requant", "bound_tightness")
        snr = min((r for r in self.snr if r["snr_db"] is not None),
                  key=lambda r: r["snr_db"], default=None)
        return {
            "int32_clip_total": self.total_int32_clip(),
            "worst_saturation": None if sat is None else
            {"op": sat["op"], "site": sat["site"],
             "rate": sat["saturation_rate"]},
            "worst_tightness": None if tight is None else
            {"op": tight["op"], "site": tight["site"],
             "tightness": tight["bound_tightness"]},
            "min_snr": None if snr is None else
            {"layer": snr["layer"], "snr_db": snr["snr_db"]},
        }

    # -- serialization (repro.numerics/v1) -----------------------------
    def to_doc(self) -> dict:
        return {"schema": NUMERICS_SCHEMA, "program": self.program,
                "rounding": self.rounding, "batch": self.batch,
                "rows": self.rows, "snr": self.snr,
                "summary": self.summary()}

    @classmethod
    def from_doc(cls, doc: dict) -> "NumericsReport":
        if doc.get("schema") != NUMERICS_SCHEMA:
            raise ValueError(f"not a {NUMERICS_SCHEMA} document: "
                             f"schema={doc.get('schema')!r}")
        return cls(program=doc["program"], rounding=doc["rounding"],
                   batch=doc["batch"], rows=doc["rows"],
                   snr=doc.get("snr", []))

    # -- text ----------------------------------------------------------
    def format(self) -> str:
        lines = [f"[{self.program}] numerics report "
                 f"(rounding={self.rounding}, batch {self.batch})"]
        req = [r for r in self.rows if r["family"] == "requant"]
        if req:
            lines.append(f"  {'op':<8}{'site':<12}{'n':>9}{'sat%':>8}"
                         f"{'clip32':>8}{'acc_peak':>12}{'bound':>12}"
                         f"{'tight%':>8}{'bits':>6}")
            for r in req:
                bound = r.get("acc_bound")
                tight = r.get("bound_tightness")
                lines.append(
                    f"  {r['op']:<8}{r['site']:<12}{r['n']:>9}"
                    f"{r['saturation_rate'] * 100:>7.2f}%"
                    f"{r['int32_clip']:>8}{r['acc_peak']:>12}"
                    f"{bound if bound is not None else '-':>12}"
                    + (f"{tight * 100:>7.1f}%" if tight is not None
                       else f"{'-':>8}")
                    + f"{r['acc_bits']:>6}")
        outs = [r for r in self.rows if r["family"] == "output"]
        if outs:
            lines.append(f"  {'op':<8}{'output range':<16}{'frac':>6}"
                         f"{'util%':>8}")
            for r in outs:
                rng = "[{}, {}]".format(r["out_min"], r["out_max"])
                frac = r["frac"] if r["frac"] is not None else "-"
                lines.append(f"  {r['op']:<8}{rng:<16}{frac:>6}"
                             f"{r['range_util'] * 100:>7.1f}%")
        if self.snr:
            lines.append(f"  {'layer':<8}{'out_frac':>9}{'snr_db':>9}")
            for r in self.snr:
                snr = "inf" if r["snr_db"] is None else f"{r['snr_db']:.1f}"
                lines.append(f"  {r['layer']:<8}{r['out_frac']:>9}"
                             f"{snr:>9}")
        s = self.summary()
        worst = []
        if s["worst_saturation"]:
            w = s["worst_saturation"]
            worst.append(f"saturation {w['op']}/{w['site']} "
                         f"{w['rate'] * 100:.2f}%")
        if s["worst_tightness"]:
            w = s["worst_tightness"]
            worst.append(f"tightness {w['op']}/{w['site']} "
                         f"{w['tightness'] * 100:.1f}%")
        if s["min_snr"]:
            worst.append(f"min snr {s['min_snr']['layer']} "
                         f"{s['min_snr']['snr_db']:.1f} dB")
        lines.append(f"  int32 clips: {s['int32_clip_total']}"
                     + ("; worst: " + "; ".join(worst) if worst else ""))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------
def run_numerics(qnet, images, *, params=None, metrics=None,
                 program=None) -> NumericsReport:
    """Probe one EdgeVM pass of `qnet` over `images` (floats) and
    return the report; with `params` (the float weights the model was
    quantized from) the per-layer SNR rows are included."""
    from repro_torch.edge import EdgeVM, lower

    if program is None:
        program = lower(qnet)
    vm = EdgeVM(program)
    x = np.asarray(images, np.float32)
    with torch.inference_mode():
        x_q = _host(qnet.quantize_input(
            torch.as_tensor(x, device=qnet.device)))
    probe = NumericsProbe(metrics=metrics)
    with probing(probe):
        vm.run(x_q)
    snr = snr_rows(qnet.pipeline, params, qnet, x) \
        if params is not None else []
    return NumericsReport(program=program.name, rounding=program.rounding,
                          batch=int(x_q.shape[0]), rows=probe.rows(),
                          snr=snr)


def run_program_numerics(program, x_q, *, metrics=None):
    """(output, NumericsReport) for one probed EdgeVM pass over an
    already-quantized batch — the artifact-only surface (no float
    oracle, so no SNR rows)."""
    from repro_torch.edge import EdgeVM

    probe = NumericsProbe(metrics=metrics)
    with probing(probe):
        out = EdgeVM(program).run(x_q)
    batch = int(np.asarray(x_q).shape[0]) \
        if np.asarray(x_q).ndim > len(program.input_tensor.shape) else 1
    return out, NumericsReport(program=program.name,
                               rounding=program.rounding, batch=batch,
                               rows=probe.rows())


def check_containment(program, report: NumericsReport) -> list:
    """`observed range ⊆ static interval bound`, op/tensor-precise.

    Joins the report's requant rows against
    `repro_torch.analysis.ranges.requant_bounds` (every requantization point's
    statically proven |int32| bound) and the output rows against the
    static int8 intervals.  Empty list = the verifier's proofs hold in
    practice; any finding means probe and proof disagree."""
    from repro_torch.analysis.ranges import requant_bounds

    sites, out_ivs = requant_bounds(program)
    findings = []
    for row in report.rows:
        idx = row.get("op_index")
        if idx is None:
            continue
        if row["family"] == "requant":
            bound = sites.get((idx, row["site"]))
            if bound is not None and row["acc_peak"] > bound:
                findings.append(
                    f"op[{idx}] {row['op']}/{row['site']}: observed "
                    f"|acc| {row['acc_peak']} exceeds the static bound "
                    f"{bound}")
        elif row["family"] == "output":
            lo, hi = out_ivs.get(idx, (INT8_MIN, INT8_MAX))
            if row["out_min"] < lo or row["out_max"] > hi:
                findings.append(
                    f"op[{idx}] {row['op']} output: observed range "
                    f"[{row['out_min']}, {row['out_max']}] outside the "
                    f"static interval [{lo}, {hi}]")
    return findings
