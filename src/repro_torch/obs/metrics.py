"""Process-wide metrics registry: counters / gauges / histograms with
labeled series behind one `snapshot() -> dict` face.

The port's counters (`CudaBackend.fallbacks`, `ModelRegistry`'s build
and wave-cache counts, `ServeMetrics`' recordings) are *views* over
instruments registered here, as the reference's `repro.obs.metrics`
makes them: the single source of truth is a `MetricsRegistry`, so one
`snapshot()` (JSON-safe) shows everything a process counted, and the
same operations give the reference's snapshot.

Instruments are get-or-create by name (re-registering with a different
kind is an error) and hold labeled series: `inc/set/observe` take
keyword labels, and every distinct label combination is its own series.

    reg = MetricsRegistry()
    falls = reg.counter("cuda.fallback_decisions")
    falls.inc(op="squash", variant="approx")
    reg.snapshot()
    # {"cuda.fallback_decisions": {"kind": "counter", "series":
    #    [{"labels": {"op": "squash", "variant": "approx"}, "value": 1}]}}

`METRICS` is the process-default registry (module singletons like the
cuda backend record there); objects that need isolated counts — a
fresh `ModelRegistry`, a `ServeMetrics` window — default to a private
registry instead, exactly matching the per-instance semantics their old
ad-hoc counters had.
"""
from __future__ import annotations

from collections.abc import Mapping

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                   float("inf"))


def _key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Instrument:
    kind = "?"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict = {}          # label tuple -> value

    def series(self) -> dict:
        """label tuple (sorted (k, v) pairs) -> current value."""
        return dict(self._series)

    def view(self, *label_names) -> "SeriesView":
        """A read-only Mapping over the series, keyed by the values of
        `label_names` (a single name maps to plain keys, several to
        tuples) — the shape old `collections.Counter` attributes had."""
        return SeriesView(self, label_names)


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment "
                             f"{amount}")
        k = _key(labels)
        self._series[k] = self._series.get(k, 0) + amount

    def value(self, **labels):
        return self._series.get(_key(labels), 0)

    def total(self):
        """Sum over every labeled series."""
        return sum(self._series.values())


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_key(labels)] = value

    def value(self, **labels):
        return self._series.get(_key(labels), 0)


class Histogram(_Instrument):
    """Fixed-bucket histogram (per labeled series: count / sum / min /
    max / cumulative bucket counts).  Percentile-grade data stays with
    the callers that need it (e.g. ServeMetrics keeps raw latencies);
    this is the cheap always-on aggregate."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets or self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)

    def observe(self, value: float, **labels) -> None:
        k = _key(labels)
        s = self._series.get(k)
        if s is None:
            s = self._series[k] = {"count": 0, "sum": 0.0,
                                   "min": float("inf"),
                                   "max": float("-inf"),
                                   "bucket_counts": [0] * len(self.buckets)}
        s["count"] += 1
        s["sum"] += value
        s["min"] = min(s["min"], value)
        s["max"] = max(s["max"], value)
        for i, b in enumerate(self.buckets):
            if value <= b:
                s["bucket_counts"][i] += 1
                break

    def count(self, **labels) -> int:
        s = self._series.get(_key(labels))
        return 0 if s is None else s["count"]

    def sum(self, **labels) -> float:
        s = self._series.get(_key(labels))
        return 0.0 if s is None else s["sum"]

    def percentile(self, p: float, **labels) -> float | None:
        """Bucket-resolution p-th percentile of one labeled series.

        Tiny samples are pinned, never interpolated: 0 observations ->
        None, 1 or 2 observations -> the exact max (any interpolation
        between two points is presentation noise, not signal).  With
        n >= 3 the estimate is the nearest-rank bucket upper bound,
        clamped to the observed max so the +inf bucket (and a sparse top
        bucket) can never report a value no observation reached."""
        s = self._series.get(_key(labels))
        if s is None or s["count"] == 0:
            return None
        if s["count"] < 3:
            return s["max"]
        rank = max(1, min(s["count"],
                          -(-int(p * s["count"]) // 100)))  # ceil, no float
        cum = 0
        for bound, n in zip(self.buckets, s["bucket_counts"]):
            cum += n
            if cum >= rank:
                return min(bound, s["max"])
        return s["max"]

    def summary(self, **labels) -> dict:
        """count/sum/min/max + pinned p50/p95/p99 of one series (the
        shape `snapshot()` embeds per histogram series)."""
        s = self._series.get(_key(labels))
        if s is None:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "p50": None, "p95": None, "p99": None}
        return {"count": s["count"], "sum": s["sum"],
                "min": s["min"], "max": s["max"],
                "p50": self.percentile(50, **labels),
                "p95": self.percentile(95, **labels),
                "p99": self.percentile(99, **labels)}


class SeriesView(Mapping):
    """Counter-shaped read-only view over one instrument's series.

    Keys are label VALUES: with one label name plain values, with
    several a tuple in the given order — so
    `backend.fallbacks[("squash", "approx")]` reads like the
    `collections.Counter` it replaced (a missing key raises KeyError)."""

    def __init__(self, instrument: _Instrument, label_names: tuple):
        self._ins = instrument
        self._names = tuple(label_names)

    def _as_dict(self) -> dict:
        out = {}
        for k, v in self._ins.series().items():
            labels = dict(k)
            if len(self._names) == 1:
                out[labels.get(self._names[0])] = v
            else:
                out[tuple(labels.get(n) for n in self._names)] = v
        return out

    def __getitem__(self, key):
        return self._as_dict()[key]

    def __iter__(self):
        return iter(self._as_dict())

    def __len__(self):
        return len(self._as_dict())

    def __repr__(self):
        return f"SeriesView({self._ins.name}: {self._as_dict()!r})"


class MetricsRegistry:
    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self, name: str = "metrics"):
        self.name = name
        self._instruments: dict = {}

    # ------------------------------------------------------------------
    # registration (get-or-create; kind mismatches are loud)
    # ------------------------------------------------------------------
    def _register(self, cls, name, help, **kw):
        ins = self._instruments.get(name)
        if ins is not None:
            if not isinstance(ins, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {ins.kind}, "
                    f"not {cls.kind}")
            return ins
        ins = cls(name, help, **kw)
        self._instruments[name] = ins
        return ins

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Instrument:
        return self._instruments[name]

    def names(self) -> tuple:
        return tuple(sorted(self._instruments))

    # ------------------------------------------------------------------
    # the one face everything is read through
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Every instrument's every series, as one JSON-safe dict."""
        out = {}
        for name in sorted(self._instruments):
            ins = self._instruments[name]
            series = []
            for k, v in sorted(ins.series().items()):
                value = _json_value(v)
                if isinstance(ins, Histogram):
                    labels = dict(k)
                    for p in (50, 95, 99):
                        q = ins.percentile(p, **labels)
                        value[f"p{p}"] = \
                            q if q is None or abs(q) != float("inf") \
                            else None
                series.append({"labels": dict(k), "value": value})
            entry = {"kind": ins.kind, "help": ins.help, "series": series}
            if isinstance(ins, Histogram):
                entry["buckets"] = [b if b != float("inf") else "inf"
                                    for b in ins.buckets]
            out[name] = entry
        return out

    def reset(self) -> None:
        for ins in self._instruments.values():
            ins._series = {}


def _json_value(v):
    if isinstance(v, dict):       # histogram series
        out = dict(v)
        for k in ("min", "max"):
            if k in out and out[k] in (float("inf"), float("-inf")):
                out[k] = None
        return out
    return v


# The process-default registry: module-level singletons (e.g. the shared
# cuda backend in nn.backend.BACKENDS) record here, so one snapshot at
# the end of a CLI run sees them all.
METRICS = MetricsRegistry("process")
