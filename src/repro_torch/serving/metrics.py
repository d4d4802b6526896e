"""Serving metrics: per-request latency (p50/p95/p99 from enqueue to
completion), queue depth at submit time, wave occupancy (real rows /
bucket rows) and aggregate images/s over the first-submit ->
last-completion window.

Everything is recorded through the engine's injectable clock, so tests
can drive a fake clock.  The low-level accessors return nan on an empty
window; `summary()` carries an `empty` flag with None for every
undefined figure, and `report()` says "no completed requests".
"""
from __future__ import annotations

import numpy as np


class ServeMetrics:
    def __init__(self):
        self.latencies_s: list = []          # one per completed request
        self.waves: list = []                # dicts: bucket/n_real/exec_s
        self.queue_depths: list = []         # depth sampled at each submit
        self.t_first_submit: float | None = None
        self.t_last_done: float | None = None

    # ------------------------------------------------------------------
    # recording (called by the engine)
    # ------------------------------------------------------------------
    def record_submit(self, t: float, queue_depth: int) -> None:
        if self.t_first_submit is None:
            self.t_first_submit = t
        self.queue_depths.append(queue_depth)

    def record_wave(self, *, bucket: int, n_real: int, exec_s: float,
                    t_done: float, latencies_s) -> None:
        self.waves.append(
            {"bucket": bucket, "n_real": n_real, "exec_s": exec_s})
        self.latencies_s.extend(latencies_s)
        self.t_last_done = t_done

    # ------------------------------------------------------------------
    # derived figures
    # ------------------------------------------------------------------
    @property
    def images_done(self) -> int:
        return len(self.latencies_s)

    @property
    def waves_run(self) -> int:
        return len(self.waves)

    def latency_percentile(self, p: float) -> float:
        """p-th percentile request latency in seconds (nan when empty)."""
        if not self.latencies_s:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_s), p))

    def occupancy(self) -> float:
        """Mean fraction of wave rows that carried a real request."""
        if not self.waves:
            return float("nan")
        return float(np.mean([w["n_real"] / w["bucket"] for w in self.waves]))

    def images_per_s(self) -> float:
        """Aggregate throughput over the serving window (wall clock from
        first submit to last completion; summed exec time for a
        zero-width window, e.g. under a frozen fake clock)."""
        if not self.images_done:
            return float("nan")
        wall = 0.0
        if self.t_first_submit is not None and self.t_last_done is not None:
            wall = self.t_last_done - self.t_first_submit
        if wall <= 0.0:
            wall = sum(w["exec_s"] for w in self.waves)
        return self.images_done / wall if wall > 0 else float("nan")

    def max_queue_depth(self) -> int:
        return max(self.queue_depths, default=0)

    def summary(self) -> dict:
        """JSON-safe summary: undefined figures are None, never nan."""
        def _figure(x: float):
            return None if not np.isfinite(x) else float(x)
        return {
            "empty": self.images_done == 0,
            "images": self.images_done,
            "waves": self.waves_run,
            "p50_ms": _figure(self.latency_percentile(50) * 1e3),
            "p95_ms": _figure(self.latency_percentile(95) * 1e3),
            "p99_ms": _figure(self.latency_percentile(99) * 1e3),
            "occupancy": _figure(self.occupancy()),
            "images_per_s": _figure(self.images_per_s()),
            "max_queue_depth": self.max_queue_depth(),
        }

    def report(self) -> str:
        s = self.summary()
        if s["empty"]:
            return ("serve: no completed requests "
                    f"(queued submits: {len(self.queue_depths)}, "
                    f"max queue {s['max_queue_depth']})")

        def _fmt(x, spec):
            return "n/a" if x is None else format(x, spec)
        return (f"serve: {s['images']} imgs in {s['waves']} waves | "
                f"latency p50 {_fmt(s['p50_ms'], '.1f')} / p95 "
                f"{_fmt(s['p95_ms'], '.1f')} / p99 {_fmt(s['p99_ms'], '.1f')}"
                f" ms | occupancy {_fmt(s['occupancy'], '.2f')} | "
                f"{_fmt(s['images_per_s'], '.1f')} img/s | max queue "
                f"{s['max_queue_depth']}")
