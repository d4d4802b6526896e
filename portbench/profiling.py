"""The reduction of a `torch.profiler` trace (Chrome trace-event JSON) to
what the per-layer metrics read: every device operation (kernels,
copies, memsets) with its name and interval, their union, and the idle
gaps between them named by the host range open at the time, and every
host range (`user_annotation`: the spans of the program and of the
generator, which the traced run records as `record_function` ranges).
"""
from __future__ import annotations

import collections
import dataclasses
import json

from portbench.yardstick import gaps, union_s

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120


@dataclasses.dataclass
class Profile:
    device_ops: list        # (name, start_s, dur_s, cat)
    host_ranges: list       # (name, start_s, end_s)
    wall_s: float           # the profiled stretch, host clock
    waves: list             # (bucket, n_real) of the stretch's waves

    @classmethod
    def load(cls, path, wall_s: float, waves: list) -> "Profile":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                dev.append((e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6, cat))
            elif cat == "user_annotation":
                host.append((e["name"], e["ts"] * 1e-6,
                             (e["ts"] + e["dur"]) * 1e-6))
        return cls(device_ops=dev, host_ranges=host, wall_s=wall_s,
                   waves=waves)

    def kernels(self):
        return [op for op in self.device_ops if op[3] == "kernel"]

    def busy_s(self) -> float:
        return union_s((s, s + d) for _, s, d, _ in self.device_ops)

    def calls(self, token: str) -> list:
        """Durations of the kernels whose name holds `token`."""
        return [d for n, _, d, _ in self.kernels() if token in n]

    def top_ops(self, n: int = 10) -> list:
        tot = collections.Counter()
        for name, _, d, _ in self.device_ops:
            tot[name[:NAME_CHARS]] += d
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_by_host(self, n: int = 10) -> list:
        """Idle seconds between device operations, summed by the
        innermost host range open at each gap's midpoint ("none" where
        none is); the n largest.  Of ranges that open together, the
        longer is the outer."""
        holes = gaps((s, s + d) for _, s, d, _ in self.device_ops)
        points = []
        for i, (name, a, b) in enumerate(self.host_ranges):
            points.append((a, 0, -b, i))
            points.append((b, 2, 0, i))
        for j, (a, b) in enumerate(holes):
            points.append(((a + b) / 2, 1, 0, j))
        points.sort()
        stack, tot = [], collections.Counter()
        for _, kind, _, k in points:
            if kind == 0:
                stack.append(k)
            elif kind == 2:
                if k in stack:
                    stack.remove(k)
            else:
                a, b = holes[k]
                name = self.host_ranges[stack[-1]][0] if stack else "none"
                tot[name] += b - a
        return [[k, v] for k, v in tot.most_common(n)]
