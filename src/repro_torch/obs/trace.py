"""Hierarchical span tracer with an injectable clock.

One `Tracer` records a forest of `Span`s: a span is opened as a context
manager, nests under whichever span is currently open on the tracer's
stack, and captures enter/exit timestamps from the tracer's clock (a
plain callable, so tests drive a fake clock and pin exact trees).

Instrumented code never talks to a `Tracer` directly — it calls the
module-level `span(name, **args)`, which resolves the AMBIENT tracer
(installed with `set_tracer` / scoped with `tracing`).  When no tracer
is installed, `span()` returns one shared no-op object without reading
the clock or allocating — tracing is free when it is off, which is what
lets the serving/VM hot paths stay instrumented permanently (traced and
untraced runs are pinned bit-identical in tests/test_obs.py).

Export is the Chrome trace-event JSON format ("complete" `ph:"X"`
events, microsecond timestamps), loadable in chrome://tracing or
Perfetto:

    tracer = Tracer()
    with tracing(tracer):
        serve_window(...)
    tracer.write_chrome_trace("serve_trace.json")
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


class Span:
    """One timed region: name + args + [t0, t1) + child spans.

    Created by `Tracer.span`; entering attaches it to the current top of
    the tracer's stack (or the root list) and stamps t0, exiting stamps
    t1.  `dur_s` is None while the span is still open.
    """

    __slots__ = ("name", "args", "t0", "t1", "children", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.name = name
        self.args = args
        self.t0: float | None = None
        self.t1: float | None = None
        self.children: list = []
        self._tracer = tracer

    @property
    def dur_s(self) -> float | None:
        if self.t0 is None or self.t1 is None:
            return None
        return self.t1 - self.t0

    def note(self, **args) -> None:
        """Attach args discovered after the span opened (e.g. the wave
        membership the scheduler only knows once the bucket is built)."""
        self.args.update(args)

    def __enter__(self) -> "Span":
        t = self._tracer
        (t._stack[-1].children if t._stack else t.roots).append(self)
        t._stack.append(self)
        self.t0 = t.clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = self._tracer.clock()
        # tolerate exception-driven unwinds that skipped inner __exit__s
        stack = self._tracer._stack
        while stack and stack.pop() is not self:
            pass
        return False

    def find(self, name: str) -> list:
        """All descendant spans (including self) with this name."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out

    def __repr__(self):
        return (f"Span({self.name!r}, t0={self.t0}, t1={self.t1}, "
                f"children={len(self.children)})")


class _NullSpan:
    """The shared do-nothing span `span()` hands out when tracing is
    off: no clock read, no allocation, reentrant."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **args):
        pass

    def find(self, name):
        return []


NULL_SPAN = _NullSpan()


class Tracer:
    """Records spans into a forest; not thread-safe by design (the
    serving engine and trainer are single-threaded drivers)."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.roots: list = []
        self._stack: list = []

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def span(self, name: str, **args) -> Span:
        return Span(self, name, args)

    def reset(self) -> None:
        self.roots = []
        self._stack = []

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def find(self, name: str) -> list:
        out = []
        for r in self.roots:
            out.extend(r.find(name))
        return out

    def span_count(self) -> int:
        def walk(s):
            return 1 + sum(walk(c) for c in s.children)
        return sum(walk(r) for r in self.roots)

    # ------------------------------------------------------------------
    # Chrome trace-event export
    # ------------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The trace as a Chrome trace-event JSON object ("X" complete
        events; ts/dur in microseconds, shifted so the earliest span
        starts at 0).  Open spans are exported with zero duration."""
        events: list = []

        def t0s(s):
            yield s.t0
            for c in s.children:
                yield from t0s(c)

        starts = [t for r in self.roots for t in t0s(r) if t is not None]
        epoch = min(starts) if starts else 0.0

        def emit(s: Span):
            if s.t0 is not None:
                end = s.t1 if s.t1 is not None else s.t0
                events.append({
                    "name": s.name, "ph": "X", "pid": 0, "tid": 0,
                    "cat": s.name.split(".", 1)[0],
                    "ts": (s.t0 - epoch) * 1e6,
                    "dur": (end - s.t0) * 1e6,
                    "args": {k: _json_safe(v) for k, v in s.args.items()},
                })
            for c in s.children:
                emit(c)

        for r in self.roots:
            emit(r)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.chrome_trace(), sort_keys=True))
        return path


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


# ---------------------------------------------------------------------------
# ambient tracer: what instrumented code talks to
# ---------------------------------------------------------------------------
_AMBIENT: Tracer | None = None


def get_tracer() -> Tracer | None:
    return _AMBIENT


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install `tracer` as the process-ambient tracer; returns the
    previous one (so callers can restore it)."""
    global _AMBIENT
    prev = _AMBIENT
    _AMBIENT = tracer
    return prev


@contextlib.contextmanager
def tracing(tracer: Tracer):
    """Scoped `set_tracer`: ambient within the with-block, restored
    after (exception-safe)."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def span(name: str, *, tracer: Tracer | None = None, **args):
    """Open a span on `tracer`, or on the ambient tracer when none is
    given; the shared NULL_SPAN when tracing is off."""
    t = _AMBIENT if tracer is None else tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, **args)
