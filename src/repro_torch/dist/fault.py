"""Fault tolerance: elastic mesh selection, crash-restart driver, and
straggler-aware step timing.

The counterpart of `repro.dist.fault`: pure Python, its logic copied.
`run_with_restarts` wraps the whole training loop: the step callable is
rebuilt from the latest checkpoint on every attempt, so a node failure
costs at most `ckpt_every` steps of work.  `choose_mesh` re-plans the
(pod, data, model) factorization after capacity loss — model parallelism
is fixed by the sharded layer widths, so only pod/data flex.
"""
from __future__ import annotations

import time


def choose_mesh(chips: int, model: int = 16) -> tuple:
    """Factor `chips` into (pod, data, model) with the model axis fixed.

    data is kept as close to 16-wide as possible; losing hosts shrinks
    the data axis (e.g. 480 chips -> (2, 15, 16)).  Raises ValueError
    when `chips` does not factor (training cannot proceed elastically).
    """
    if chips <= 0 or chips % model:
        raise ValueError(f"{chips} chips do not factor over model={model}")
    rest = chips // model
    pod = max(1, -(-rest // 16))            # ceil(rest / 16)
    while pod <= rest and rest % pod:
        pod += 1
    if pod > rest:
        raise ValueError(f"{chips} chips do not factor over model={model}")
    return (pod, rest // pod, model)


def run_with_restarts(fn, max_restarts: int = 2, backoff_s: float = 5.0):
    """Call `fn(attempt)` until it returns, restarting on any exception up
    to `max_restarts` times with linear backoff.  The callable is expected
    to resume from its own checkpoints."""
    attempt = 0
    while True:
        try:
            return fn(attempt)
        except Exception as e:                      # noqa: BLE001
            if attempt >= max_restarts:
                raise
            attempt += 1
            print(f"[restart {attempt}/{max_restarts}] {type(e).__name__}: "
                  f"{e}")
            time.sleep(backoff_s * attempt)


class StepTimer:
    """Wall-clock step timer with a running mean for straggler detection
    (a step is a straggler when it exceeds `factor` x the running mean)."""

    def __init__(self, factor: float = 3.0, warmup: int = 3):
        self.factor = factor
        self.warmup = warmup
        self._t0 = None
        self._n = 0
        self._mean = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._n += 1
        # running mean, excluding compile-dominated warmup steps
        if self._n > self.warmup:
            k = self._n - self.warmup
            self._mean += (dt - self._mean) / k
        return dt

    def is_straggler(self, dt: float) -> bool:
        return self._n > self.warmup + 1 and self._mean > 0 \
            and dt > self.factor * self._mean
