"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the reference, and the result.

Set-up (what `setup_s` measures, from the process's start): the CUDA
kernels loaded through `repro_torch.kernels.build` (built on the first
run in a checkout, into its `build/` directory), the float weights,
calibration images and request pool drawn from the seed on the device,
the port's PTQ on the card (`CapsPipeline.quantize`), the model installed
in a `ModelRegistry`, and each bucket the cell's waves use run twice
through a `CapsServeEngine`.

The window drives that engine for `seconds`: `submit` for each request,
`step` for each wave.  A traced run (`--trace 1`) records the duration of
every span the program and the generator open (`ptq.*` in set-up,
`serve.*` and `loadgen.submit` in the window) in its first stretch, then
puts the last `PROFILE_S` seconds under `torch.profiler`, with every span
recorded as a `record_function` range so that idle gaps can be named.
The metric readers choose what they read.

A sample of the completions is kept, drawn from the seed: every wave
that carries a request of the pool's first pass, and one wave in
`KEEP_EVERY`.  After the window (the memory peak read, the program's
state freed) the reference answers each kept request's pool image.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import data, judge, spec, yardstick
from portbench.loadgen import Traffic
from portbench.profiling import Profile

MODEL_ID = "portbench"
PROFILE_S = 2.0
KEEP_EVERY = 8
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class _Timed:
    __slots__ = ("out", "t0")

    def __init__(self, out: list):
        self.out = out

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.out.append(time.perf_counter() - self.t0)
        return False

    def note(self, **args):
        pass


class SpanTimes:
    """An ambient tracer for `repro_torch.obs` that keeps the duration of
    every span, by name, in the order they closed."""

    def __init__(self):
        self.times = collections.defaultdict(list)

    def span(self, name, **args):
        return _Timed(self.times[name])


class _Range:
    __slots__ = ("rf",)

    def __init__(self, name):
        import torch
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        return self.rf.__exit__(*exc)

    def note(self, **args):
        pass


class Ranges:
    """The ambient tracer of the profiled stretch: every span becomes a
    `record_function` range in the profiler's trace."""

    def span(self, name, **args):
        return _Range(name)


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (`metrics/<name>.py`)."""
    cell: spec.Cell
    setup_s: float
    window_s: float            # the whole window, host clock
    completed: int             # requests completed inside it
    image_ops: int
    # a traced run's spans, from set-up to the profiler's start, and its
    # unprofiled stretch of the window: {span name: [seconds]}
    spans: dict | None = None
    stretch: dict | None = None
    profile: Profile | None = None


def program_config(cfg: dict):
    from repro_torch.nn.config import CapsNetConfig
    return CapsNetConfig(
        name=cfg["name"], input_shape=tuple(cfg["input_shape"]),
        conv_filters=tuple(cfg["conv_filters"]),
        conv_kernels=tuple(cfg["conv_kernels"]),
        conv_strides=tuple(cfg["conv_strides"]),
        pcap_caps=cfg["pcap_caps"], pcap_dim=cfg["pcap_dim"],
        pcap_kernel=cfg["pcap_kernel"], pcap_stride=cfg["pcap_stride"],
        num_classes=cfg["num_classes"], caps_dim=cfg["caps_dim"],
        routings=cfg["routings"])


class Window:
    """Drives the engine for one window and keeps what the metrics and
    the comparison need: each wave's first request, size, bucket and
    completion time, and the kept waves' completions."""

    def __init__(self, engine, traffic: Traffic, pool, seed: int):
        self.engine, self.traffic, self.pool = engine, traffic, pool
        self.keep_slot = seed % KEEP_EVERY
        self.waves: list = []          # (first rid, n, bucket, t_done)
        self.kept: list = []
        self.sent = 0

    def submit(self) -> None:
        k = self.sent
        rid = self.engine.submit(self.pool[k % len(self.pool)], MODEL_ID)
        if rid != k:
            raise RuntimeError(f"request {k} got id {rid}: the pool index "
                               "of a completion is its id")
        self.sent += 1

    def step(self) -> None:
        done = self.engine.step()
        t = time.perf_counter()
        if not done:
            return
        r0, n = done[0].rid, len(done)
        if done[-1].rid - r0 + 1 != n:
            raise RuntimeError("a wave's requests are not consecutive")
        w = len(self.waves)
        self.waves.append((r0, n, done[0].bucket, t))
        if r0 < len(self.pool) or w % KEEP_EVERY == self.keep_slot:
            self.kept.extend(done)

    def run(self, seconds: float, switch_at: float | None,
            on_switch) -> tuple:
        """The closed loop; `on_switch` runs once when `switch_at`
        seconds have passed.  Returns (t0, t_stop)."""
        import repro_torch.obs as obs
        t0 = time.perf_counter()
        t_end = t0 + seconds
        t_switch = math.inf if switch_at is None else t0 + switch_at
        refill, engine = self.traffic.refill_to, self.engine
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            if now >= t_switch:
                on_switch(len(self.waves))
                t_switch = math.inf
                # the profiler's start is no part of the traffic: the
                # window moves on by it
                t_end += time.perf_counter() - now
            with obs.span("loadgen.submit"):
                while engine.queue_depth() < refill:
                    self.submit()
            self.step()
        return t0, time.perf_counter()


class _Parts:
    """The set-up's parts on the host clock, each from the end of the
    one before."""

    def __init__(self, t_start: float):
        self.t, self.s = t_start, {}

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self.s[name] = t - self.t
        self.t = t


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", backend: str = "cuda",
             t_start: float | None = None) -> tuple:
    """Run one cell.  Returns (result dict, detail dict)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    import repro_torch.obs as obs
    from repro_torch.nn.pipeline import CapsPipeline
    from repro_torch.serving.engine import CapsServeEngine
    from repro_torch.serving.registry import ModelRegistry

    parts = _Parts(t_start)
    parts.mark("imports")
    cuda = device == "cuda"
    traffic = Traffic.of(cell.traffic)
    times = SpanTimes() if trace else None
    prev_tracer = obs.set_tracer(times)
    try:
        # -- set-up ---------------------------------------------------------
        if cuda:
            torch.empty(1, device=device)
            torch.cuda.synchronize()
        parts.mark("device_init")
        if cuda:
            from repro_torch.kernels import build
            build.load("squash_q7")
            build.load("routing_q7")
        parts.mark("kernels_load")
        params, calib, pool = data.draw(cell.config, seed, traffic.pool,
                                        device)
        if cuda:
            torch.cuda.synchronize()
        parts.mark("draw")
        pipe = CapsPipeline.from_config(program_config(cell.config))
        qnet = pipe.quantize(
            {k: {n: p.clone() for n, p in v.items()} for k, v in params.items()},
            calib.clone(), rounding="floor", backend=backend)
        parts.mark("ptq")
        registry = ModelRegistry(specs={}, device=device)
        registry.install(MODEL_ID, qnet)
        engine = CapsServeEngine(registry, buckets=traffic.buckets)
        for _ in range(2):
            engine.warmup(MODEL_ID, buckets=traffic.wave_buckets())
        parts.mark("warmup")
        pool_host = pool.cpu().numpy()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        gc.collect()
        gc.freeze()
        parts.mark("rest")
        setup_s = time.perf_counter() - t_start

        # -- the window -----------------------------------------------------
        win = Window(engine, traffic, pool_host, seed)
        prof, mark = None, {}
        switch_at = None
        if trace:
            switch_at = max(seconds - PROFILE_S, seconds * 2 / 3)

        def on_switch(waves):
            nonlocal prof
            mark.update(waves=waves, t=time.perf_counter())
            if cuda:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            obs.set_tracer(Ranges())
            mark["t_prof"] = time.perf_counter()
            mark["pause"] = mark["t_prof"] - mark["t"]

        t0, t_stop = win.run(seconds, switch_at, on_switch)
        obs.set_tracer(None)
        if cuda:
            torch.cuda.synchronize()
        if prof is not None:
            t = time.perf_counter()
            prof.__exit__(None, None, None)
            mark["end_s"] = time.perf_counter() - t
        window_s = t_stop - t0
        completed = sum(n for _, n, _, t in win.waves if t <= t_stop)
        n_window_waves = len(win.waves)
        per_s = np.bincount(
            [int(t - t0) for _, _, _, t in win.waves],
            weights=[n for _, n, _, _ in win.waves]).astype(int).tolist()

        # the queue left at the close
        while engine.queue_depth():
            win.step()
        if cuda:
            torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        attempted = win.sent
        answered = sum(n for _, n, _, _ in win.waves)

        record = RunRecord(
            cell=cell, setup_s=setup_s, window_s=window_s,
            completed=completed, image_ops=yardstick.image_ops(cell.config))
        if trace:
            w1 = mark.get("waves", n_window_waves)
            t1 = mark.get("t", t_stop)
            stretch_waves = [(b, n) for _, n, b, _ in win.waves[:w1]]
            record.spans = dict(times.times)
            record.stretch = {
                "wall_s": t1 - t0, "waves": stretch_waves,
                "completed": sum(n for _, n in stretch_waves),
            }
            if prof is not None:
                t = time.perf_counter()
                tmp = tempfile.TemporaryDirectory()
                path = Path(tmp.name) / "trace.json"
                prof.export_chrome_trace(str(path))
                record.profile = Profile.load(
                    path, wall_s=t_stop - mark["t_prof"],
                    waves=[(b, n) for _, n, b, _ in
                           win.waves[w1:n_window_waves]])
                tmp.cleanup()
                del prof
                mark["read_s"] = time.perf_counter() - t

        # -- the program's state freed, then the reference --------------------
        kept = win.kept
        del engine, registry, qnet, win
        gc.unfreeze()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        forbidden = forbidden_modules()
        if forbidden:
            raise SystemExit(f"loaded modules of JAX or the JAX package: "
                             f"{forbidden}")
        from portbench.reference import Reference
        t = time.perf_counter()
        ref = Reference(cell.config, params, calib)
        P = len(pool)

        def answers(idx):
            uniq, inv = np.unique(idx, return_inverse=True)
            sel = torch.as_tensor(uniq, device=pool.device)
            v, ln, pr = ref.answers(pool.index_select(0, sel))
            return v[inv], ln[inv], pr[inv]

        checks = judge.compare(kept, lambda rid: rid % P, answers,
                               attempted - answered)
        ref_s = time.perf_counter() - t
    finally:
        obs.set_tracer(prev_tracer)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name() if cuda else device,
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": judge.passed(checks), "attempted": int(attempted),
              "failed": int(attempted - answered), "metrics": metrics,
              "device": dev}
    if trace and record.profile is not None:
        dev["busy_s"] = record.profile.busy_s()
        dev["window_s"] = record.profile.wall_s
        result["breakdown"] = {"device_ops": record.profile.top_ops(),
                               "idle_gaps": record.profile.idle_by_host()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    detail = {"cell": cell.name, "seed": seed, "seconds": seconds,
              "trace": int(trace), "sent": int(attempted),
              "completed_in_window": int(completed),
              "answered": int(answered), "waves": n_window_waves,
              "window_s": window_s, "setup_s": setup_s,
              "setup_parts_s": parts.s, "reference_s": ref_s,
              "compared": len(kept), "completed_per_s": per_s}
    if trace:
        detail.update(profile_start_s=mark.get("pause", 0.0),
                      profile_end_s=mark.get("end_s", 0.0),
                      profile_read_s=mark.get("read_s", 0.0))
    return result, detail
