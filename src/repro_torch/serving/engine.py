"""CapsServeEngine: request queue + bucketed micro-batch scheduler.

The engine holds a FIFO request queue and drains it in WAVES: each wave
takes the longest run of queued requests that share the head request's
model, caps it at the largest bucket, and pads the batch up to the
smallest bucket that fits (default 1/4/16/64).  Every wave therefore
runs at one of a few fixed shapes, whose wave functions the registry
caches.

Padding is semantically free: conv, squash and routing act per row, so
pad rows cannot perturb real rows, and the engine's outputs are
bit-identical to calling `QuantCapsNet.forward` directly.  Scheduling is
deterministic: same submission order -> same waves, same buckets, same
bits.  The queue is popped only after a wave succeeds, so a failing
wave leaves its requests queued for a retry.

Spans (repro_torch.obs; free when no tracer is installed): one
`serve.enqueue` per request (arg `req_id`), and per wave a `serve.wave`
(args `model`, `wave`, then `bucket`, `n_real`, `req_ids`) over
`serve.bucket`, `serve.compile`, `serve.execute` (which ends with the
copy to the host, the wave's device sync) and `serve.complete`: the
reference engine's tree, from which `obs.analyze` rebuilds every
request's timeline.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from repro_torch import obs
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.registry import ModelRegistry

DEFAULT_BUCKETS = (1, 4, 16, 64)


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    model_id: str
    image: np.ndarray                # [H,W,C] float32
    t_enq: float


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    model_id: str
    v_q: np.ndarray                  # int8 class capsules [J, O]
    lengths: np.ndarray              # float32 [J]
    pred: int
    wave: int                        # index of the wave that served it
    bucket: int                      # padded wave size
    latency_s: float                 # enqueue -> completion


class CapsServeEngine:
    def __init__(self, registry: ModelRegistry, buckets=DEFAULT_BUCKETS,
                 metrics: ServeMetrics | None = None,
                 clock=time.perf_counter,
                 tracer: obs.Tracer | None = None):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"need positive bucket sizes, got {buckets}")
        self.registry = registry
        self.buckets = buckets
        self.metrics = ServeMetrics() if metrics is None else metrics
        self.clock = clock
        # an explicit tracer wins; otherwise the ambient obs tracer (if
        # installed) takes the spans; NULL_SPAN when neither
        self.tracer = tracer
        self._queue: collections.deque = collections.deque()
        self._next_rid = 0
        self._next_wave = 0

    def _span(self, name: str, **args):
        if self.tracer is not None:
            return self.tracer.span(name, **args)
        return obs.span(name, **args)

    # ------------------------------------------------------------------
    # queue side
    # ------------------------------------------------------------------
    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def queue_depth(self) -> int:
        return len(self._queue)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits n rows."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"wave of {n} exceeds max bucket {self.max_bucket}")

    def submit(self, image, model_id: str) -> int:
        if not self.registry.has(model_id):
            raise KeyError(f"unknown model {model_id!r}; have "
                           f"{self.registry.model_ids()}")
        image = np.asarray(image, np.float32)
        shape = self.registry.input_shape(model_id)
        if image.shape != shape:
            raise ValueError(
                f"{model_id} expects image shape {shape}, got {image.shape}")
        rid = self._next_rid
        self._next_rid += 1
        with self._span("serve.enqueue", model=model_id, req_id=rid):
            t = self.clock()
            self._queue.append(Request(rid, model_id, image, t))
            self.metrics.record_submit(t, len(self._queue))
        return rid

    def submit_many(self, images, model_id: str) -> list:
        return [self.submit(img, model_id) for img in images]

    # ------------------------------------------------------------------
    # scheduler side
    # ------------------------------------------------------------------
    def step(self) -> list:
        """Drain ONE wave: the longest same-model run at the queue head,
        capped at the largest bucket.  Returns its completions in
        submission order ([] when idle)."""
        if not self._queue:
            return []
        model_id = self._queue[0].model_id
        with self._span("serve.wave", model=model_id,
                        wave=self._next_wave) as wave_span:
            with self._span("serve.bucket"):
                wave: list = []
                for r in self._queue:            # peek, don't pop yet
                    if (r.model_id != model_id
                            or len(wave) == self.max_bucket):
                        break
                    wave.append(r)
                bucket = self.bucket_for(len(wave))
                x = np.zeros(
                    (bucket,) + self.registry.input_shape(model_id),
                    np.float32)
                for i, r in enumerate(wave):
                    x[i] = r.image
            # the analyzer rebuilds per-request timelines by joining
            # enqueue req_id against this membership (comma-joined: span
            # args are scalar-or-string in the Chrome export)
            req_ids = ",".join(str(r.rid) for r in wave)
            wave_span.note(bucket=bucket, n_real=len(wave),
                           req_ids=req_ids)

            # the registry adds serving.compile_wave / serving.ptq_build
            # child spans on a cache miss; a hit is just the lookup
            with self._span("serve.compile", bucket=bucket):
                exe = self.registry.executable(model_id, bucket)
            with self._span("serve.execute", bucket=bucket,
                            n_real=len(wave)):
                t0 = self.clock()
                # the host copies wait for the device, so t_done ends the
                # work
                v_q, lengths, pred = (t.cpu().numpy() for t in exe(x))
                t_done = self.clock()
            with self._span("serve.complete", req_ids=req_ids):
                # only now is the wave irrevocably served: a raising wave
                # leaves the queue intact so the requests can be retried
                for _ in wave:
                    self._queue.popleft()
                wave_idx = self._next_wave
                self._next_wave += 1
                done = [Completion(rid=r.rid, model_id=model_id,
                                   v_q=v_q[i], lengths=lengths[i],
                                   pred=int(pred[i]), wave=wave_idx,
                                   bucket=bucket,
                                   latency_s=t_done - r.t_enq)
                        for i, r in enumerate(wave)]
                self.metrics.record_wave(
                    bucket=bucket, n_real=len(wave), exec_s=t_done - t0,
                    t_done=t_done,
                    latencies_s=[c.latency_s for c in done])
        return done

    def drain(self) -> list:
        """Run waves until the queue is empty; completions in submission
        order per model run."""
        out: list = []
        while self._queue:
            out.extend(self.step())
        return out

    def warmup(self, model_id: str, buckets=None) -> None:
        """Build the model, bind its wave functions and run each once on
        zeros, so first-request latency excludes PTQ, the kernels' build
        and the device's lazy set-up."""
        shape = self.registry.input_shape(model_id)
        for b in (self.buckets if buckets is None else buckets):
            for t in self.registry.executable(model_id, b)(
                    np.zeros((b,) + shape, np.float32)):
                t.cpu()


def serve_window(registry, buckets, images, model_id, *,
                 metrics_registry=None) -> tuple:
    """Serve every image through a fresh warmed engine, timing submit ->
    drained.  Returns (engine, completions, wall_s).  `metrics_registry`
    mirrors the window's ServeMetrics into an obs.MetricsRegistry."""
    metrics = None if metrics_registry is None \
        else ServeMetrics(registry=metrics_registry)
    engine = CapsServeEngine(registry, buckets=buckets, metrics=metrics)
    engine.warmup(model_id)
    t0 = time.perf_counter()
    engine.submit_many(images, model_id)
    done = engine.drain()
    wall = time.perf_counter() - t0
    if len(done) != len(images):
        raise RuntimeError(f"served {len(done)} of {len(images)} requests")
    return engine, done, wall
