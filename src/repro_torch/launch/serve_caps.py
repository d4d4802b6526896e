"""Batched int8 CapsNet serving driver.

  PYTHONPATH=src python -m repro_torch.launch.serve_caps --model mnist@cuda \
      --requests 128 --buckets 1,4,16,64
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve_caps --model mnist@cuda --mesh host

Builds the model lazily in the registry (init -> PTQ on a synthetic
calibration set, on the device), warms the wave functions so the
kernels' build and the device's set-up stay out of the latency numbers,
submits --requests synthetic images through the bucketed micro-batch
scheduler, and prints the serving metrics.  With --compare-b1 it
replays the same requests through a batch-size-1 loop.  Runs on CUDA
unless --device says otherwise (`--device cpu` serves the `torch`
backend's models on the CPU).  --mesh host runs the waves under a
data-parallel mesh in the reference's ("pod", "model", "data") layout.
Alone it is a mesh of the one device, whose waves are those of --mesh
none (more than one visible card raises: launch under torchrun).  Under
`torchrun --nproc-per-node N` it is a mesh over the N ranks of a
`torch.distributed` world (`dist.world.init_world`; NCCL when every rank
owns a card, gloo when they share one): every rank submits the same
seeded request stream and drains the same waves, each wave's rows split
over the ranks and gathered back, and only rank 0 prints the report and
writes --trace / --metrics-out / --numerics-out / --export.  Either way
the completions are bit-identical to --mesh none; the last line of the
report is their digest.

With --capsbin PATH the engine serves an exported MCU artifact
instead: the `.capsbin` is imported back into a QuantCapsNet on the
device (repro_torch.edge importer; the `cuda` backend on the card, the
`torch` oracle with `--device cpu`) and installed under its program
name, so the bits in flight are exactly the bits that shipped.  The
static verifier (repro_torch.analysis) vets it first; a finding prints
STATIC CHECK FAILED and exits 1, and --no-check skips it.  --export DIR
also dumps the served model as an artifact (.capsbin + manifest +
.c/.h) and prints its flash/RAM report.

--softmax/--squash select operator variants from the registry
(repro_torch.nn.variants; e.g. the ISLPED'22 approximate softmax/squash):
on a spec by rebuilding it, on a --capsbin artifact as a pure plan edit.
On a `*@cuda` model a non-default variant runs the torch oracle on the
card (bit-identical, slower), and the run prints the fallbacks.  Unknown
names fail argparse with the registered ones listed.

Observability (repro_torch.obs): --profile prints the static MCU
latency estimate of the served model; --trace PATH records spans for
the whole run (PTQ, wave binding, enqueue -> execute) as Chrome
trace-event JSON and --trace-summary prints the analyzer's report of
them; --metrics-out PATH writes the run's metrics snapshots
(`repro.metrics/v1`); --numerics-out PATH runs a probed EdgeVM pass of
the served model (with per-layer q7-vs-f32 SNR rows on a spec id, whose
float weights are rebuilt from the spec's seed) and writes the
`repro.numerics/v1` doc.  `python -m repro_torch.obs.analyze` reads all
three back.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis import CheckError
from repro_torch.dist import world as dworld
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.nn.backend import get_backend
from repro_torch.nn.variants import REGISTRY
from repro_torch.serving import ModelRegistry, default_specs, serve_window


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mnist@cuda",
                    help=f"registry id ({', '.join(sorted(default_specs()))})"
                    "; ignored when --capsbin is given")
    ap.add_argument("--capsbin", metavar="PATH", default=None,
                    help="serve an exported .capsbin artifact (imported "
                    "via repro_torch.edge onto the device, installed "
                    "under its program name)")
    ap.add_argument("--softmax", choices=REGISTRY.names("softmax"),
                    default=None,
                    help="softmax operator variant (repro_torch.nn."
                    "variants); default: the spec's / artifact's own")
    ap.add_argument("--squash", choices=REGISTRY.names("squash"),
                    default=None,
                    help="squash operator variant; default: the spec's "
                    "/ artifact's own")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--buckets", default="1,4,16,64",
                    help="comma-separated micro-batch bucket sizes")
    ap.add_argument("--mesh", choices=("none", "host"), default="none",
                    help="host: run waves under a data-parallel mesh: of "
                    "the one device, or under torchrun of the world's "
                    "ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-b1", action="store_true",
                    help="also serve via a batch-size-1 loop and report "
                    "the batched speedup")
    ap.add_argument("--export", metavar="DIR", default=None,
                    help="also dump the served model as an MCU artifact "
                    "(.capsbin + manifest + .c/.h via repro_torch.edge) "
                    "and print the flash/RAM report")
    ap.add_argument("--check", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="statically verify imported --capsbin artifacts "
                    "and --export programs (repro_torch.analysis)")
    ap.add_argument("--profile", action="store_true",
                    help="print the static MCU cycle/latency estimate of "
                    "the served model (repro_torch.edge.costmodel, both "
                    "calibrated profiles)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record spans for the whole run (PTQ, wave "
                    "binding, enqueue->execute) and write Chrome "
                    "trace-event JSON to PATH (chrome://tracing / "
                    "Perfetto)")
    ap.add_argument("--trace-summary", action="store_true",
                    help="print the trace analyzer's report of this run "
                    "(repro_torch.obs.analyze: span stats, wave critical "
                    "paths, per-request timelines); records spans even "
                    "without --trace")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="write the run's final metrics snapshots as JSON "
                    "(schema repro.metrics/v1: process + run registries + "
                    "the serve window summary); repro_torch.obs.analyze "
                    "reads it via --metrics")
    ap.add_argument("--numerics-out", metavar="PATH", default=None,
                    help="after serving, run a probed numeric-health pass "
                    "of the served model (repro_torch.obs.numerics: "
                    "saturation, int32 clips, bound tightness, SNR) and "
                    "write the repro.numerics/v1 JSON doc to PATH")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    # under torchrun, --mesh host joins the world of its ranks
    started = args.mesh == "host" and dworld.current_world() is None \
        and "WORLD_SIZE" in os.environ
    world = dworld.init_world(device=args.device) if started \
        else dworld.current_world()
    tracer = None
    if args.trace or args.trace_summary:
        tracer = obs.Tracer()
        obs.set_tracer(tracer)
    lead = world is None or args.mesh != "host" or world.rank == 0
    try:
        # ranks past the first serve in silence and write nothing
        with contextlib.nullcontext() if lead else \
                contextlib.redirect_stdout(io.StringIO()):
            return _serve(args, ap, tracer, lead)
    finally:
        if tracer is not None:
            obs.set_tracer(None)
        if started:
            dworld.shutdown()


def _serve(args, ap, tracer, lead: bool = True) -> int:
    # one run-scoped registry sees the model registry's counters and the
    # serve window's ServeMetrics mirror; METRICS (process) keeps the
    # singletons' counters (the cuda backend's fallbacks)
    run_metrics = obs.MetricsRegistry("serve_caps") \
        if args.metrics_out else None
    # serving waves shard over BATCH=("pod","data"): give "data" the
    # devices (make_host_mesh fills the LAST axis), as the reference does
    mesh = make_host_mesh(("pod", "model", "data"), device=args.device) \
        if args.mesh == "host" else None
    registry = ModelRegistry(device=args.device, metrics=run_metrics,
                             mesh=mesh)
    mesh_tag = "none" if mesh is None else mesh.tag()
    buckets = tuple(int(b) for b in args.buckets.split(","))
    if args.capsbin:
        try:
            qnet = registry.install_artifact(args.capsbin,
                                             check=args.check)
        except CheckError as e:      # refuse to serve a bad artifact
            print(f"[serve_caps] STATIC CHECK FAILED for "
                  f"{args.capsbin}:\n{e}", file=sys.stderr)
            return 1
        model_id = qnet.pipeline.cfg.name        # the program's name
        if args.softmax or args.squash:          # plan edit on the artifact
            vs = dataclasses.replace(
                qnet.variants,
                **{k: v for k, v in (("softmax", args.softmax),
                                     ("squash", args.squash)) if v})
            qnet = qnet.with_variants(vs)
            registry.install(model_id, qnet)
        rng = np.random.default_rng(args.seed)
        images = rng.uniform(0, 1, (args.requests,)
                             + registry.input_shape(model_id)) \
            .astype(np.float32)
        print(f"[serve_caps] imported {args.capsbin} as {model_id!r} "
              f"({qnet.memory_bytes() / 1000:.1f} KB int8, "
              f"backend={qnet.backend}) variants={qnet.variants.tag} "
              f"buckets={buckets} mesh={mesh_tag} "
              f"device={registry.device}")
    else:
        model_id = args.model
        if model_id not in registry.specs:
            ap.error(f"unknown model {model_id!r}; have "
                     f"{sorted(registry.specs)} (or pass --capsbin)")
        spec = registry.specs[model_id]
        if args.softmax or args.squash:
            spec = dataclasses.replace(
                spec,
                **{f"{k}_impl": v for k, v in (("softmax", args.softmax),
                                               ("squash", args.squash))
                   if v})
            registry.register(spec)
        images = spec.images(args.requests, args.seed)
        print(f"[serve_caps] model={model_id} ({spec.config.name}, "
              f"backend={spec.backend}, variants={spec.variants.tag}) "
              f"buckets={buckets} mesh={mesh_tag} "
              f"device={registry.device}")
        t0 = time.perf_counter()
        qnet = registry.model(model_id)
        print(f"[serve_caps] lazy PTQ build: "
              f"{time.perf_counter() - t0:.2f} s "
              f"({qnet.memory_bytes() / 1000:.1f} KB int8)")
    if args.export and lead:
        from repro_torch.edge import format_export
        result = registry.export(model_id, args.export, check=args.check)
        print("[serve_caps] exported MCU artifact:")
        print(format_export(result))
    if args.profile:
        from repro_torch.edge import format_estimates, lower
        print("[serve_caps] static MCU latency estimate:")
        print(format_estimates(lower(registry.model(model_id))))

    engine, done, wall = serve_window(registry, buckets, images, model_id,
                                   metrics_registry=run_metrics)
    print("[serve_caps]", engine.metrics.report())
    print(f"[serve_caps] wave functions bound: {registry.compile_count}, "
          f"cache hits: {registry.exec_hits}")
    print(f"[serve_caps] completions: {len(done)}, sha256 "
          f"{completions_digest(done)}")
    if registry.variant_fallbacks:
        print(f"[serve_caps] cuda->torch variant fallbacks: "
              f"{registry.variant_fallbacks} (decisions by (op, variant): "
              f"{dict(get_backend('cuda').fallbacks)})")
    if args.compare_b1:
        b1_engine, _, b1_wall = serve_window(registry, (1,), images,
                                             model_id)
        print("[serve_caps] b1  :", b1_engine.metrics.report())
        print(f"[serve_caps] batched speedup over b1 loop: "
              f"{b1_wall / max(wall, 1e-9):.2f}x")
    if args.numerics_out and lead:
        from repro_torch.obs import numerics as health
        qnet = registry.model(model_id)
        params = None
        if not args.capsbin:             # spec path: rebuild the float
            params = qnet.pipeline.init(  # oracle weights for SNR rows
                torch.Generator().manual_seed(spec.seed), registry.device)
        report = health.run_numerics(qnet, images[:16], params=params,
                                     metrics=run_metrics)
        _write_json(args.numerics_out, report.to_doc())
        print(f"[serve_caps] numerics: int32 clips "
              f"{report.total_int32_clip()}, worst saturation "
              f"{report.worst_saturation_rate() * 100:.2f}%, "
              f"wrote {args.numerics_out}")
    if args.metrics_out and lead:
        _write_json(args.metrics_out, {
            "schema": "repro.metrics/v1",
            "process": obs.METRICS.snapshot(),
            "run": run_metrics.snapshot(),
            "serve_summary": engine.metrics.summary()})
        print(f"[serve_caps] wrote metrics snapshot to {args.metrics_out}")
    if tracer is not None and lead:
        if args.trace:
            tracer.write_chrome_trace(args.trace)
            print(f"[serve_caps] wrote {tracer.span_count()} spans to "
                  f"{args.trace} (chrome://tracing)")
        if args.trace_summary:
            from repro_torch.obs import analyze
            print("[serve_caps] trace summary:")
            print(analyze.format_analysis(analyze.analyze(tracer)))
    return 0


def completions_digest(done) -> str:
    """The first 16 hex digits of a sha256 over every completion's rid,
    pred, v_q and lengths, in rid order: equal digests, equal bits."""
    h = hashlib.sha256()
    for c in sorted(done, key=lambda c: c.rid):
        h.update(f"{c.rid}:{c.pred}:".encode())
        h.update(c.v_q.tobytes())
        h.update(c.lengths.tobytes())
    return h.hexdigest()[:16]


def _write_json(path, doc) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1, sort_keys=True))


if __name__ == "__main__":
    raise SystemExit(main())
