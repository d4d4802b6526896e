#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the nvcc build of every kernel in src/repro_torch/kernels/csrc;
2. every kernel against its plain torch version on the card, bit for bit:
   squash_q7 on [64*1024, 4] for in_frac 0..12 plus the device isqrt over
   its whole squash range, routing_q7 on [64, 10, 1024, 6] with MNIST-like
   shifts and on a sweep of shift tables over [-31, 31], both roundings;
3. the main path: `ModelRegistry` builds `mnist@cuda` by lazy PTQ on the
   card (its calibration stats held within rtol 1e-4 of the same params'
   CPU stats), serves 128 requests in one burst and 128 more in groups
   that fill buckets 1/4/16/64, and every completion must equal the same
   QuantCapsNet on the `torch` backend, on the card and on the CPU; both
   kernels' launch counts over that run must be > 0; then the command
   `serve_caps --model mnist@cuda --requests 128` runs, with its own
   counts, which must be > 0 too;
4. times at the main path's shapes (B = 64): each kernel, its plain
   version and its bound; the per-layer split of one wave; serving
   img/s and p50/p99.

The line before the last is the kernels' JSON record, the one before it
the card's name and power limit; the last line is the result.  Exits
non-zero, printing no result, without a CUDA device or without the
repository's `src/`.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15          # H100 SXM dense int8 tensor-core rate
SEED = 0
N_REQUESTS = 128
BUCKETS = (1, 4, 16, 64)
B_TIMED = 64


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_diff(a, b) -> int:
    import torch
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def require_equal(what: str, got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = max_abs_diff(got.cpu(), want.cpu())
    if err != 0:
        raise AssertionError(f"{what}: max |kernel - plain| = {err}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.quant import int8_ops as q
    g = torch.Generator().manual_seed(SEED)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g,
                             dtype=torch.int8)

    err = {"squash_q7": 0, "routing_q7": 0}
    s = i8((64 * 1024, 4))
    s_dev = s.to(dev)
    for in_frac in range(13):
        got = ks.squash_q7(s_dev, in_frac=in_frac)
        err["squash_q7"] = max(err["squash_q7"], require_equal(
            f"squash_q7 in_frac={in_frac} vs plain on card", got,
            ks.squash_q7_plain(s_dev, in_frac=in_frac)))
        require_equal(f"squash_q7 in_frac={in_frac} vs plain on cpu", got,
                      ks.squash_q7_plain(s, in_frac=in_frac))
    for D in (1, 6, 16):
        s16 = i8((4096, D))
        got = ks.squash_q7(s16.to(dev), in_frac=5, out_frac=6)
        require_equal(f"squash_q7 D={D}", got,
                      ks.squash_q7_plain(s16, in_frac=5, out_frac=6))
    n = torch.arange(0, 16 * 128 * 128 + 1, dtype=torch.int32)
    require_equal("isqrt_newton over [0, 16*128^2]",
                  ks.isqrt_newton(n.to(dev)), q.isqrt_newton(n))
    log(f"[kernels] squash_q7 bit-exact for in_frac 0..12 on "
        f"{tuple(s.shape)}, D 1/6/16; device isqrt exact on "
        f"[0, {16 * 128 * 128}]")

    mnist_like = dict(num_iters=3, caps_out_shifts=(8, 8, 9),
                      caps_out_fracs=(7, 7, 6), agree_shifts=(8, 8),
                      logit_frac=7)
    u = i8((64, 10, 1024, 6))
    u_dev = u.to(dev)
    for rounding in ("floor", "nearest"):
        got = kr.routing_q7(u_dev, rounding=rounding, **mnist_like)
        err["routing_q7"] = max(err["routing_q7"], require_equal(
            f"routing_q7 {rounding} vs plain on card", got,
            kr.routing_q7_plain(u_dev, rounding=rounding, **mnist_like)))
        require_equal(f"routing_q7 {rounding} vs plain on cpu", got,
                      kr.routing_q7_plain(u, rounding=rounding,
                                          **mnist_like))
    # the shift domain the static checker allows, plus other geometries
    sweep = 0
    for (B, J, I, O) in ((8, 10, 1024, 6), (4, 5, 1600, 6), (4, 10, 64, 5),
                         (4, 4, 16, 4), (3, 7, 33, 16)):
        u = i8((B, J, I, O))
        for k in range(4):
            r = 1 + k % 4
            kw = dict(num_iters=r,
                      caps_out_shifts=tuple(torch.randint(
                          -31, 32, (r,), generator=g).tolist()),
                      caps_out_fracs=tuple(torch.randint(
                          0, 13, (r,), generator=g).tolist()),
                      agree_shifts=tuple(torch.randint(
                          -31, 32, (max(r - 1, 0),), generator=g).tolist()),
                      logit_frac=int(torch.randint(-3, 8, (1,),
                                                   generator=g)))
            for rounding in ("floor", "nearest"):
                require_equal(f"routing_q7 sweep {(B, J, I, O)} {kw} "
                              f"{rounding}",
                              kr.routing_q7(u.to(dev), rounding=rounding,
                                            **kw),
                              kr.routing_q7_plain(u, rounding=rounding,
                                                  **kw))
                sweep += 1
    log(f"[kernels] routing_q7 bit-exact on [64,10,1024,6] both roundings "
        f"and on {sweep} random shift tables over [-31, 31]")
    return err


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def check_calibration(spec, dev):
    """The spec's params calibrated on the card and on the CPU."""
    import torch
    from repro_torch.nn.pipeline import CapsPipeline
    pipe = CapsPipeline.from_config(spec.config, variants=spec.variants)
    calib = spec.images(spec.calib_n, spec.seed + 1)
    stats = {}
    plans = {}
    for d in (dev, "cpu"):
        params = pipe.init(torch.Generator().manual_seed(spec.seed), d)
        stats[str(d)] = pipe.calibrate(params, calib)
        plans[str(d)] = pipe.plan(params, stats[str(d)])
    worst = 0.0
    for k, v in stats["cpu"].max_abs.items():
        rel = abs(stats[str(dev)][k] - v) / max(abs(v), 1e-30)
        worst = max(worst, rel)
        if rel > 1e-4:
            raise AssertionError(f"calibration tap {k}: card "
                                 f"{stats[str(dev)][k]} vs cpu {v}")
    same = plans[str(dev)] == plans["cpu"]
    log(f"[main] calibration stats card vs cpu: max rel diff {worst:.3g} "
        f"(limit 1e-4); plans equal: {same}")
    return plans[str(dev)]


def serve_main_path(dev, mid: str = "mnist@cuda"):
    """Drive `mid` through the registry and engine; returns what the
    checks and timings need."""
    from repro_torch.serving import (CapsServeEngine, ModelRegistry,
                                     serve_window)
    reg = ModelRegistry(device=dev)
    spec = reg.specs[mid]
    images = spec.images(2 * N_REQUESTS, SEED)
    t0 = time.perf_counter()
    qnet = reg.model(mid)
    ptq_s = time.perf_counter() - t0
    engine, done, wall = serve_window(reg, BUCKETS, images[:N_REQUESTS], mid)

    # arrivals in groups, so every bucket serves real and padded rows
    grouped_engine = CapsServeEngine(reg, buckets=BUCKETS)
    start, grouped = N_REQUESTS, []
    for n in (1, 3, 4, 13, 16, 40, 51):
        grouped_engine.submit_many(images[start:start + n], mid)
        grouped.extend(grouped_engine.drain())
        start += n
    buckets_used = sorted({c.bucket for c in grouped})
    if buckets_used != list(BUCKETS):
        raise AssertionError(f"grouped arrivals used buckets {buckets_used}")
    completions = done + [dataclasses.replace(c, rid=c.rid + N_REQUESTS)
                          for c in grouped]
    return dict(spec=spec, qnet=qnet, images=images, ptq_s=ptq_s,
                engine=engine, wall=wall, completions=completions)


def check_completions(run) -> None:
    import numpy as np
    import torch
    qnet, images = run["qnet"], run["images"]
    x = torch.as_tensor(images)
    oracles = {"torch backend on card": qnet.with_backend("torch")}
    cpu_w = {k: {n: t.cpu() for n, t in w.items()}
             for k, w in qnet.qweights.items()}
    oracles["torch backend on cpu"] = dataclasses.replace(
        qnet, qweights=cpu_w, backend="torch")
    comps = sorted(run["completions"], key=lambda c: c.rid)
    got_v = np.stack([c.v_q for c in comps])
    got_pred = np.array([c.pred for c in comps])
    for what, ref in oracles.items():
        with torch.inference_mode():
            xd = x.to(ref.device)
            v = ref.forward(ref.quantize_input(xd))
            lengths = ref.class_lengths(v)
            pred = torch.argmax(lengths, dim=-1)
        if not np.array_equal(got_v, v.cpu().numpy()):
            bad = int((got_v != v.cpu().numpy()).any(axis=(1, 2)).sum())
            raise AssertionError(f"served v_q differs from the {what} on "
                                 f"{bad} of {len(comps)} requests")
        if not np.array_equal(got_pred, pred.cpu().numpy()):
            raise AssertionError(f"served pred differs from the {what}")
    v = got_v.astype(np.int32)
    if v.shape != (2 * N_REQUESTS, 10, 6) or not np.all(np.abs(v) <= 128):
        raise AssertionError(f"served v_q of shape {v.shape}")
    log(f"[main] {len(comps)} served completions bit-exact against the "
        f"torch backend on the card and on the CPU; pred classes "
        f"{np.bincount(got_pred, minlength=10).tolist()}")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def time_kernels(run, dev) -> dict:
    import torch
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.nn.backend import get_backend
    qnet = run["qnet"]
    plan = qnet.plan
    tb = get_backend("torch")
    x = torch.as_tensor(run["images"][:B_TIMED]).to(dev)
    with torch.inference_mode():
        xq = qnet.quantize_input(x)
        pipe = qnet.pipeline
        h = pipe.layers[0].fwd_q7(qnet.qweights["conv0"], plan["conv0"], xq)
        pcap = pipe.layer("pcap")
        y = pcap.conv.fwd_q7(qnet.qweights["pcap"], plan["pcap"].conv, h)
        s = y.reshape(y.shape[0], -1, pcap.dim)
        in_frac = plan["pcap"].conv.out_frac
        u = ks.squash_q7(s, in_frac=in_frac)
        rp = plan["caps"]
        u_hat = tb.uhat_q7(qnet.qweights["caps"]["W"], u,
                           shift=rp.uhat_shift, rounding=qnet.rounding)
    rkw = dict(num_iters=rp.routings, caps_out_shifts=rp.caps_out_shifts,
               caps_out_fracs=rp.caps_out_fracs,
               agree_shifts=rp.agree_shifts, logit_frac=rp.logit_frac,
               rounding=qnet.rounding)
    R, D = s.numel() // s.shape[-1], s.shape[-1]
    B, J, I, O = u_hat.shape
    r = rp.routings
    work = {
        # bytes: input read once, output written once; ops: the int8
        # multiply-adds (2 ops each) the function needs; the squash's
        # Newton divisions have no entry in the data sheet's rate table
        "squash_q7": dict(bytes=2 * R * D, ops=2 * 2 * R * D,
                          fn=lambda: ks.squash_q7(s, in_frac=in_frac),
                          plain=lambda: ks.squash_q7_plain(
                              s, in_frac=in_frac)),
        "routing_q7": dict(bytes=B * J * I * O + B * J * O,
                           ops=2 * (2 * r - 1) * B * J * I * O,
                           fn=lambda: kr.routing_q7(u_hat, **rkw),
                           plain=lambda: kr.routing_q7_plain(u_hat, **rkw)),
    }
    out = {}
    with torch.inference_mode():
        for name, w in work.items():
            bytes_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
            ops_ms = w["ops"] / INT8_OPS_PER_S * 1e3
            out[name] = dict(
                ms=cuda_ms(w["fn"]), plain_ms=cuda_ms(w["plain"], iters=10),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                shape=list(s.shape) if name == "squash_q7"
                else list(u_hat.shape))

        # where one B=64 wave's device time goes, layer by layer
        conv0 = pipe.layers[0]
        split = {
            "quantize_input": lambda: qnet.quantize_input(x),
            "conv0 (int8 conv + relu)": lambda: conv0.fwd_q7(
                qnet.qweights["conv0"], plan["conv0"], xq),
            "pcap conv (int8)": lambda: pcap.conv.fwd_q7(
                qnet.qweights["pcap"], plan["pcap"].conv, h),
            "squash_q7 kernel": work["squash_q7"]["fn"],
            "u_hat (float64 einsum)": lambda: tb.uhat_q7(
                qnet.qweights["caps"]["W"], u, shift=rp.uhat_shift,
                rounding=qnet.rounding),
            "routing_q7 kernel": work["routing_q7"]["fn"],
            "whole forward_q7": lambda: qnet.forward(xq),
        }
        for what, fn in split.items():
            log(f"[time] B={B_TIMED} {what}: {cuda_ms(fn, iters=20):.4f} ms")
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not next to this script "
              f"({ROOT / 'src' / 'repro_torch'})", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel libraries in {build_s:.1f} s "
        f"({', '.join(sorted(libs))})")
    for name, entry in sorted(build.BUILD_LOG.items()):
        for line in entry["ptxas"].splitlines():
            if "registers" in line or "smem" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")

    # phase 2
    errs = check_kernels(dev)

    # phase 3: counts from 0 just before the main path, read just after
    ks.squash_q7.launches = 0
    kr.routing_q7.launches = 0
    run = serve_main_path(dev)
    launches = {"squash_q7": ks.squash_q7.launches,
                "routing_q7": kr.routing_q7.launches}
    log(f"[main] mnist@cuda lazy PTQ on the card {run['ptq_s']:.2f} s; "
        f"launches over the main path: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    plan_card = check_calibration(run["spec"], dev)
    log(f"[main] registry plan equals the card calibration's plan: "
        f"{plan_card == run['qnet'].plan}")
    check_completions(run)

    # the command a user runs, counted on its own
    from repro_torch.launch import serve_caps
    ks.squash_q7.launches = 0
    kr.routing_q7.launches = 0
    rc = serve_caps.main(["--model", "mnist@cuda",
                          "--requests", str(N_REQUESTS)])
    cli = {"squash_q7": ks.squash_q7.launches,
           "routing_q7": kr.routing_q7.launches}
    if rc != 0 or min(cli.values()) == 0:
        raise AssertionError(f"serve_caps --model mnist@cuda: exit {rc}, "
                             f"launches {cli}")
    log(f"[main] serve_caps --model mnist@cuda --requests {N_REQUESTS}: "
        f"launches {cli}")

    # phase 4
    times = time_kernels(run, dev)
    m = run["engine"].metrics.summary()
    log(f"[serve] {card} | {N_REQUESTS} requests, buckets {BUCKETS}: "
        f"{m['images_per_s']:.1f} img/s, p50 {m['p50_ms']:.3f} ms, "
        f"p99 {m['p99_ms']:.3f} ms, {m['waves']} waves")
    for name, t in times.items():
        log(f"[time] {card} | {name} {t['shape']}: kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}); no single PyTorch call computes it, so "
            f"library_ms is null")

    sources = {"squash_q7": ("src/repro_torch/kernels/csrc/squash_q7.cu",
                             "src/repro/kernels/squash.py:50"),
               "routing_q7": ("src/repro_torch/kernels/csrc/routing_q7.cu",
                              "src/repro/kernels/routing.py:90")}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": None}
        for name in ("squash_q7", "routing_q7")]}
    log("kernels: " + ", ".join(f"{k['name']} x{k['launches']}"
                                for k in record["kernels"]))
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
