#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --device-times   # phase 1 and phase 8's times
    python3 chip_smoke.py --forward-pairs PARENT_TREE

(`--device-times` runs on an older tree too: copy this script into a
`git archive` of it to time its kernels in the same call.
`--forward-pairs` copies this script into PARENT_TREE, an unpacked
`git archive` of another commit, starts two `--forward-worker`
processes in each tree, and times the untraced B=64 forward_q7 of all
four in 40 rounds of 50 calls each, printing each side's median and the
median per-round difference beside its quartiles and beside the
difference between the two workers of one side.)

Phases, each raising on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the nvcc build of every kernel in src/repro_torch/kernels/csrc;
2. every kernel against its plain torch version on the card, bit for bit:
   squash_q7 on [64*1024, 4] for in_frac 0..12; the device isqrt against
   int8_ops.isqrt_newton on every n in [0, 2^31 - 1] and on negative n;
   routing_q7 on [64, 10, 1024, 6] with MNIST-like shifts, on
   [B, 10, 1024, 6] for every bucket B at the wrapper's cluster size and
   at every size a caller may force, and on a sweep of 40 shift tables
   over [-31, 31] at the wrapper's cluster size and at a forced one (most
   not dividing I), both roundings; squash_q7 at D up to 32 and routing_q7
   at capsule dims 18, 20 and 32 and at 9 and 16 iterations, every
   cluster size, u_hat staged in shared memory and read from global
   memory, and on [2, 10, 40000, 6], whose slices no CTA can stage;
3. the main path: `ModelRegistry` builds `mnist@cuda` by lazy PTQ on the
   card (its calibration stats held within rtol 1e-4 of the same params'
   CPU stats), serves 128 requests in one burst and 128 more in groups
   that fill buckets 1/4/16/64, and every completion must equal the same
   QuantCapsNet on the `torch` backend, on the card and on the CPU; both
   kernels' launch counts over that run must be > 0; then the command
   `serve_caps --model mnist@cuda --requests 128` runs, with its own
   counts, which must be > 0 too;
4. the artifact path: `ModelRegistry.export("mnist@cuda", build/edge_smoke)`
   writes the `.capsbin`, its manifest and the `.c`/`.h` (VM-verified on
   4 images); the reloaded file `same_as` the lowered program, and
   `lower(to_qnet(p))` `same_as` p; `install_artifact` puts it on the
   card and it serves the burst's 128 requests on the `cuda` backend,
   its kernel counts from 0: every completion must equal the live
   model's, the first 16 the port's EdgeVM on the CPU, both kernels'
   counts must be > 0 and `CudaBackend.fallbacks` must not move; then
   `serve_caps --capsbin PATH --requests 128` must exit 0, and on a
   copy with conv0's out_shift at 45 (outside [-31, 31]) exit 1;
5. the other configs and the variant fallback: 16 requests each of
   `smallnorb@cuda` and `cifar10@cuda`, and of `edge_tiny@cuda`
   re-registered with the "approx" softmax, every completion equal to
   the `torch` backend; `CudaBackend.fallbacks` must count the approx
   run under `routing.softmax` and stay 0 over the default-variant
   `mnist@cuda` runs of phases 3 and 4;
6. the kernel library, `repro_torch.kernels.ops`, on the card, its
   launch counts from 0: `matmul_q7` and `w8a8_matmul` bit for bit
   against their plain versions at the shapes of
   benchmarks/bench_matmul.py, the MNIST primary-caps im2col product at
   B=64, 4096^3, two ragged shapes, a K = 140,000 product whose int32
   accumulator wraps and a K = 265,296 one whose running sum wraps and
   comes back (both also on one wgmma block per tile, so that the
   wrap happens inside the accumulators), both roundings (scalar shifts
   over [-40, 40] at one small shape, random column shifts over
   [-40, 40]); a `[library]` line names the route, tile and split
   `gemm_plan` picks for each shape, the wgmma route is required for
   4096^3, (4096, 784, 64) and both wrap shapes, and every call must
   count one launch on that route (`launches_by_route`); A one byte
   past a 16-byte boundary must take the mma.sync route, 16 bytes past
   the wgmma one, and a[:, 1:] is checked too; `bmm_q7` on
   [8, 256, 256] x [8, 256, 256]; `squash_float` at every
   SQUASH_FLOAT_SHAPES entry ([65536, 4] f32 and bf16, [65536, 8] f16,
   [64, 6] f32, [16777216, 4] f32 and bf16, [1048576, 16] f32) and on
   s[:, 1:] of a [65536, 5] f32 tensor (the element path), each call
   exactly one launch, within rtol/atol 1e-6 in float32 and one ulp in
   bfloat16/float16 (the 16.7 M-row shapes on their first 4096 rows);
   every launch count must be > 0, and both GEMM routes must have been
   taken;
7. times at the main path's shapes (B = 64): each kernel, its plain
   version and its bound; the per-layer split of one wave; serving
   img/s and p50/p99 of `mnist@cuda` and of its installed artifact over
   4 alternating windows each (the first the counted ones); and
   each library kernel at each shape of phase 6, beside its plain
   version, its bound and, as a yardstick only, `torch._int_mm`
   (cuBLASLt's int8 product without the epilogue, never called by the
   port);
8. device times from a torch.profiler trace (`device_ms`): routing_q7
   at [B, 10, 1024, 6] and squash_q7 at [B*1024, 4] for every bucket B,
   routing_q7 at every cluster size, matmul_q7 and w8a8_matmul at every
   phase-6 shape and bmm_q7 at its shape, each the sum over every kernel
   the call launches (transpose, product, split-K reduction), beside
   torch._int_mm's device time at the same shapes; squash_float at every
   phase-6 shape, summed the same way, beside its bound and the device
   time of an empty kernel (the launch floor);
9. (run between phases 7 and 8, since a torch.profiler session slows
   the later launches of its process) observability (repro_torch.obs):
   phase 3's request stream of
   `mnist@cuda` again through one engine under a tracer and a numerics
   probe, every completion equal to phase 3's, one `serve.wave` span per
   wave with `serve.bucket`, `serve.compile`, `serve.execute` and
   `serve.complete` under it, one `serve.enqueue` per request, every
   request's timeline rebuilt by `obs.analyze`, 0 int32 clips, and the
   wave breakdown (queue, compile, execute ms per bucket) printed;
   `serve_caps --model mnist@cuda --trace --trace-summary --metrics-out
   --numerics-out --profile` into build/obs_smoke/ with kernel launches
   > 0, its trace, metrics and numerics doc read back by
   `python -m repro_torch.obs.analyze` (`--gate-clips`), the doc holding
   0 int32 clips and contained in the static bounds; `export_caps
   --model mnist@cuda --numerics --drift` exits 0 and `costmodel_drift`
   joins every op; 16 requests each of `edge_tiny@cuda` with
   pcap_dim=18, caps_dim=20 and routings=9 (past the kernels' former
   limits of capsule dim 16 and 8 iterations) bit-identical to the
   `torch` backend, both kernels launched for each and no fallback
   counted; the untraced, unprobed B=64 forward_q7 (7 x 50 calls)
   beside a probed one, and untraced beside traced serving img/s in
   turns; and the card's busy share of an untraced 128-request window
   over 5 pairs of windows, one unprofiled and one under torch.profiler:
   the union of the profiled window's CUDA kernel intervals over the
   paired unprofiled window's wall and over its own.

The line before the last is the kernels' JSON record, the one before it
the card's name and power limit; the last line is the result.  Exits
non-zero, printing no result, without a CUDA device or without the
repository's `src/`.
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15          # H100 SXM dense int8 tensor-core rate
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
# int32 multiply-adds on the CUDA cores (2 ops each): an SM has 64 int32
# lanes against 128 float32 lanes, so half the float32 rate
INT32_OPS_PER_S = F32_OPS_PER_S / 2
SEED = 0
N_REQUESTS = 128
N_OTHER = 16                       # requests of each phase-5 model
SERVE_ROUNDS = 4                   # alternating serving windows timed
BUCKETS = (1, 4, 16, 64)
B_TIMED = 64
ROUNDINGS = ("floor", "nearest")
# (M, K, N): bench_matmul.py's three, the MNIST primary-caps im2col
# product at B=64 (64*8*8 patches of 7*7*16 against 16*4 filters),
# 4096^3, two ragged shapes, a product whose int32 sum wraps, and one
# whose running int32 sum wraps and comes back
GEMM_SHAPES = ((20, 30, 40), (128, 128, 128), (256, 256, 256),
               (4096, 784, 64), (4096, 4096, 4096), (7, 257, 130),
               (1, 5, 3), (4, 140_000, 8), (8, 265_296, 16))
WRAP_SHAPE = (4, 140_000, 8)
WRAP_RETURN_SHAPE = (8, 265_296, 16)
# shapes whose plan must be the wgmma route
WGMMA_SHAPES = ((4096, 4096, 4096), (4096, 784, 64), WRAP_SHAPE,
                WRAP_RETURN_SHAPE)
HEADLINE_GEMM = (4096, 4096, 4096)         # the JSON record's GEMM shape
BMM_SHAPE = (8, 256, 256, 256)             # (batch, M, K, N)
# (shape, dtype): the headline [65536, 4] at the launch floor, the [64, 6]
# element path, 16-byte words of one and two rows, and three shapes where
# bytes dominate: [16777216, 4] f32 / bf16 (512 / 256 MiB) and
# [1048576, 16] f32 (four lanes a row)
SQUASH_FLOAT_SHAPES = (((64 * 1024, 4), "float32"), ((64, 6), "float32"),
                       ((64 * 1024, 4), "bfloat16"),
                       ((64 * 1024, 8), "float16"),
                       ((16 * 1024 * 1024, 4), "float32"),
                       ((16 * 1024 * 1024, 4), "bfloat16"),
                       ((1024 * 1024, 16), "float32"))
# s[:, 1:] of this shape: rows 20 bytes apart, 4 bytes past alignment
SQUASH_FLOAT_VIEW = ((64 * 1024, 5), "float32")
# rows of the 16.7 M-row shapes held against the plain version (the
# whole call is timed; its first rows are checked)
SQUASH_FLOAT_CHECK_ROWS = 4096
EDGE_DIR = ROOT / "build" / "edge_smoke"
OBS_DIR = ROOT / "build" / "obs_smoke"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean wall time of one fn() call over `iters` back-to-back calls,
    between CUDA events: below ~0.03 ms this is the host's time to make
    the call, not the kernel's (see `device_ms`)."""
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


def device_ms(fn, kernel: str | None, calls: int = 50, warmup: int = 5,
              parts: dict | None = None) -> float:
    """Device time of one fn() call from a torch.profiler trace (CUDA
    activity) of `calls` calls: with `kernel` a name, the mean launch of
    the kernels whose name holds it (other kernels of the call, casts
    and copies, are left out); with None, the sum over EVERY kernel the
    call launches (a wgmma GEMM call runs a transpose, the product and a
    split-K reduction) of its mean launch times its launches per call,
    each kernel's share written into `parts` when given.  The trace may
    drop records (4 of 20 launches of the 4096^3 GEMM, 1 of 50 of the
    squash, once every record of a trace were seen): a trace that holds
    fewer than half of some kernel's launches, or none at all, is taken
    again, at most three times, and then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got, short = {}, []
        for e in prof.key_averages():
            if e.device_time_total <= 0 or (kernel is not None
                                            and kernel not in e.key):
                continue
            per_call = max(1, round(e.count / calls))
            if not calls // 2 * per_call <= e.count <= calls * per_call:
                short.append(f"{e.count} launches of {e.key[:60]!r}")
            got[e.key] = e.device_time_total / e.count * per_call / 1e3
        if got and not short:
            if parts is not None:
                parts.update(got)
            return sum(got.values())
        log(f"[device] profiler trace {attempt + 1} of {kernel!r} for "
            f"{calls} calls is short ({short or 'no kernel'}): taken again")
    seen = [e.key[:60] for e in prof.key_averages()]
    raise AssertionError(f"profiler traces of {kernel!r} stay short: "
                         f"{short or seen}")


MNIST_LIKE = dict(num_iters=3, caps_out_shifts=(8, 8, 9),
                  caps_out_fracs=(7, 7, 6), agree_shifts=(8, 8), logit_frac=7)
MNIST_ROUTING = (10, 1024, 6)              # (J, I, O) of mnist@cuda
SQUASH_DIMS = (1, 6, 16, 17, 18, 20, 32)   # squash_q7 widths checked
# ((B, J, I, O), iterations): past the former limits of 16 and 8
WIDE_ROUTING = (((3, 7, 33, 32), 16), ((2, 5, 64, 20), 9),
                ((4, 10, 72, 18), 3), ((4, 4, 16, 4), 16))
UNSTAGED_ROUTING = (2, 10, 40_000, 6)      # no slice fits shared memory
# kernel name (as the profiler shows it) of each main-path wrapper; the
# library kernels are timed over every kernel their call launches
KERNEL_NAMES = {"routing_q7": "routing_q7", "squash_q7": "squash_q7"}


def shape_key(shape) -> str:
    return "x".join(map(str, shape))


def squash_float_input(shape, dt: str, g, dev, view: bool = False):
    """A float tensor on the card, normal(0, 2) from `g`; with `view`,
    its s[:, 1:]."""
    import torch
    s = (torch.randn(shape, generator=g) * 2).to(getattr(torch, dt)).to(dev)
    return s[:, 1:] if view else s


def squash_float_cases():
    """(key, shape, dtype, view) of every squash_float call timed."""
    cases = [(f"{shape_key(sh)} {dt}", sh, dt, False)
             for sh, dt in SQUASH_FLOAT_SHAPES]
    sh, dt = SQUASH_FLOAT_VIEW
    return cases + [(f"{shape_key(sh)}[:, 1:] {dt}", sh, dt, True)]


def squash_float_bound(shape, dt: str, view: bool):
    """The bytes of one call (each input element read once, each output
    element written once) over HBM's rate, against 4 float32 operations
    an element; returns (ms, what bounds it)."""
    R, D = shape[0], shape[1] - (1 if view else 0)
    itemsize = {"float32": 4, "bfloat16": 2, "float16": 2}[dt]
    bytes_ms = 2 * R * D * itemsize / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * R * D / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def device_times(dev) -> dict:
    """Profiler device time of every kernel: routing_q7 at the MNIST
    geometry [B, 10, 1024, 6] and squash_q7 at [B*1024, 4] for every
    bucket B; matmul_q7 and w8a8_matmul at every GEMM_SHAPES entry and
    bmm_q7 at BMM_SHAPE, each summed over every kernel of the call, with
    torch._int_mm's device time at the same shapes as the yardstick
    (None where it refuses the shape); squash_float at every
    SQUASH_FLOAT_SHAPES entry and on the misaligned view, summed over
    every kernel of the call (a tree whose wrapper casts bf16 to float32
    and back counts the casts), and the empty kernel of
    csrc/squash_float.cu, the launch floor (None on a tree without it).
    Operands as in phase 6, from SEED + 3."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    g = torch.Generator().manual_seed(SEED + 3)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)

    out = {"routing_q7": {}, "squash_q7": {}, "q7_matmul": {},
           "w8a8_matmul": {}, "int_mm": {}, "parts": {}}
    for B in BUCKETS:
        u = i8((B,) + MNIST_ROUTING)
        s = i8((B * 1024, 4))
        out["routing_q7"][B] = device_ms(
            lambda: kr.routing_q7(u, **MNIST_LIKE), KERNEL_NAMES["routing_q7"])
        out["squash_q7"][B] = device_ms(
            lambda: ks.squash_q7(s, in_frac=7), KERNEL_NAMES["squash_q7"])
    for shape in GEMM_SHAPES:
        a, b, sh = (x.to(dev) for x in gemm_operands(*shape, g))
        key = shape_key(shape)
        for name, call in (("q7_matmul", lambda: ops.matmul_q7(a, b, 13)),
                           ("w8a8_matmul", lambda: ops.w8a8_matmul(a, b,
                                                                    sh))):
            split = out["parts"][f"{name} {key}"] = {}
            out[name][key] = device_ms(call, None, calls=20, parts=split)
        out["int_mm"][key] = int_mm_device_ms(a, b)
    Bt, M, K, N = BMM_SHAPE
    a, b = i8((Bt, M, K)), i8((Bt, K, N))
    key = shape_key(BMM_SHAPE)
    split = out["parts"][f"q7_matmul {key}"] = {}
    out["q7_matmul"][key] = device_ms(lambda: ops.bmm_q7(a, b, 13), None,
                                      calls=20, parts=split)
    out["squash_float"] = {}
    for key, shape, dt, view in squash_float_cases():
        sf = squash_float_input(shape, dt, g, dev, view)
        out["squash_float"][key] = device_ms(lambda: ops.squash_float(sf),
                                             None)
        del sf
    floor = getattr(ks, "squash_float_floor", None)
    out["squash_float_floor"] = None if floor is None \
        else device_ms(lambda: floor(dev), None)
    return out


def sass_counts(lib: Path) -> dict:
    """Tensor-core instructions in a built library's SASS (cuobjdump, next
    to nvcc): IGMMA is wgmma's int8 form, IMMA mma.sync's."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass))
            for op in ("IGMMA", "IMMA")}


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


def check_isqrt(dev, g) -> int:
    """The device isqrt against int8_ops.isqrt_newton (run on the card)
    on every n in [0, 2^31 - 1], in chunks, and on a sample of negative
    n; returns the size of that sample."""
    import torch
    from repro_torch.kernels import squash as ks
    from repro_torch.quant import int8_ops as q
    chunk = 1 << 27
    bad = 0
    for lo in range(0, 1 << 31, chunk):
        n = torch.arange(lo, lo + chunk, dtype=torch.int64,
                         device=dev).to(torch.int32)
        bad += int((ks.isqrt(n) != q.isqrt_newton(n)).sum())
    neg = torch.cat([torch.tensor([-2 ** 31, -2 ** 31 + 1, -46_341, -1],
                                  dtype=torch.int32),
                     torch.randint(-2 ** 31, 0, (1 << 20,), generator=g,
                                   dtype=torch.int32)]).to(dev)
    bad += int((ks.isqrt(neg) != q.isqrt_newton(neg)).sum())
    if bad:
        raise AssertionError(f"device isqrt differs from isqrt_newton on "
                             f"{bad} values")
    return neg.numel()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
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
    for D in SQUASH_DIMS:
        s16 = i8((4096, D))
        got = ks.squash_q7(s16.to(dev), in_frac=5, out_frac=6)
        require_equal(f"squash_q7 D={D}", got,
                      ks.squash_q7_plain(s16, in_frac=5, out_frac=6))
    n_neg = check_isqrt(dev, g)
    log(f"[kernels] squash_q7 bit-exact for in_frac 0..12 on "
        f"{tuple(s.shape)}, D {SQUASH_DIMS}; device isqrt equal to "
        f"isqrt_newton on every n in [0, 2^31 - 1] and on {n_neg} "
        f"negative n")

    u = i8((B_TIMED,) + MNIST_ROUTING)
    u_dev = u.to(dev)
    for rounding in ROUNDINGS:
        got = kr.routing_q7(u_dev, rounding=rounding, **MNIST_LIKE)
        err["routing_q7"] = max(err["routing_q7"], require_equal(
            f"routing_q7 {rounding} vs plain on card", got,
            kr.routing_q7_plain(u_dev, rounding=rounding, **MNIST_LIKE)))
        require_equal(f"routing_q7 {rounding} vs plain on cpu", got,
                      kr.routing_q7_plain(u, rounding=rounding,
                                          **MNIST_LIKE))
    # the MNIST geometry at every bucket, at the wrapper's cluster size and
    # at every size a caller may force, both roundings
    for B in BUCKETS:
        u_dev = i8((B,) + MNIST_ROUTING).to(dev)
        for rounding in ROUNDINGS:
            want = kr.routing_q7_plain(u_dev, rounding=rounding, **MNIST_LIKE)
            for cs in (None,) + kr.CLUSTER_SIZES:
                err["routing_q7"] = max(err["routing_q7"], require_equal(
                    f"routing_q7 B={B} cs={cs} {rounding}",
                    kr.routing_q7(u_dev, rounding=rounding, cs=cs,
                                  **MNIST_LIKE), want))
    log(f"[kernels] routing_q7 bit-exact on [B,10,1024,6], B in {BUCKETS}, "
        f"at cluster sizes {kr.CLUSTER_SIZES} (the wrapper picks "
        f"{[kr.cluster_size(B, *MNIST_ROUTING) for B in BUCKETS]}), both "
        f"roundings")

    # the shift domain the static checker allows, plus other geometries;
    # each table also at a forced cluster size, most not dividing I
    sweep, forced = 0, set()
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
            cs = min(I, 3 + (B * k + I) % (kr.MAX_CLUSTER - 2))
            for rounding in ROUNDINGS:
                want = kr.routing_q7_plain(u, rounding=rounding, **kw)
                for c in (None, cs):
                    require_equal(f"routing_q7 sweep {(B, J, I, O)} cs={c} "
                                  f"{kw} {rounding}",
                                  kr.routing_q7(u.to(dev), rounding=rounding,
                                                cs=c, **kw), want)
                forced.add((I, cs))
                sweep += 1
    log(f"[kernels] routing_q7 bit-exact on [64,10,1024,6] both roundings "
        f"and on {sweep} random shift tables over [-31, 31], each at the "
        f"wrapper's cluster size and a forced one ((I, cs): "
        f"{sorted(forced)})")

    # capsule dims above 16 and more than 8 iterations (up to the kernel's
    # 32 and 16), each slice staged and read from global memory, every
    # cluster size; then a slice too large to stage at 8 CTAs
    for (B, J, I, O), r in WIDE_ROUTING:
        u = i8((B, J, I, O))
        kw = dict(num_iters=r,
                  caps_out_shifts=tuple(torch.randint(
                      -31, 32, (r,), generator=g).tolist()),
                  caps_out_fracs=tuple(torch.randint(
                      0, 13, (r,), generator=g).tolist()),
                  agree_shifts=tuple(torch.randint(
                      -31, 32, (r - 1,), generator=g).tolist()),
                  logit_frac=int(torch.randint(-3, 8, (1,), generator=g)))
        for rounding in ROUNDINGS:
            want = kr.routing_q7_plain(u, rounding=rounding, **kw)
            for cs in (None,) + tuple(range(1, min(I, kr.MAX_CLUSTER) + 1)):
                for stage in (None, True, False):
                    err["routing_q7"] = max(err["routing_q7"], require_equal(
                        f"routing_q7 {(B, J, I, O)} r={r} cs={cs} "
                        f"stage={stage} {rounding}",
                        kr.routing_q7(u.to(dev), rounding=rounding, cs=cs,
                                      stage=stage, **kw), want))
    B, J, I, O = UNSTAGED_ROUTING
    if kr.stages(J, I, O, kr.cluster_size(B, J, I, O)):
        raise AssertionError(f"{UNSTAGED_ROUTING} was expected unstaged")
    u = i8(UNSTAGED_ROUTING)
    for rounding in ROUNDINGS:
        err["routing_q7"] = max(err["routing_q7"], require_equal(
            f"routing_q7 {UNSTAGED_ROUTING} unstaged {rounding}",
            kr.routing_q7(u.to(dev), rounding=rounding, **MNIST_LIKE),
            kr.routing_q7_plain(u, rounding=rounding, **MNIST_LIKE)))
    log(f"[kernels] routing_q7 bit-exact on {WIDE_ROUTING} ((B, J, I, O), "
        f"iterations) at every cluster size, u_hat staged and unstaged, "
        f"and on {UNSTAGED_ROUTING} (cluster size "
        f"{kr.cluster_size(B, J, I, O)}, u_hat unstaged), both roundings")
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
                engine=engine, wall=wall, completions=completions,
                registry=reg)


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
    cfg = qnet.pipeline.cfg
    if v.shape != (len(images), cfg.num_classes, cfg.caps_dim) \
            or not np.all(np.abs(v) <= 128):
        raise AssertionError(f"served v_q of shape {v.shape}")
    log(f"[main] {run['spec'].model_id} ({qnet.variants.tag}): "
        f"{len(comps)} served completions bit-exact against the "
        f"torch backend on the card and on the CPU; pred classes "
        f"{np.bincount(got_pred, minlength=cfg.num_classes).tolist()}")


# ---------------------------------------------------------------------------
# phase 4: the exported artifact, served on the card
# ---------------------------------------------------------------------------
def serve_artifact(run, dev) -> dict:
    """Export the main path's model as an MCU artifact, install the file
    on the card and serve it: the second path through the entry points a
    user calls.  Returns the artifact's engine and its kernel counts."""
    import numpy as np
    import torch
    from repro_torch.edge import EdgeProgram, EdgeVM, lower, to_qnet
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.launch import serve_caps
    from repro_torch.nn.backend import get_backend
    from repro_torch.serving import ModelRegistry, serve_window
    shutil.rmtree(EDGE_DIR, ignore_errors=True)
    result = run["registry"].export(run["spec"].model_id, EDGE_DIR)
    paths = result["paths"]
    if sorted(p.suffix for p in paths.values()) != \
            [".c", ".capsbin", ".h", ".json"] or result["verified"] != 4:
        raise AssertionError(f"export wrote {paths}, verified "
                             f"{result['verified']} images")
    program = EdgeProgram.load(paths["capsbin"])
    if not program.same_as(result["program"]):
        raise AssertionError("the reloaded .capsbin is not the program")
    if not lower(to_qnet(program, device=dev),
                 name=program.name).same_as(program):
        raise AssertionError("lower(to_qnet(p)) is not p")
    log(f"[artifact] {run['spec'].model_id} exported to {EDGE_DIR} "
        f"({', '.join(p.name for p in paths.values())}; "
        f"{paths['capsbin'].stat().st_size} bytes .capsbin), VM-verified "
        f"on {result['verified']} images; reload and lower(to_qnet(p)) "
        f"give the same program")

    # the artifact path: counts from 0 just before, read just after
    fallbacks = get_backend("cuda").fallbacks
    fb0 = dict(fallbacks)
    ks.squash_q7.launches = 0
    kr.routing_q7.launches = 0
    reg = ModelRegistry(specs={}, device=dev)
    qnet = reg.install_artifact(paths["capsbin"])
    images = run["images"][:N_REQUESTS]
    engine, done, _ = serve_window(reg, BUCKETS, images, program.name)
    launches = {"squash_q7": ks.squash_q7.launches,
                "routing_q7": kr.routing_q7.launches}
    if qnet.backend != "cuda" or qnet.device.type != "cuda":
        raise AssertionError(f"installed on {qnet.device}, backend "
                             f"{qnet.backend}")
    if min(launches.values()) == 0 or dict(fallbacks) != fb0:
        raise AssertionError(f"artifact path launches {launches}, cuda "
                             f"fallbacks {dict(fallbacks)} (were {fb0})")
    got = sorted(done, key=lambda c: c.rid)
    live = sorted((c for c in run["completions"] if c.rid < N_REQUESTS),
                  key=lambda c: c.rid)
    v = np.stack([c.v_q for c in got])
    if not np.array_equal(v, np.stack([c.v_q for c in live])) or \
            [c.pred for c in got] != [c.pred for c in live]:
        raise AssertionError("the artifact's completions differ from the "
                             "live model's")
    with torch.inference_mode():
        x_q = qnet.quantize_input(torch.as_tensor(images[:16]).to(dev))
    if not np.array_equal(v[:16], EdgeVM(program).run(x_q.cpu().numpy())):
        raise AssertionError("the artifact served on the card differs from "
                             "the EdgeVM on the CPU")
    log(f"[artifact] install_artifact on the card (backend cuda): "
        f"{len(got)} requests bit-identical to the live "
        f"{run['spec'].model_id}; the first 16 equal the EdgeVM on the "
        f"CPU; launches {launches}; cuda fallbacks unchanged")

    rc = serve_caps.main(["--capsbin", str(paths["capsbin"]),
                          "--requests", str(N_REQUESTS)])
    if rc != 0:
        raise AssertionError(f"serve_caps --capsbin: exit {rc}")
    ops = list(program.ops)
    ops[0] = dataclasses.replace(ops[0], attrs={**ops[0].attrs,
                                                "out_shift": 45})
    bad = dataclasses.replace(program, ops=tuple(ops)).save(
        EDGE_DIR / "tampered")["capsbin"]
    rc = serve_caps.main(["--capsbin", str(bad), "--requests", "4"])
    if rc != 1:
        raise AssertionError(f"serve_caps took an artifact with a shift of "
                             f"45: exit {rc}")
    log(f"[artifact] serve_caps --capsbin --requests {N_REQUESTS}: exit 0; "
        f"a copy with conv0's out_shift at 45: exit 1 (refused)")
    return dict(engine=engine, launches=launches, registry=reg,
                model_id=program.name)



# ---------------------------------------------------------------------------
# phase 9: observability (repro_torch.obs) on the main path
# ---------------------------------------------------------------------------
WAVE_CHILDREN = ["serve.bucket", "serve.compile", "serve.execute",
                 "serve.complete"]
GEOMETRY_EDITS = (dict(pcap_dim=18), dict(caps_dim=20), dict(routings=9))
FORWARD_REPEATS = 7                # forward_q7 timings of 50 calls each
FORWARD_ROUNDS = 40                # --forward-pairs rounds, 50 calls a side
SERVE_PAIRS = 8                    # untraced / traced serving windows
BUSY_WINDOWS = 5                   # window pairs (unprofiled, profiled)


def serve_stream(reg, mid: str, images) -> tuple:
    """Phase 3's request stream (a burst of N_REQUESTS, then the groups
    that fill every bucket) through ONE engine, so request ids run over
    the whole stream.  Returns (engine, completions)."""
    from repro_torch.serving import CapsServeEngine
    engine = CapsServeEngine(reg, buckets=BUCKETS)
    engine.submit_many(images[:N_REQUESTS], mid)
    done = engine.drain()
    start = N_REQUESTS
    for n in (1, 3, 4, 13, 16, 40, 51):
        engine.submit_many(images[start:start + n], mid)
        done.extend(engine.drain())
        start += n
    return engine, done


def traced_serving(run, card: str) -> dict:
    """The main path's stream again under a tracer and a numerics probe:
    the same completions, the reference's span tree, every request's
    timeline rebuilt by the analyzer."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.obs import analyze
    from repro_torch.obs import numerics as nh
    reg, mid = run["registry"], run["spec"].model_id
    tracer, probe = obs.Tracer(), nh.NumericsProbe()
    with obs.tracing(tracer), nh.probing(probe):
        _, done = serve_stream(reg, mid, run["images"])
    want = {c.rid: c for c in run["completions"]}
    if sorted(c.rid for c in done) != sorted(want):
        raise AssertionError("the traced stream served other requests")
    for c in done:
        w = want[c.rid]
        if not np.array_equal(c.v_q, w.v_q) or c.pred != w.pred \
                or c.bucket != w.bucket:
            raise AssertionError(f"traced request {c.rid} differs from "
                                 f"phase 3's")
    waves = tracer.find("serve.wave")
    n_waves = len({c.wave for c in done})
    if len(waves) != n_waves or any(
            [k.name for k in w.children] != WAVE_CHILDREN for w in waves):
        raise AssertionError(f"{len(waves)} serve.wave spans for {n_waves} "
                             f"waves, or a wave without {WAVE_CHILDREN}")
    if len(tracer.find("serve.enqueue")) != len(done):
        raise AssertionError("not one serve.enqueue per request")
    report = analyze.analyze(tracer)
    rebuilt = [r for r in report["requests"] if "e2e_s" in r]
    if sorted(r["req_id"] for r in rebuilt) != sorted(want):
        raise AssertionError(f"the analyzer rebuilt {len(rebuilt)} of "
                             f"{len(done)} request timelines")
    rows = probe.rows()
    clips = sum(r.get("int32_clip", 0) for r in rows)
    if clips or {r["op"] for r in rows} != {"conv0", "pcap", "caps"}:
        raise AssertionError(f"probe rows: {len(rows)}, int32 clips {clips}")
    log(f"[obs] {card} | {mid}: {len(done)} requests traced and probed, "
        f"bit-identical to phase 3; {len(waves)} serve.wave spans with "
        f"{WAVE_CHILDREN} under each, {len(done)} serve.enqueue; the "
        f"analyzer rebuilt {len(rebuilt)} timelines; {len(rows)} probe "
        f"rows, 0 int32 clips")
    for b in report["breakdown"]:
        log(f"[obs] {card} | wave breakdown {b['model']} bucket "
            f"{b['bucket']}: {b['waves']} waves, {b['images']} images, "
            f"queue {b['queue_s'] * 1e3:.3f} ms (summed over the "
            f"requests), compile {b['compile_s'] * 1e3:.3f} ms, execute "
            f"{b['execute_s'] * 1e3:.3f} ms (summed over the waves)")
    return report


def obs_clis(run, dev, card: str) -> None:
    """serve_caps and export_caps with every observability flag, into
    build/obs_smoke/, read back by the analyzer."""
    from repro_torch.edge import EdgeProgram, EdgeVM, lower
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.launch import export_caps, serve_caps
    from repro_torch.obs import analyze
    from repro_torch.obs import numerics as nh
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    out = {k: OBS_DIR / f"{k}.json" for k in ("trace", "metrics",
                                             "numerics")}
    ks.squash_q7.launches = 0
    kr.routing_q7.launches = 0
    rc = serve_caps.main(["--model", "mnist@cuda", "--requests",
                          str(N_REQUESTS), "--trace", str(out["trace"]),
                          "--trace-summary", "--metrics-out",
                          str(out["metrics"]), "--numerics-out",
                          str(out["numerics"]), "--profile"])
    launches = {"squash_q7": ks.squash_q7.launches,
                "routing_q7": kr.routing_q7.launches}
    if rc != 0 or min(launches.values()) == 0:
        raise AssertionError(f"serve_caps with the obs flags: exit {rc}, "
                             f"launches {launches}")
    if analyze.main([str(out["trace"]), "--metrics",
                     str(out["metrics"])]) != 0 or \
            analyze.main([str(out["numerics"]), "--gate-clips"]) != 0:
        raise AssertionError("repro_torch.obs.analyze refused the run's "
                             "trace, metrics or numerics doc")
    report = nh.NumericsReport.from_doc(json.loads(
        out["numerics"].read_text()))
    findings = nh.check_containment(lower(run["qnet"]), report)
    if report.total_int32_clip() or findings:
        raise AssertionError(f"numerics: {report.total_int32_clip()} int32 "
                             f"clips, findings {findings}")
    log(f"[obs] {card} | serve_caps --model mnist@cuda --requests "
        f"{N_REQUESTS} --trace --trace-summary --metrics-out --numerics-out "
        f"--profile: exit 0, launches {launches}; obs.analyze read the "
        f"trace, the metrics and the numerics doc (0 int32 clips, "
        f"contained, min SNR {report.min_snr_db():.2f} dB)")

    rc = export_caps.main(["--model", "mnist@cuda", "--out",
                           str(OBS_DIR / "export"), "--numerics",
                           "--drift"])
    if rc != 0:
        raise AssertionError(f"export_caps --numerics --drift: exit {rc}")
    program = EdgeProgram.load(OBS_DIR / "export" / "mnist_cuda.capsbin")
    vm = EdgeVM(program)
    x_q = vm.quantize_input(run["spec"].images(8, seed=0))
    rows: list = []
    vm.run(x_q, profile=rows)
    drift = analyze.costmodel_drift(program, rows, batch=8)
    if drift["coverage"] != 1.0 or drift["unmatched"]:
        raise AssertionError(f"costmodel_drift joined {drift['n_joined']} "
                             f"of {drift['n_ops']} ops")
    log(f"[obs] export_caps --model mnist@cuda --numerics --drift: exit 0; "
        f"costmodel_drift joins {drift['n_joined']} of {drift['n_ops']} ops")


def serve_widened_geometries(dev, card: str) -> dict:
    """edge_tiny@cuda at the geometries the kernels took only once widened
    (capsule dim above 16, more than 8 iterations), each against the
    torch backend, through both kernels and with no fallback counted."""
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.nn.backend import get_backend
    from repro_torch.nn.config import EDGE_TINY
    fallbacks = dict(get_backend("cuda").fallbacks)
    counts = {}
    for edit in GEOMETRY_EDITS:
        ks.squash_q7.launches = 0
        kr.routing_q7.launches = 0
        serve_other(dev, "edge_tiny@cuda",
                    config=dataclasses.replace(EDGE_TINY, **edit))
        counts[str(edit)] = {"squash_q7": ks.squash_q7.launches,
                             "routing_q7": kr.routing_q7.launches}
        if min(counts[str(edit)].values()) == 0:
            raise AssertionError(f"edge_tiny@cuda {edit}: a kernel was not "
                                 f"launched: {counts[str(edit)]}")
    if dict(get_backend("cuda").fallbacks) != fallbacks:
        raise AssertionError(f"the widened geometries fell back: "
                             f"{dict(get_backend('cuda').fallbacks)}")
    log(f"[obs] {card} | edge_tiny@cuda at {GEOMETRY_EDITS}: {N_OTHER} "
        f"requests each bit-identical to the torch backend, through the "
        f"kernels (launches {counts}), no fallback counted")
    return counts


def forward_ms(qnet, xq) -> list:
    """FORWARD_REPEATS timings of the untraced, unprobed forward_q7 (mean
    of 50 calls each, CUDA events), as phase 7 times it."""
    import torch
    with torch.inference_mode():
        return [cuda_ms(lambda: qnet.forward(xq), iters=50)
                for _ in range(FORWARD_REPEATS)]


def forward_worker(dev) -> None:
    """`--forward-worker`: build mnist@cuda and its B=64 input with only
    the API every tree of the port has (so a parent's tree runs this
    script copied into it), print "[worker] ready", then answer each
    line of standard input with one timing of 50 untraced, unprobed
    forward_q7 calls ("[worker] ms T") until the input ends."""
    import torch
    from repro_torch.serving import ModelRegistry
    reg = ModelRegistry(device=dev)
    spec = reg.specs["mnist@cuda"]
    qnet = reg.model("mnist@cuda")
    x = torch.as_tensor(spec.images(2 * N_REQUESTS, SEED)[:B_TIMED]).to(dev)
    with torch.inference_mode():
        xq = qnet.quantize_input(x)
        cuda_ms(lambda: qnet.forward(xq), iters=50)
    log("[worker] ready")
    for _ in sys.stdin:
        with torch.inference_mode():
            log(f"[worker] ms {cuda_ms(lambda: qnet.forward(xq), iters=50)!r}")


def forward_pairs(parent: Path, card: str) -> dict:
    """`--forward-pairs PARENT`: this tree's and PARENT's B=64 forward_q7
    in four live worker processes, started in the order parent, change,
    change, parent (so neither side owns the first process), each timed
    once a round for FORWARD_ROUNDS rounds, the order rotating by round.
    Reports each side's median, the median per-round difference (mean
    of the change's two workers less the parent's) beside its quartiles,
    and the same for the two workers of each side, the noise between
    processes that run the same code.  Every worker is stopped before it
    returns."""
    shutil.copy(Path(__file__), parent / "chip_smoke.py")
    order = [("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent)]
    procs = []

    def start(side: str, tree: Path):
        p = subprocess.Popen(
            [sys.executable, str(tree / "chip_smoke.py"), "--forward-worker"],
            cwd=tree, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1)
        procs.append((side, p))
        for line in p.stdout:
            if line.startswith("[worker] ready"):
                return
        raise AssertionError(f"a {side} worker ended before it was ready "
                             f"(exit {p.wait()})")

    ms = [[] for _ in order]
    try:
        for side, tree in order:        # one at a time: one build a tree
            start(side, tree)
        for rnd in range(FORWARD_ROUNDS):
            for k in range(len(order)):
                w = (k + rnd) % len(order)
                side, p = procs[w]
                p.stdin.write("time\n")
                line = p.stdout.readline()
                if not line.startswith("[worker] ms "):
                    raise AssertionError(f"a {side} worker answered {line!r}")
                ms[w].append(float(line.split()[-1]))
    finally:
        for _, p in procs:
            p.stdin.close()
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def spread(name: str, d: list) -> str:
        q = statistics.quantiles(d, n=4)
        return (f"{name}: median {statistics.median(d):+.4f} ms, quartiles "
                f"{q[0]:+.4f} to {q[2]:+.4f}, negative in "
                f"{sum(x < 0 for x in d)} of {len(d)} rounds")

    diff = [(c1 + c2 - p1 - p2) / 2
            for p1, c1, c2, p2 in zip(*ms)]
    within = {"parent 1st - 4th": [a - b for a, b in zip(ms[0], ms[3])],
              "change 2nd - 3rd": [a - b for a, b in zip(ms[1], ms[2])]}
    sides = {s: statistics.median(ms[0] + ms[3] if s == "parent"
                                  else ms[1] + ms[2])
             for s in ("parent", "change")}
    for w, (side, _) in enumerate(procs):
        log(f"[forward] {card} | worker {w + 1} ({side}): "
            + ", ".join(f"{t:.4f}" for t in ms[w]) + " ms")
    log(f"[forward] {card} | mnist@cuda B={B_TIMED} forward_q7, untraced and "
        f"unprobed, 50 calls a timing, {FORWARD_ROUNDS} rounds: medians "
        f"parent {sides['parent']:.4f} ms, change {sides['change']:.4f} ms; "
        + spread("change - parent", diff) + "; "
        + "; ".join(spread(k, d) for k, d in within.items()))
    return dict(ms=ms, diff=diff, within=within)


def probes_off_times(run, dev, card: str) -> dict:
    """The untraced forward_q7 beside a probed one, and the untraced
    serving window's img/s beside a traced one's, in turns."""
    import torch
    from repro_torch import obs
    from repro_torch.obs import numerics as nh
    from repro_torch.serving import serve_window
    qnet, mid = run["qnet"], run["spec"].model_id
    x = torch.as_tensor(run["images"][:B_TIMED]).to(dev)
    with torch.inference_mode():
        xq = qnet.quantize_input(x)
    off = forward_ms(qnet, xq)
    with nh.probing(nh.NumericsProbe()), torch.inference_mode():
        probed = cuda_ms(lambda: qnet.forward(xq), iters=5)
    log(f"[obs] {card} | mnist@cuda B={B_TIMED} forward_q7 with probes and "
        f"tracer off, {FORWARD_REPEATS} x 50 calls: "
        + ", ".join(f"{t:.4f}" for t in off)
        + f" ms; with a numerics probe on: {probed:.4f} ms")
    rates = {"untraced": [], "traced": []}
    for _ in range(SERVE_PAIRS):
        for what in rates:
            tracer = obs.Tracer() if what == "traced" else None
            with obs.tracing(tracer):
                eng, _, _ = serve_window(run["registry"], BUCKETS,
                                         run["images"][:N_REQUESTS], mid)
            rates[what].append(eng.metrics.summary()["images_per_s"])
    med = {k: statistics.median(v) for k, v in rates.items()}
    log(f"[obs] {card} | {mid} serving {N_REQUESTS} requests, img/s in "
        f"{SERVE_PAIRS} turns: untraced "
        + ", ".join(f"{r:.1f}" for r in rates["untraced"])
        + "; traced " + ", ".join(f"{r:.1f}" for r in rates["traced"])
        + f"; medians {med['untraced']:.1f} and {med['traced']:.1f}")
    return dict(forward_ms=off, probed_ms=probed, rates=rates)


def busy_share(run, card: str) -> dict:
    """The card's busy share of an untraced serving window (submit ->
    drained, on a warm engine), from BUSY_WINDOWS pairs of windows: an
    unprofiled one, then one under torch.profiler (CUDA activity only).
    The union of the profiled window's kernel intervals is taken over
    its own wall ("same window": the profiler slows the host, so this
    understates the share) and over the wall of the unprofiled window
    just before it ("paired"): the kernels run on one stream, so the
    union is the sum of their durations, which the host's speed does
    not change; the unions' spread across the pairs checks that."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import CapsServeEngine
    reg, mid = run["registry"], run["spec"].model_id
    images = run["images"][:N_REQUESTS]
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    path = OBS_DIR / "serve_window_profile.json"

    def warm_engine():
        engine = CapsServeEngine(reg, buckets=BUCKETS)
        engine.warmup(mid)
        torch.cuda.synchronize()
        return engine

    def window(engine) -> float:
        t0 = time.perf_counter()
        engine.submit_many(images, mid)
        if len(engine.drain()) != N_REQUESTS:
            raise AssertionError(f"a window served fewer than {N_REQUESTS}")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    def union(trace: Path) -> tuple:
        kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in
                         json.loads(trace.read_text())["traceEvents"]
                         if e.get("cat") == "kernel")
        if not kernels:
            raise AssertionError("the profiler saw no kernel in the window")
        busy, end = 0.0, kernels[0][0]
        for a, b in kernels:
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy, len(kernels)

    pairs = []
    for _ in range(BUSY_WINDOWS):
        plain_us = window(warm_engine())
        engine = warm_engine()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiled_us = window(engine)
        prof.export_chrome_trace(str(path))
        busy, n = union(path)
        pairs.append(dict(plain_us=plain_us, profiled_us=profiled_us,
                          busy_us=busy, kernels=n))
    same = statistics.median(p["busy_us"] / p["profiled_us"] for p in pairs)
    paired = statistics.median(p["busy_us"] / p["plain_us"] for p in pairs)
    unions = [p["busy_us"] / 1e3 for p in pairs]
    log(f"[obs] {card} | busy share of an untraced {N_REQUESTS}-request "
        f"{mid} window (submit -> drained, warm engine), {BUSY_WINDOWS} "
        f"pairs (unprofiled wall ms, profiled wall ms, kernel union ms, "
        f"kernels): " + "; ".join(
            f"{p['plain_us'] / 1e3:.3f}, {p['profiled_us'] / 1e3:.3f}, "
            f"{p['busy_us'] / 1e3:.3f}, {p['kernels']}" for p in pairs)
        + f"; union spread {min(unions):.3f}-{max(unions):.3f} ms; median "
        f"share paired {paired * 100:.2f} % busy "
        f"({(1 - paired) * 100:.2f} % idle), same window "
        f"{same * 100:.2f} % busy")
    return dict(paired=paired, same_window=same, pairs=pairs)


# ---------------------------------------------------------------------------
# phase 7: times
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
        # bytes: input read once, output written once; ops: the integer
        # multiply-adds (2 ops each) the function needs, per-sample sums
        # on the CUDA cores' int32 lanes, no tensor-core product; the
        # squash's isqrt and division have no entry in the rate table
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
            ops_ms = w["ops"] / INT32_OPS_PER_S * 1e3
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


# ---------------------------------------------------------------------------
# phase 5: the other configs and the variant fallback
# ---------------------------------------------------------------------------
def serve_other(dev, mid: str, **spec_edit) -> None:
    """Serve N_OTHER requests of `mid` (its spec edited by `spec_edit`)
    and hold every completion against the `torch` backend."""
    from repro_torch.serving import ModelRegistry, serve_window
    reg = ModelRegistry(device=dev)
    if spec_edit:
        reg.register(dataclasses.replace(reg.specs[mid], **spec_edit))
    spec = reg.specs[mid]
    images = spec.images(N_OTHER, SEED)
    qnet = reg.model(mid)
    _, done, _ = serve_window(reg, BUCKETS, images, mid)
    check_completions(dict(spec=spec, qnet=qnet, images=images,
                           completions=done))
    if reg.variant_fallbacks:
        log(f"[other] registry variant fallbacks: {reg.variant_fallbacks}")


# ---------------------------------------------------------------------------
# phase 6: the kernel library
# ---------------------------------------------------------------------------
def wrap_and_return(M: int, K: int, N: int, g):
    """int8 a [M, K], b [K, N]: 132,000 products of (-128)(-128), then
    133,040 of (-128)(127), then random ones.  Every output's running
    int32 sum passes 2^31 - 1 after 131,072 products and is back near
    -10,240 before the random tail: wrapping gives the exact result,
    saturating anywhere (a partial, a split-K sum) does not."""
    import torch
    k1, k2 = 132_000, 133_040
    a = torch.full((M, K), -128, dtype=torch.int8)
    b = torch.full((K, N), -128, dtype=torch.int8)
    b[k1:k1 + k2] = 127
    a[:, k1 + k2:] = torch.randint(-128, 128, (M, K - k1 - k2), generator=g,
                                   dtype=torch.int8)
    b[k1 + k2:] = torch.randint(-128, 128, (K - k1 - k2, N), generator=g,
                                dtype=torch.int8)
    return a, b


def gemm_operands(M: int, K: int, N: int, g):
    """int8 a [M, K], b [K, N] and int32 column shifts over [-40, 40] on
    the CPU; the wrap shape's operands are all -128, the wrap-and-return
    shape's from `wrap_and_return`."""
    import torch
    if (M, K, N) == WRAP_SHAPE:
        a = torch.full((M, K), -128, dtype=torch.int8)
        b = torch.full((K, N), -128, dtype=torch.int8)
    elif (M, K, N) == WRAP_RETURN_SHAPE:
        a, b = wrap_and_return(M, K, N, g)
    else:
        a = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
        b = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8)
    sh = torch.randint(-40, 41, (N,), generator=g, dtype=torch.int32)
    return a, b, sh


def within(what: str, got, want, rtol: float, atol: float) -> float:
    """max |got - want| in float32, raising above atol + rtol * |want|
    or on a value that is not finite."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    g32, w32 = got.float(), want.float()
    diff = (g32 - w32).abs()
    if not bool(torch.isfinite(g32).all()) or \
            bool((diff > atol + rtol * w32.abs()).any()):
        raise AssertionError(f"{what}: max |kernel - plain| = "
                             f"{float(diff.max())} beyond rtol {rtol} / "
                             f"atol {atol}")
    return float(diff.max())


def gemm_route(a, b) -> str:
    """The route, tile and split that gemm_plan picks for these operands,
    as one line's words."""
    from repro_torch.kernels import q7_matmul as kq
    plan = kq.plan_for(a.contiguous(), b.contiguous())
    return f"route {plan.route} tile {plan.tile[0]}x{plan.tile[1]} " \
        f"split {plan.split}"


def counted_route(fn, route: str, call):
    """call(), requiring that it raised fn.launches_by_route[route] by
    one and no other route's count."""
    before = dict(fn.launches_by_route)
    out = call()
    before[route] += 1
    if fn.launches_by_route != before:
        raise AssertionError(f"{fn.__name__}: launches by route "
                             f"{fn.launches_by_route}, expected {before}")
    return out


def drive_kernel_library(dev) -> dict:
    """Every call goes through `repro_torch.kernels.ops` on card tensors
    and is held against its plain version, on the route gemm_plan names
    (counted in launches_by_route); returns the worst error of each
    kernel."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import q7_matmul as kq
    from repro_torch.kernels import squash as ks
    from repro_torch.kernels import w8a8_matmul as kw
    g = torch.Generator().manual_seed(SEED + 1)
    for (M, K, N) in GEMM_SHAPES:
        a, b, sh = gemm_operands(M, K, N, g)
        ad, bd, shd = a.to(dev), b.to(dev), sh.to(dev)
        plan = kq.plan_for(ad, bd)
        log(f"[library] {(M, K, N)}: {gemm_route(ad, bd)}")
        if (M, K, N) in WGMMA_SHAPES and plan.route != "wgmma":
            raise AssertionError(f"{(M, K, N)} planned on {plan}")
        small = M * K * N <= 1 << 24
        for rounding in ROUNDINGS:
            for shift in (0, 9, 13, -2):
                got = counted_route(kq.matmul_q7, plan.route,
                                    lambda: ops.matmul_q7(ad, bd, shift,
                                                          rounding))
                require_equal(f"matmul_q7 {(M, K, N)} shift {shift} "
                              f"{rounding}", got,
                              kq.matmul_q7_plain(ad, bd, shift, rounding))
                if small:
                    require_equal(f"matmul_q7 {(M, K, N)} vs plain on cpu",
                                  got, kq.matmul_q7_plain(a, b, shift,
                                                          rounding))
            got = counted_route(kw.w8a8_matmul, plan.route,
                                lambda: ops.w8a8_matmul(ad, bd, shd,
                                                        rounding))
            require_equal(f"w8a8_matmul {(M, K, N)} {rounding}", got,
                          kw.w8a8_matmul_plain(ad, bd, shd, rounding))
            if small:
                require_equal(f"w8a8_matmul {(M, K, N)} vs plain on cpu",
                              got, kw.w8a8_matmul_plain(a, b, sh, rounding))
        if (M, K, N) in (WRAP_SHAPE, WRAP_RETURN_SHAPE):
            # one block per tile walks all of K: the int32 sum wraps inside
            # wgmma's accumulators (a check launch, not counted)
            one = kq.GemmPlan("wgmma", (kq.TILE_M, 128), 1)
            for shift in (0, 20, 31):
                require_equal(f"matmul_q7 {(M, K, N)} shift {shift} on "
                              f"{one}", kq._launch(ad, bd, shift, "floor",
                                                   one)[0],
                              kq.matmul_q7_plain(ad, bd, shift))
            require_equal(f"w8a8_matmul {(M, K, N)} on {one}",
                          kw._launch(ad, bd, shd, "nearest", one)[0],
                          kw.w8a8_matmul_plain(ad, bd, shd))
    a, b, _ = gemm_operands(33, 70, 17, g)
    for rounding in ROUNDINGS:
        for shift in range(-40, 41):
            require_equal(f"matmul_q7 shift {shift} {rounding}",
                          ops.matmul_q7(a.to(dev), b.to(dev), shift,
                                        rounding),
                          kq.matmul_q7_plain(a, b, shift, rounding))
    log(f"[library] matmul_q7 and w8a8_matmul bit-exact at {GEMM_SHAPES} "
        f"(K = 140,000 wraps int32; K = 265,296 wraps and comes back; both "
        f"also on one wgmma block per tile), both roundings, each call on "
        f"the route gemm_plan named; matmul_q7 at every shift in [-40, 40]")

    # misaligned operands: a contiguous view 1 byte past a 16-byte
    # boundary takes the mma.sync route; a[:, 1:] of [M, K + 1] is not
    # contiguous, and the wrapper copies it into an aligned [M, K]
    M, K, N = 4096, 784, 64
    a, b, sh = gemm_operands(M, K + 1, N, g)
    b = b[1:]
    buf = torch.zeros(M * K + 16, dtype=torch.int8, device=dev)
    for offset in (1, 16):
        view = buf[offset:offset + M * K].view(M, K)
        view.copy_(a[:, 1:])
        route = "mma.sync" if offset == 1 else "wgmma"
        got = counted_route(kq.matmul_q7, route,
                            lambda: ops.matmul_q7(view, b.to(dev), 9))
        require_equal(f"matmul_q7 A at byte offset {offset}", got,
                      kq.matmul_q7_plain(a[:, 1:], b, 9))
        got = counted_route(kw.w8a8_matmul, route, lambda: ops.w8a8_matmul(
            view, b.to(dev), sh.to(dev)))
        require_equal(f"w8a8_matmul A at byte offset {offset}", got,
                      kw.w8a8_matmul_plain(a[:, 1:], b, sh))
    sliced = a.to(dev)[:, 1:]
    require_equal("matmul_q7 a[:, 1:]", ops.matmul_q7(sliced, b.to(dev), 9),
                  kq.matmul_q7_plain(a[:, 1:], b, 9))
    log(f"[library] A 1 byte past a 16-byte boundary ({M}x{K}): route "
        f"mma.sync, bit-exact; 16 bytes past: route wgmma; a[:, 1:] of "
        f"[{M}, {K + 1}]: {gemm_route(sliced, b.to(dev))}, bit-exact")

    Bt, M, K, N = BMM_SHAPE
    a = torch.randint(-128, 128, (Bt, M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-128, 128, (Bt, K, N), generator=g, dtype=torch.int8)
    ad, bd = a.to(dev), b.to(dev)
    route = kq.plan_for(ad, bd).route
    for rounding in ROUNDINGS:
        require_equal(f"bmm_q7 {BMM_SHAPE} {rounding}",
                      counted_route(kq.bmm_q7, route, lambda: ops.bmm_q7(
                          ad, bd, 13, rounding)),
                      kq.bmm_q7_plain(a, b, 13, rounding))
    log(f"[library] bmm_q7 bit-exact at {BMM_SHAPE}, both roundings, one "
        f"call each: {gemm_route(ad, bd)} (the batch on a 3-D tensor map)")

    sq_err = 0.0
    for key, shape, dt, view in squash_float_cases():
        s = squash_float_input(shape, dt, g, dev, view)
        plan = ks.squash_float_plan(s.shape[-1], s.element_size(),
                                    s.stride(0), s.data_ptr())
        if view and plan.path != "element":
            raise AssertionError(f"squash_float {key} planned on {plan}")
        n0 = ks.squash_float.launches
        got = ops.squash_float(s)
        if ks.squash_float.launches != n0 + 1:
            raise AssertionError(f"squash_float {key}: "
                                 f"{ks.squash_float.launches - n0} launches")
        rows = SQUASH_FLOAT_CHECK_ROWS if shape[0] > 1 << 22 else shape[0]
        # float32: rsqrtf and torch's rsqrt may round differently, and
        # lanes add a row's squares in another order; 16-bit types:
        # float32 results that far apart may round one ulp apart
        rtol = {"float32": 1e-6, "bfloat16": 2.0 ** -7,
                "float16": 2.0 ** -10}[dt]
        err = within(f"squash_float {key}", got[:rows],
                     ks.squash_float_plain(s[:rows]), rtol, 1e-6)
        if dt == "float32":
            sq_err = max(sq_err, err)
        log(f"[library] squash_float {key}: one launch, path {plan.path} "
            f"({plan.lanes} lane(s) a row, {plan.chunks}); max |kernel - "
            f"plain| {err:.3g} on {'all' if rows == shape[0] else rows} "
            f"rows (rtol {rtol:.3g}, atol 1e-06)")
        del s, got
    return {"q7_matmul": 0, "w8a8_matmul": 0, "squash_float": sq_err}


def gemm_bound(M: int, K: int, N: int, extra_bytes: int = 0):
    bytes_ms = (M * K + K * N + M * N + extra_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * M * K * N / INT8_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def int_mm_ms(a, b, timer=None):
    """The time of torch._int_mm (cuBLASLt int8 x int8 -> int32, the
    product alone) by `timer` (cuda_ms when None) where it takes the shape
    (M > 16, K and N multiples of 8), else None.  A yardstick only: the
    port never calls it."""
    import torch
    M, K = a.shape
    N = b.shape[1]
    if M <= 16 or K % 8 or N % 8:
        return None
    try:
        return (timer or cuda_ms)(lambda: torch._int_mm(a, b))
    except RuntimeError as e:             # a layout cuBLASLt refuses
        log(f"[time] torch._int_mm {(M, K, N)} refused: {e}")
        return None


def int_mm_device_ms(a, b):
    return int_mm_ms(a, b, lambda fn: device_ms(fn, None, calls=20))


def time_library(dev, card: str) -> dict:
    """Kernel, plain, bound and yardstick times at every phase-6 shape;
    returns the JSON record's entries of the three library kernels."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import q7_matmul as kq
    from repro_torch.kernels import squash as ks
    from repro_torch.kernels import w8a8_matmul as kw
    g = torch.Generator().manual_seed(SEED + 2)
    rows = {"q7_matmul": [], "w8a8_matmul": [], "squash_float": []}
    for (M, K, N) in GEMM_SHAPES:
        a, b, sh = (t.to(dev) for t in gemm_operands(M, K, N, g))
        yard = int_mm_ms(a, b)
        for name, fn, plain, extra in (
                ("q7_matmul", lambda: ops.matmul_q7(a, b, 13),
                 lambda: kq.matmul_q7_plain(a, b, 13), 0),
                ("w8a8_matmul", lambda: ops.w8a8_matmul(a, b, sh),
                 lambda: kw.w8a8_matmul_plain(a, b, sh), 4 * N)):
            bound, by = gemm_bound(M, K, N, extra)
            rows[name].append(dict(shape=[M, K, N], ms=cuda_ms(fn),
                                   plain_ms=cuda_ms(plain, iters=10),
                                   bound_ms=bound, bound_by=by,
                                   int_mm_ms=yard, plan=gemm_route(a, b)))
    Bt, M, K, N = BMM_SHAPE
    a = torch.randint(-128, 128, (Bt, M, K), generator=g,
                      dtype=torch.int8).to(dev)
    b = torch.randint(-128, 128, (Bt, K, N), generator=g,
                      dtype=torch.int8).to(dev)
    bound, by = gemm_bound(Bt * M, K, N, (Bt - 1) * K * N)
    rows["q7_matmul"].append(dict(
        shape=list(BMM_SHAPE), ms=cuda_ms(lambda: ops.bmm_q7(a, b, 13)),
        plain_ms=cuda_ms(lambda: kq.bmm_q7_plain(a, b, 13), iters=10),
        bound_ms=bound, bound_by=by, int_mm_ms=None,
        plan=gemm_route(a, b)))
    for key, shape, dt, view in squash_float_cases():
        s = squash_float_input(shape, dt, g, dev, view)
        bound, by = squash_float_bound(shape, dt, view)
        rows["squash_float"].append(dict(
            shape=list(s.shape), dtype=dt, key=key,
            ms=cuda_ms(lambda: ops.squash_float(s)),
            plain_ms=cuda_ms(lambda: ks.squash_float_plain(s), iters=10),
            bound_ms=bound, bound_by=by, int_mm_ms=None))
        del s
    for name, rs in rows.items():
        for r in rs:
            yard = "n/a" if r["int_mm_ms"] is None \
                else f"{r['int_mm_ms']:.4f} ms"
            what = r.get("key", f"{r['shape']} {r.get('dtype', 'int8')}")
            if "plan" in r:
                what += f" ({r['plan']})"
            log(f"[time] {card} | {name} {what}: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
                f"torch._int_mm yardstick {yard}")
    head = {"q7_matmul": list(HEADLINE_GEMM),
            "w8a8_matmul": list(HEADLINE_GEMM),
            "squash_float": list(SQUASH_FLOAT_SHAPES[0][0])}
    out = {}
    for name, rs in rows.items():
        top = next(r for r in rs if r["shape"] == head[name])   # the first
        out[name] = dict(top, shapes=rs)
    return out


def cluster_device_times(dev) -> dict:
    """routing_q7's profiler device time at the MNIST geometry for every
    bucket B and every cluster size, forced: what cluster_size's choice
    is measured by."""
    import torch
    from repro_torch.kernels import routing as kr
    g = torch.Generator().manual_seed(SEED + 4)
    out = {}
    for B in BUCKETS:
        u = torch.randint(-128, 128, (B,) + MNIST_ROUTING, generator=g,
                          dtype=torch.int8).to(dev)
        out[B] = {cs: device_ms(lambda: kr.routing_q7(u, cs=cs, **MNIST_LIKE),
                                KERNEL_NAMES["routing_q7"])
                  for cs in kr.CLUSTER_SIZES}
    return out


def log_device_times(card: str, dt: dict) -> None:
    for name in ("routing_q7", "squash_q7"):
        for B, ms in dt[name].items():
            shape = [B, *MNIST_ROUTING] if name == "routing_q7" \
                else [B * 1024, 4]
            log(f"[device] {card} | {name} {shape}: {ms:.5f} ms")
    for name in ("q7_matmul", "w8a8_matmul"):
        for key, ms in dt[name].items():
            dims = [int(d) for d in key.split("x")]
            if len(dims) == 4:                       # bmm_q7 (B, M, K, N)
                bound, by = gemm_bound(dims[0] * dims[1], dims[2], dims[3],
                                       (dims[0] - 1) * dims[2] * dims[3])
            else:
                extra = 4 * dims[2] if name == "w8a8_matmul" else 0
                bound, by = gemm_bound(*dims, extra)
            yard = dt["int_mm"].get(key)
            yard = "n/a" if yard is None else f"{yard:.5f} ms"
            split = ", ".join(
                f"{k.split('(')[0].split('<')[0].split('::')[-1]} "
                f"{v:.5f}" for k, v in dt["parts"][f"{name} {key}"].items())
            log(f"[device] {card} | {name} {key}: {ms:.5f} ms, every kernel "
                f"of the call ({split}); bound {bound:.6f} ms ({by}); "
                f"torch._int_mm yardstick {yard}")
    floor = dt["squash_float_floor"]
    log(f"[device] {card} | squash_float empty kernel (launch floor): "
        + ("n/a on this tree" if floor is None else f"{floor:.5f} ms"))
    for key, shape, dtype, view in squash_float_cases():
        ms = dt["squash_float"][key]
        bound, by = squash_float_bound(shape, dtype, view)
        vs_floor = "" if floor is None else f", {ms / floor:.2f}x the floor"
        log(f"[device] {card} | squash_float {key}: {ms:.5f} ms, every "
            f"kernel of the call; bound {bound:.6f} ms ({by}), "
            f"{bound / ms:.1%} of it{vs_floor}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--device-times"], ["--forward-worker"]) and (
            len(argv) != 2 or argv[0] != "--forward-pairs"):
        print("usage: chip_smoke.py [--device-times | --forward-pairs "
              "PARENT_TREE]", file=sys.stderr)
        return 2
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
    if argv[:1] == ["--forward-pairs"]:
        card = card_line()
        forward_pairs(Path(argv[1]).resolve(), card)
        log(card)
        return 0
    from repro_torch.kernels import build
    from repro_torch.kernels import q7_matmul as kq
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.kernels import w8a8_matmul as kw
    from repro_torch.nn.backend import get_backend
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
        text = entry["ptxas"]
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill stores", text))
        log(f"[build] {name}: {len(regs)} kernels, at most "
            f"{max(regs, default=0)} registers a thread, {spills} bytes of "
            f"spill stores")
        for line in text.splitlines():
            if any(w in line for w in ("error", "arning",
                                       "Performance Loss")):
                log(f"[build] {name}: {line.strip()}")
    if argv == ["--device-times"]:
        dt = device_times(dev)
        log_device_times(card, dt)
        log(card)
        log(json.dumps({"device_times": dt}))
        return 0
    if argv == ["--forward-worker"]:
        forward_worker(dev)
        return 0

    for name in ("q7_matmul", "w8a8_matmul"):
        sass = sass_counts(libs[name])
        log(f"[build] {name}: SASS holds {sass['IGMMA']} IGMMA (wgmma) and "
            f"{sass['IMMA']} IMMA (mma.sync) instructions")
        if min(sass.values()) == 0:
            raise AssertionError(f"{name}: a main loop lost its tensor-core "
                                 f"instruction: {sass}")

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
    fallbacks = get_backend("cuda").fallbacks
    if sum(fallbacks.values()) != 0:
        raise AssertionError(f"default-variant mnist@cuda fell back: "
                             f"{dict(fallbacks)}")

    # phase 4: the artifact path, counted on its own
    artifact = serve_artifact(run, dev)

    # phase 5
    serve_other(dev, "smallnorb@cuda")
    serve_other(dev, "cifar10@cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        serve_other(dev, "edge_tiny@cuda", softmax_impl="approx")
        n0 = fallbacks[("routing.softmax", "approx")]
        if n0 == 0:
            raise AssertionError(f"edge_tiny@cuda approx: no routing.softmax "
                                 f"fallback counted ({dict(fallbacks)})")
        rc = serve_caps.main(["--model", "mnist@cuda", "--softmax", "approx",
                              "--requests", str(N_OTHER)])
        if rc != 0 or fallbacks[("routing.softmax", "approx")] == n0:
            raise AssertionError(f"serve_caps --model mnist@cuda --softmax "
                                 f"approx: exit {rc}, fallbacks "
                                 f"{dict(fallbacks)}")
    log(f"[other] cuda backend fallbacks {dict(fallbacks)}; "
        f"{len(caught)} warning(s): "
        f"{sorted({str(w.message)[:60] for w in caught})}")

    # phase 6: counts from 0 just before the library path, read just after
    kq.matmul_q7.launches = kq.bmm_q7.launches = 0
    kw.w8a8_matmul.launches = ks.squash_float.launches = 0
    kq.transpose_kn.launches = 0
    for fn in (kq.matmul_q7, kq.bmm_q7, kw.w8a8_matmul):
        fn.launches_by_route = dict.fromkeys(kq.ROUTES, 0)
    errs.update(drive_kernel_library(dev))
    launches.update(q7_matmul=kq.matmul_q7.launches + kq.bmm_q7.launches,
                    w8a8_matmul=kw.w8a8_matmul.launches,
                    squash_float=ks.squash_float.launches)
    log(f"[library] launches over the kernel-library path: matmul_q7 "
        f"{kq.matmul_q7.launches} {kq.matmul_q7.launches_by_route}, bmm_q7 "
        f"{kq.bmm_q7.launches} {kq.bmm_q7.launches_by_route}, w8a8_matmul "
        f"{launches['w8a8_matmul']} {kw.w8a8_matmul.launches_by_route}, "
        f"squash_float {launches['squash_float']}; transposes of B "
        f"{kq.transpose_kn.launches}")
    for fn in (kq.matmul_q7, kw.w8a8_matmul):
        if min(fn.launches_by_route.values()) == 0:
            raise AssertionError(f"{fn.__name__} left a route unused: "
                                 f"{fn.launches_by_route}")
    for name in ("q7_matmul", "w8a8_matmul", "squash_float"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the "
                                 f"kernel-library path")

    # phase 7
    times = time_kernels(run, dev)
    from repro_torch.serving import serve_window
    sides = {"mnist@cuda": (run["registry"], "mnist@cuda", run["engine"]),
             "its .capsbin, installed": (artifact["registry"],
                                         artifact["model_id"],
                                         artifact["engine"])}
    rates = {what: [] for what in sides}
    for rnd in range(SERVE_ROUNDS):
        for what, (reg, mid, eng) in sides.items():
            if rnd:         # round 0: the counted windows of phases 3, 4
                eng, _, _ = serve_window(reg, BUCKETS,
                                         run["images"][:N_REQUESTS], mid)
            m = eng.metrics.summary()
            rates[what].append(m["images_per_s"])
            log(f"[serve] {card} | {what}, window {rnd + 1}: {N_REQUESTS} "
                f"requests, buckets {BUCKETS}: {m['images_per_s']:.1f} "
                f"img/s, p50 {m['p50_ms']:.3f} ms, p99 {m['p99_ms']:.3f} "
                f"ms, {m['waves']} waves")
    log(f"[serve] {card} | img/s over {SERVE_ROUNDS} alternating windows: "
        + "; ".join(f"{what} {min(r):.1f}-{max(r):.1f}"
                    for what, r in rates.items()))
    for name, t in times.items():
        log(f"[time] {card} | {name} {t['shape']}: kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}); no single PyTorch call computes it, so "
            f"library_ms is null")

    times.update(time_library(dev, card))

    # phase 9, before phase 8: a torch.profiler session leaves the later
    # launches of the process slower, and phase 9 times the host's path
    traced_serving(run, card)
    obs_clis(run, dev, card)
    serve_widened_geometries(dev, card)
    probes_off_times(run, dev, card)
    busy_share(run, card)

    # phase 8: device times from the profiler, and each cluster size
    dt = device_times(dev)
    log_device_times(card, dt)
    for B, row in cluster_device_times(dev).items():
        log(f"[device] {card} | routing_q7 [{B}, 10, 1024, 6] by cluster "
            f"size: " + ", ".join(f"cs={cs} {ms:.5f} ms"
                                  for cs, ms in row.items())
            + f" (wrapper picks {kr.cluster_size(B, *MNIST_ROUTING)})")
    for name in ("routing_q7", "squash_q7"):
        times[name]["device_ms"] = dt[name][B_TIMED]
    times["squash_float"]["device_ms"] = dt["squash_float"][
        squash_float_cases()[0][0]]
    for row in times["squash_float"]["shapes"]:
        row["device_ms"] = dt["squash_float"][row["key"]]
    times["squash_float"]["floor_device_ms"] = dt["squash_float_floor"]
    for name in ("q7_matmul", "w8a8_matmul"):
        times[name]["device_ms"] = dt[name][shape_key(HEADLINE_GEMM)]
        for row in times[name]["shapes"]:
            row["device_ms"] = dt[name][shape_key(row["shape"])]
            row["int_mm_device_ms"] = dt["int_mm"].get(
                shape_key(row["shape"]))

    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"squash_q7": ("squash_q7.cu", "src/repro/kernels/squash.py:50"),
               "routing_q7": ("routing_q7.cu",
                              "src/repro/kernels/routing.py:90"),
               "q7_matmul": ("q7_matmul.cu",
                             "src/repro/kernels/q7_matmul.py:51"),
               "w8a8_matmul": ("w8a8_matmul.cu",
                               "src/repro/kernels/w8a8_matmul.py:47"),
               "squash_float": ("squash_float.cu",
                                "src/repro/kernels/squash.py:75")}
    record = {"kernels": []}
    for name, (src, replaces) in sources.items():
        t = times[name]
        entry = {"name": name, "route": "cuda", "source": csrc + src,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": errs[name], "ms": t["ms"],
                 "device_ms": t["device_ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": None,
                 "library_note": "no single PyTorch call computes this "
                 "function", "shape": t["shape"]}
        if name in artifact["launches"]:
            entry["launches_by_path"] = {
                "main": launches[name],
                "artifact": artifact["launches"][name]}
        if "shapes" in t:
            entry["shapes"] = t["shapes"]
            entry["yardstick"] = (
                "int_mm_ms: torch._int_mm, cuBLASLt's int8 x int8 -> int32 "
                "product alone (no shift epilogue), where it takes the "
                "shape; the port never calls it")
        record["kernels"].append(entry)
    log("kernels: " + ", ".join(f"{k['name']} x{k['launches']}"
                                for k in record["kernels"]))
    log(f"[done] every phase passed in {time.perf_counter() - t0:.1f} s, "
        f"the build included")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
