#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --device-times   # phase 1, phase 8's times and
                                           # the W8A8 faces' [device] lines
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 chip_smoke.py --train-lm
                                           # phase 16 alone
    python3 chip_smoke.py --multi          # the build, then phase 18 alone
    python3 chip_smoke.py --tp             # the build, then phase 19 alone
    python3 chip_smoke.py --tp-count       # phase 19's steps dry-run (JSON)
    python3 chip_smoke.py --examples       # the build, then phase 20 alone
    python3 chip_smoke.py --train-times    # phase 10's MNIST step times
                                           # and peak memory, no build
    python3 chip_smoke.py --forward-pairs PARENT_TREE

(`--device-times` and `--train-times` run on an older tree too: copy
this script into a `git archive` of it to time it in the same call.
`--forward-pairs` copies this script into PARENT_TREE, an unpacked
`git archive` of another commit, starts two `--forward-worker`
processes in each tree, and times the untraced B=64 forward_q7 of all
four in 40 rounds of 50 calls each, printing each side's median and the
median per-round difference beside its quartiles and beside the
difference between the two workers of one side.)

Phases, each raising on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   `repro_torch.analysis.repolint` over src/repro_torch (no JAX on this
   host; any finding fails, a `[repolint] clean: ...` line), and the
   nvcc build of every kernel in src/repro_torch/kernels/csrc;
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
   QuantCapsNet on the `torch` backend, on the card and on the CPU; the
   squash, routing and conv kernels' launch counts over that run must be
   > 0, the conv's 2 a wave (twice the squash's, one a wave); then the
   command `serve_caps --model mnist@cuda --requests 128` runs, with its
   own counts, held to the same;
4. the artifact path: `ModelRegistry.export("mnist@cuda", build/edge_smoke)`
   writes the `.capsbin`, its manifest and the `.c`/`.h` (VM-verified on
   4 images); the reloaded file `same_as` the lowered program, and
   `lower(to_qnet(p))` `same_as` p; `install_artifact` puts it on the
   card and it serves the burst's 128 requests on the `cuda` backend,
   its kernel counts from 0: every completion must equal the live
   model's, the first 16 the port's EdgeVM on the CPU, the three
   kernels' counts must be > 0, the conv's 2 a wave, and
   `CudaBackend.fallbacks` must not move; then
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
   > 0 (the conv kernel's 2 a wave under the probe too), its trace, metrics and numerics doc read back by
   `python -m repro_torch.obs.analyze` (`--gate-clips`), the doc holding
   0 int32 clips and contained in the static bounds; `export_caps
   --model mnist@cuda --numerics --drift` exits 0 and `costmodel_drift`
   joins every op; 16 requests each of `edge_tiny@cuda` with
   pcap_dim=18, caps_dim=20 and routings=9 (past the kernels' former
   limits of capsule dim 16 and 8 iterations) bit-identical to the
   `torch` backend, both kernels launched for each and no fallback
   counted; the untraced, unprobed B=64 forward_q7 (7 x 50 calls)
   beside a probed one, and untraced beside traced serving img/s in
   turns;
10. (run between phases 7 and 9) training, `repro_torch.captrain`:
   MNIST "L" at full size, `TrainConfig(dataset="mnist", batch=64,
   microbatches=8)`, 8 float steps (finite losses, the last below the
   first) and 4 QAT steps on a derived plan, then each `train_step`
   timed (median of 10, CUDA events: `[train] ... train_step_float_mnist`
   and `train_step_qat_mnist`, in us a step and img/s, with the device
   memory a step peaks at above what was allocated before); the steps must
   launch none of the port's kernels; a checkpoint of that state, saved
   and restored in a fresh trainer (`resume_or_init`), must give the
   uninterrupted run's next step bit for bit, in loss and every leaf,
   once in float and once in QAT with the plan side-car; the EDGE_TINY
   Table-2 row, `table2_rows(EDGE_TINY, TrainConfig(dataset="edge_tiny",
   batch=32, microbatches=8, calib_n=32, lr=3e-3, recalib_every=20),
   float_steps=120, qat_steps=40, eval_n=256, roundings=("floor",))`,
   printed, with acc_f32 > 0.8 and saving_pct >= 70 required and
   delta_qat beside delta_ptq (not ordered); the same QAT model trained
   again, quantized on the `cuda` backend, its `eval_q7` equal on `cuda`
   and `torch`, 16 requests served bit-identical to the `torch` backend
   with both kernels launched (counts from 0 just before) and no
   fallback counted, and exported as a `.capsbin` into build/train_smoke/
   with the export's re-verify passing.
11. (run after phase 10, before phase 9) the search,
   `repro_torch.search`: `run_search(SearchConfig(model="edge_tiny"))` at
   the CLI's defaults (coordinate, budget 24, 60 float steps, 256 eval
   images, seed 0) twice, and the random strategy at budget 12 twice,
   each pair's saved docs byte-identical; then MNIST "L" at full width,
   `SearchConfig(model="mnist")`, both kernels' launch counts from 0
   just before and > 0 just after: a non-empty frontier, every point
   verified and checked with no checker finding and a plan, no
   dominated pair, no int32 clip in an accepted candidate; every
   accepted default-variant candidate (the ones whose SNR pass and
   eval_q7 launched the kernels in the search) rebuilt on the card with
   its eval_q7 over the 256 eval images equal on `cuda` and `torch` and
   to the doc's acc, and its v_q equal at B=64 and B=256, both kernels
   counted from 0 over that comparison and no fallback; every frontier
   point rebuilt (`rebuild_point`) with the doc's plan, a clean
   plancheck and the doc's acc; the CLIs as subprocesses into
   build/search_smoke/: `search_caps --model mnist` exits 0 with a doc
   byte-identical to the in-process one, `export_caps --from-search ...
   --point 0` (and `--point K` for the first default-variant point K
   when it is another) exits 0 and exits 2 on a copy whose point-0 plan
   has conv0's out_shift changed; the exported point 0 installed on the
   card serves 64 requests on the `cuda` backend bit-identical to the
   rebuilt point on the `torch` backend, its launches and fallbacks as
   its variants promise; and a default-variant result (point K's
   `.capsbin`, else the baseline spec exported in process) installed
   and served the same way with both kernels launched and no fallback.
   `[search]` lines print each search's setup seconds, candidates
   evaluated and rejected by reason, the median and max
   `search.evaluate`, the median `edgevm.run` (the EdgeVM on the host)
   a candidate and its share of `search.evaluate` (spans), one
   eval_q7 on each backend (CUDA events), `search.frontier` and the
   total, the fallback decisions by (op, variant), the frontier's size,
   the baseline's and best point's acc, packed flash and est. M7 ms,
   and whether a point dominates the baseline's memory or latency
   within 0.5 % accuracy (printed, not gated).
12. (run after phase 11, before phase 9) the LM serving path,
   `repro_torch.launch.serve` on `repro_torch.models`, with every earlier
   phase's tensors freed first: `w8a8_dense` bit for bit against its
   plain version (bf16 out) at every product (K, N) of the three W8A8
   configs served below, read off their param trees (qwen3_14b: (5120,
   6144), (5120, 1024), (6144, 5120), (5120, 17408), (17408, 5120),
   (5120, 152064); gemma3_12b: d 3840, lm_head N 262144; stablelm_3b: d
   2560, d_ff 6912, vocab 50432 padded), for M = 8 (a decode step) and
   512 (a prefill of 8 x 64), a ragged (7, 100, 33) on mma.sync, a
   (4, 2048, 8) of one tile cut between blocks, and M = 1, 8, 16, 64 and
   65 at qwen3_14b's (17408, 5120) (both sides of the small-M switch to
   the stream-K schedule), W stored K-major as the port's W8A8 leaf
   holds it, one `[lm]` line each with its configs, route, tile and
   schedule; qwen3_14b at full width and
   depth (40 layers, 15.19 B parameters) serving 8 requests x 64 prompt
   tokens for 32 greedy tokens, float then W8A8, finite logits required,
   `w8a8_dense` counted from 0 just before the W8A8 run and required to
   launch exactly 281 x 32 = 8,992 times (7 products x 40 blocks +
   lm_head, per forward, 1 prefill + 31 decode steps), the float run's
   decode after prefill(64) held against prefill(65) within the CPU
   tests' atol 0.15 + rtol 0.05, and the share of greedy tokens W8A8
   and float agree on printed; every W8A8 run of phases 12-15 must
   launch no `transpose_kn` (counted before and after it: W is stored
   K-major); gemma3_12b at full width, one pattern
   cycle (5 SWA + 1 global layer, its SWA caches a ring of 512 slots),
   float (consistency gated) and W8A8 (printed); paligemma_3b at full
   width and depth with its 256 zero image embeds, float, its
   consistency held to the same tolerance with at most 8 logits beyond
   it and none more than 0.25 off, and a float32 copy of its params
   (the witness) required to pass the tolerance with none beyond, each
   bf16 path's distance from the witness printed (stablelm_3b in full
   is served in bf16 and W8A8 by phase 20's `torch_serve_quantized_lm`);
   qwen2_72b in full (80 layers, 145.42 GB of bf16: over the card) in
   W8A8 alone, its int8 tree drawn one cycle at a time
   (`lm_quant.init_quantized`), `w8a8_dense` at each of its products
   above, counted from 0 and required to launch exactly 17,952 times,
   finite logits, its consistency printed, its peak printed beside its
   int8 tree's GiB and the card's, then the same through `python -m
   repro_torch.launch.serve --arch qwen2_72b --no-reduce --quant w8a8`;
   `serve_caps --model mnist@cuda --requests 128 --mesh host` exits 0
   printing `mesh={'pod': 1, 'model': 1, 'data': 1}` with both kernels
   launched, and waves bound under the host mesh equal waves without one
   at every bucket; `[lm]` lines hold prefill ms, decode ms a step, tok/s,
   parameter MiB and peak device GiB of each run beside the card's name
   and power limit, and `[time]`/`[device]` lines `w8a8_dense` at (8,
   17408, 5120) and (512, 5120, 17408) beside its plain version, its
   bound, its share of the bound and `torch._int_mm`, and a `[library]`
   line of each shape's plan (on the stream-K schedule, the blocks'
   shares of iterations and of W's bytes, and their spread).
13. (run after phase 12, before phase 9) the MoE FFN,
   `repro_torch.models.moe` with `lm_quant.q_einsum` on `w8a8_bmm`, the
   batched face of `w8a8_dense`, with every earlier phase's tensors
   freed first: `w8a8_bmm` bit for bit against its plain version (bf16
   out) at every expert product of phi35_moe (E 16: (4096, 6400),
   (6400, 4096)) and mixtral_8x22b (E 8: (6144, 16384), (16384, 6144)),
   read off their param trees, at M = C = 4 (a decode step of 8 rows,
   one group) and M = 8 C = 96 / 160 (a prefill of 8 x 64, a group a
   row), on the route gemm_plan picks and on the other one (forced),
   plus a ragged (3, 7, 100, 33) on mma.sync and a split-K (4, 4, 2048,
   8), every expert with exponents of its own (the plain product with
   expert 0's exponents everywhere must differ); phi35_moe at full width
   cut to 16 of its 32 layers (its bf16 tree is 83.6 GB at 32) and
   mixtral_8x22b at full width cut to 4 of 56 (its SWA caches a ring of
   512 slots), each serving 8 requests x 64 prompt tokens for 32 greedy
   tokens, float then W8A8, finite logits required, `w8a8_bmm` and
   `w8a8_dense` counted from 0 just before each W8A8 run and required to
   launch exactly 3 x L x 32 and (4 x L + 1) x 32 times (phi35_moe:
   1,536 and 2,080); the float decode after prefill(64) held against
   prefill(65) within atol 0.15 + rtol 0.05 on the rows whose compared
   token kept every top-k assignment at every MoE layer on both sides
   (found by wrapping `models.moe.moe_apply` for those forwards), at the
   configs' capacity factor and at E / k (where nothing can drop), the
   gated and set-aside rows printed, failing if no row was gated (W8A8
   printed only); `python -m repro_torch.launch.serve --arch phi35_moe
   --quant w8a8 --d-model 1024 --requests 8 --prompt-len 64 --gen 32`
   exits 0; `w8a8_dense` at phi35_moe's products; at 16 layers the W8A8
   tree drawn one cycle at a time on the card's generator equal to
   `quantize_lm_params` of the whole float tree leaf for leaf; phi35_moe
   in full (32 layers) in W8A8 alone, 3,072 `w8a8_bmm` and 4,128
   `w8a8_dense` launches required, its MoE consistency and gated rows
   printed, its peak beside its int8 tree's GiB; `[moe]` lines hold prefill ms, decode ms a step, tok/s,
   parameter MiB, peak device GiB and the assignments each layer drops
   at a prefill, beside the card's name and power limit; `[time]` and
   `[device]` lines `w8a8_bmm` at (16, 4, 4096, 6400) and (16, 96, 4096,
   6400) beside its plain version, its bound, its share of the bound and
   (at the second) 16 calls of `torch._int_mm`, and their `[library]`
   plan lines.
14. (run after phase 13, before phase 9) the SSM and hybrid LMs,
   `repro_torch.models.{mamba,xlstm}` (plain torch: the recurrences are
   Python loops over time, as the reference's are `lax.scan`s, not
   Pallas), with every earlier phase's tensors freed first:
   `w8a8_dense` bit for bit at every product of xlstm_1_3b and of
   jamba_v01_52b (read off their param trees; M 8 and 512) and
   `w8a8_bmm` at jamba's expert products (E 16: (4096, 14336), (14336,
   4096); M 4 and 96, both routes); xlstm_1_3b in full (48 layers, 7
   mLSTM : 1 sLSTM) and jamba_v01_52b at full width cut to one 8-layer
   cycle (7 mamba : 1 attention, MoE every other layer; 51.57 B
   parameters in full, 103 GB of bf16), each serving 8 requests x 64
   prompt tokens for 32 greedy tokens, float then W8A8, finite logits
   required, `w8a8_dense` and `w8a8_bmm` counted from 0 just before each
   W8A8 run and required to launch exactly 229 x 32 = 7,328 (xlstm) and
   31 x 32 = 992 and 12 x 32 = 384 (jamba) times; the float decode after
   prefill(64) held against prefill(65) within atol 0.15 + rtol 0.05
   (xlstm: its bf16 paths drift apart layer by layer, 0.30 at 48
   layers, as the reference's own do, `tools/xlstm_drift.py`, so at
   most 1,250 logits beyond it, none more than 0.35 off, argmax equal on
   every row, a float32 copy of its params with none beyond, and the
   same check with the mLSTM's C or m or the sLSTM's state kept in bf16
   required to fail that gate; jamba:
   `moe_consistency`'s gated rows at capacity factor 1.25 and at E / k,
   failing if none is gated); jamba_v01_52b in full (32 layers, 4
   cycles) in W8A8 alone, 3,872 `w8a8_dense` and 1,536 `w8a8_bmm`
   launches required, its peak beside its int8 tree's GiB; `[ssm]` lines
   hold prefill ms, decode ms a step, tok/s, parameter MiB and peak
   device GiB of each run beside the card's name and power limit.
15. (run after phase 14, before phase 9) the encoder-decoder,
   `models.transformer.EncDecLM`: `w8a8_dense` bit for bit at every
   product of seamless_m4t_medium (its lm_head N 256,256); the config in
   full (12 encoder and 12 decoder layers) serving as phase 14 does, on
   the zero frame embeddings `launch.serve` gives it, `w8a8_dense`
   required to launch exactly 217 + 109 x 31 = 3,596 times (the encoder
   and the cross K/V projections at the prefill only); its float decode
   held against prefill(65) on random frames; `python -m
   repro_torch.launch.serve --arch seamless_m4t_medium --no-reduce
   --quant w8a8 --requests 8 --prompt-len 64 --gen 32` exits 0
   (`[encdec]` lines).  After phase 9 (its `torch.profiler` sessions
   would slow phase 9's host timings), the device launches of one
   prefill and one decode step of each config of phases 14-15, bf16 and
   W8A8, and one xlstm_1_3b mLSTM decode layer's device time beside its
   bound (`[recurrent]` lines).
16. (run last, after phase 8) LM training
   (`launch.{train,steps}`), in a process of its own (`chip_smoke.py
   --train-lm`, with deterministic algorithms and
   CUBLAS_WORKSPACE_CONFIG=:4096:8 so that a resume can repeat its
   bits): (a) `launch.train.main` on stablelm_3b in full (32 layers, d
   2560, 2.80 B parameters), B 8 x S 256, 12 steps, no checkpoint (one
   full-size snapshot is 33.5 GB, and a chip call may write 45 GiB to
   its disk): median warm ms a step, tok/s, peak device GiB, the losses
   and grad norms, the step's bound (8 N T FLOP at the dense bf16 peak,
   beside the state's bytes); a learning check (AdamW at a constant lr
   of 1e-3, 4 steps: batch 0's loss must fall, the step timed as
   forward + backward and the in-place AdamW; the CLI's schedule warms
   up over 2,000 steps); (b) at full width cut to 2 of 32 layers, a
   straight run, then the same command with `--ckpt-every 4` and a fault
   before step 6: `run_with_restarts` rebuilds it, it resumes from step
   4, and its final params, m, v and steps must equal the straight
   run's bit for bit (three 5.0 GB checkpoints in
   `build/lm_train_smoke/`, removed after); (c) 4 steps of (a) with
   `--grad-compress` (ms a step against (a), peak GiB); (d) one step of
   each other family at `--reduce` under deterministic algorithms,
   naming any op that has no deterministic CUDA kernel (none raised on
   torch 2.11), then paligemma_3b, phi35_moe, xlstm_1_3b, jamba_v01_52b
   and seamless_m4t_medium at `--reduce` (d 256), 4 steps each with
   deterministic algorithms off: finite losses and grad norms, step 0's
   loss and grad norm within `LM_TRAIN_CPU_RTOL` of the port's CPU step
   on the same weights, and the learning check (`[train-lm]` lines).  It
   launches none of the port's kernels.
17. (run last, after phase 16) the dry run, `repro_torch.launch.dryrun`
   (every cell's real step on meta tensors under `dist.op_analysis`'s
   trip-weighted counter, on the host's CPU, no card): (a) `python -m
   repro_torch.launch.dryrun --all --mesh single` and `--mesh multi`
   ((pod 2, data 32, model 8) over 512 cards, rank 0 counted in a fake
   world), each also with `--quant`, four processes at once, into
   build/dryrun_smoke/, each exit 0 with every record `ok` or `skipped`
   with the reference's reason and every `ok` multi-card record with
   collective bytes, a `[dryrun]` line a cell (dominant term, bound ms,
   on the multi mesh the rank's collective ms over NVLink and over
   InfiniBand, GiB a card, whether it fits one card's memory) and each
   grid's seconds (target 180 s for the four, printed); (b) the cells
   this script ran on the card dry-run in process: qwen3_14b decode at
   phase 12's 8 rows and 512-slot cache, float and W8A8, and
   stablelm_3b train at phase 16's B 8 x S 256, a `[roofline]` line
   each with flops, bytes, each
   term, the bound beside the measured ms (phase 12's warm decode ms a
   step, phase 16's median step) and the share bound / measured, which
   must be at most 1.05 (a bound above the measured time means a wrong
   count); the meta-counted `w8a8_dense` calls of a W8A8 decode step
   must equal phase 12's launches a step (8,992 / 32 = 281), and the dry
   run's training GiB must lie within 25 % of phase 16's
   `torch.cuda.max_memory_allocated`.  It launches nothing and times
   nothing of its own.
18. (run last, after phase 17) data-parallel meshes across processes
   (`repro_torch.dist.world`, `[multi]` lines, the backend on each):
   (a) a gloo world of 2 ranks sharing cuda:0 (`dist.world.spawn`)
   serves one `mnist@cuda` wave at each of buckets 64, 16, 3 and 1, each
   rank building the model by PTQ on its device; every wave's v_q,
   lengths and pred on both ranks must equal the one-process wave's bit
   for bit, each rank's `routing_q7` / `squash_q7` launches (counts from
   0 just before its wave, read just after) must be > 0 where it has
   rows and 0 on bucket 1's empty share, and each rank's `forward_q7` ms
   on its 32 rows and `gather_rows` ms are printed (2 ranks sharing one
   card: not a multi-card throughput); (b) `torchrun --standalone
   --nproc-per-node 2 -m repro_torch.launch.serve_caps --model
   mnist@cuda --mesh host --requests 128` exits 0 with one report and
   the completion digest of a one-rank run; (c) in the same world,
   `CapsTrainer(MNIST, batch 64, 8 microbatches, mesh=)`, 3 float and 2
   QAT steps, losses and every state leaf equal to the one-rank run in
   each rank and in this process, then each rank's float step ms over
   the mesh and alone (both ranks stepping at once) beside the rows of
   tree sums a step gathers; (d) `compressed_psum` of CUDA tensors
   over the 2 ranks equal to its formula on the CPU; (e) a one-rank
   NCCL world's bucket-64 wave equal to (a)'s; (f) NCCL asked for 2
   ranks on the one card raises ValueError before any process group.
19. (run last, after phase 18) tensor parallelism on the model axis
   (`dist.api`'s groups and autograd Functions, the models' shard sites,
   `launch.steps.make_cell` on meshes; `[tp]` lines, every number beside
   the card's name and power limit, 2 ranks sharing one card: not a
   multi-card rate): (a) qwen3_14b at full width (d 5120) cut to 8 of
   its 40 layers (seed-0 weights), 8 requests of 64 tokens, a prefill
   into 512 slots and 32 greedy decode steps, bf16 and W8A8, first in this process (logits and
   tokens kept on the host, the card freed), then over a gloo world of 2
   ranks sharing cuda:0 whose `make_host_mesh()` puts both on the model
   axis, each drawing its shares from the seed: the logits of the
   prefill and of every step fed the one-process tokens within atol 0.15
   + rtol 0.05 in bf16, of the prefill in W8A8 (its decode steps' are
   printed: a float sum in another order moves a value across an int8
   rounding boundary, and the next products' codes follow), greedy
   tokens equal on every (row, step) without a near-tie (a top-two gap
   under twice the row's measured difference; the count printed), every
   `w8a8_dense` launch (57 a
   forward, counts from 0 just before the meshed run) bit-exact against
   its plain version on the rank's share, the activation exponent of
   every W8A8 product of the prefill equal to the one-process run's
   unless an earlier input already differed, and each rank's resident
   param bytes within 5 % of half the split leaves plus the whole
   replicated ones; each rank's prefill and warm decode ms and the
   collectives of one decode step replayed alone; (b) in the same world,
   stablelm_3b at full width cut to 2 of 32 layers, B 8 x S 256,
   deterministic algorithms: 3 make_cell train steps (losses and grad
   norms within rtol 1e-3 / 1.5e-2 of this process's steps, step ms,
   peak GiB), then from the same init a step, a sharded checkpoint
   (gathered onto rank 0, one 5.0 GB file), a fault, a restore into
   fresh shares and the last two steps, equal to the uninterrupted run
   bit for bit, and the checkpoint restored into this process equal to
   the ranks' gathered state; (c) a (data 2, model 2) world of 4 ranks
   on the card: qwen3_14b at d 256 through make_cell's train, prefill
   and 4 decode steps against the one-process steps in each rank, and
   `mnist@cuda` waves at buckets 64/16/3/1 bit-equal to the one-process
   wave, with each rank's launches.  Between (b) and (c), the dry run
   in a process of its own (`chip_smoke.py --tp-count`, a fake world of
   (a)'s mesh): each rank's `api.collective` calls of one decode step
   (bf16, W8A8) and of one train step of (b), by kind with their output
   bytes (an all-gather's input times the group's size), must equal the
   dry run's count of that rank's step, and each bound, held against
   the rank's warm decode ms a step and median train step, must give a
   share of at most 1.05 (`[roofline]` lines).

20. (run last, after phase 19) the repository's four examples on the
   port, each `examples/torch_*.py`'s `main(argv)` in this process, with
   every `routing_q7`, `squash_q7` and `w8a8_dense` launch held against its
   plain version on the same inputs (bit for bit) and the three counts from
   0 just before the first example (`[examples]` lines, each run's wall
   seconds beside the card's name and power limit): (a) `torch_quickstart`:
   MNIST "L" PTQ'd on 64 images, the `cuda` backend bit-identical to the
   `torch` oracle, 6 requests served at buckets (1, 4, 8) equal to a direct
   forward, the export re-verified, `quickstart OK`; (b)
   `torch_train_capsnet --dataset mnist`, `smallnorb`, `cifar10` at the
   reference's defaults (250 float steps, 60 QAT steps a rounding, batch
   64, 768 eval images) with `--ckpt-dir build/examples_smoke/DATASET`,
   which keeps each float run's state of step 250 for
   `tools/table2_witness.py` (that state quantized on the CPU by the
   port's oracle and by the reference): each Table-2 row's saving_pct equal to 100 (1 -
   int8 / fp32) of TABLE2_FOOTPRINTS (the CPU test's pinned bytes), acc_f32
   above twice chance, MNIST's at most 0.05 below the reference example's
   own CPU row (REF_MNIST_ACC_F32), both kernels launched by each run's
   `eval_q7`, and the seconds of table2_rows' float and QAT fits, PTQ,
   `eval_float`, `eval_q7`, `lower` and `run_numerics`; (c)
   `torch_serve_quantized_lm --arch stablelm_3b --no-reduce`: 8 requests of
   64 tokens, 24 generated, float then W8A8 from the same weights, (7 x 32
   + 1) x 24 = 5,400 `w8a8_dense` launches required, prefill and decode ms,
   agreement and peak GiB printed; (d) `torch_train_lm` at its defaults
   (~100 M parameters, B 4 x S 256, 200 steps, checkpoints into
   build/examples_smoke/, removed after), the loss required to fall, then
   `--steps 220`, which must print `[resume] step 200`; neither launches a
   kernel of the port.  Then (c) once more with the recorder off and its
   launches not counted: the prefill and decode ms a user of the example
   sees, beside the recorded run's.

The line before the last is the kernels' JSON record, the one before it
the card's name and power limit; the last line is the result.  Exits
non-zero, printing no result, without a CUDA device or without the
repository's `src/`.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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

# the H100 SXM's HBM rate and dense int8 and bf16 tensor-core rates, bound
# by main() from repro_torch.launch.roofline (HBM_BW, PEAK_INT8, PEAK_BF16)
HBM_BYTES_PER_S = INT8_OPS_PER_S = BF16_OPS_PER_S = None
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
TRAIN_DIR = ROOT / "build" / "train_smoke"
TRAIN_FLOAT_STEPS = 8              # phase 10's MNIST steps
TRAIN_QAT_STEPS = 4
TRAIN_TIMED_STEPS = 10
OBS_DIR = ROOT / "build" / "obs_smoke"
SEARCH_DIR = ROOT / "build" / "search_smoke"
SEARCH_MNIST_BUDGET = 24           # phase 11: the CLI's default
SEARCH_RANDOM_BUDGET = 12
SEARCH_SERVED = 64                 # requests of the exported point
# phase 20: the paper's three networks in full, (fp32 bytes, int8
# memory_bytes), as tests/test_torch_examples.py pins them against the
# reference's; each Table-2 row's saving_pct must be 100 (1 - int8 / fp32)
TABLE2_FOOTPRINTS = {"mnist": (1_187_200, 296_912),
                     "smallnorb": (1_182_336, 295_696),
                     "cifar10": (461_184, 115_480)}


def log(*a):
    print(*a, flush=True)


def phase_done(n: int, t0: float) -> None:
    """A `[phase]` line: phase n ended, the seconds since t0 (the run's
    start, before the build)."""
    log(f"[phase] {n} done at {time.perf_counter() - t0:.1f} s")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def repolint_port() -> None:
    """`repro_torch.analysis.repolint` over the port's sources, which
    needs no JAX: its `[repolint] clean: ...` line, or a failure."""
    from repro_torch.analysis import repolint
    if repolint.main([str(ROOT / "src" / "repro_torch")]) != 0:
        raise AssertionError("repolint: findings in src/repro_torch")


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
def conv_launches(kc) -> int:
    """The conv kernel's launches on both faces since they were zeroed."""
    return kc.conv2d_q7.launches + kc.conv2d_q7_per_channel.launches


def check_conv_launches(where: str, launches: dict, convs: int) -> None:
    """A CapsNet wave launches the squash kernel once and the conv kernel
    once a conv layer (`convs`, the primary capsules' included)."""
    if launches["conv2d_q7"] == 0 or \
            launches["conv2d_q7"] != convs * launches["squash_q7"]:
        raise AssertionError(f"{where}: launches {launches}, not {convs} "
                             f"conv launches a wave")


def serve_artifact(run, dev) -> dict:
    """Export the main path's model as an MCU artifact, install the file
    on the card and serve it: the second path through the entry points a
    user calls.  Returns the artifact's engine and its kernel counts."""
    import numpy as np
    import torch
    from repro_torch.edge import EdgeProgram, EdgeVM, lower, to_qnet
    from repro_torch.kernels import conv as kc
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
    kc.conv2d_q7.launches = kc.conv2d_q7_per_channel.launches = 0
    reg = ModelRegistry(specs={}, device=dev)
    qnet = reg.install_artifact(paths["capsbin"])
    images = run["images"][:N_REQUESTS]
    engine, done, _ = serve_window(reg, BUCKETS, images, program.name)
    launches = {"squash_q7": ks.squash_q7.launches,
                "routing_q7": kr.routing_q7.launches,
                "conv2d_q7": conv_launches(kc)}
    check_conv_launches("artifact path", launches, 2)
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
    from repro_torch.kernels import conv as kc
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
    kc.conv2d_q7.launches = kc.conv2d_q7_per_channel.launches = 0
    rc = serve_caps.main(["--model", "mnist@cuda", "--requests",
                          str(N_REQUESTS), "--trace", str(out["trace"]),
                          "--trace-summary", "--metrics-out",
                          str(out["metrics"]), "--numerics-out",
                          str(out["numerics"]), "--profile"])
    launches = {"squash_q7": ks.squash_q7.launches,
                "routing_q7": kr.routing_q7.launches,
                "conv2d_q7": conv_launches(kc)}
    if rc != 0 or min(launches.values()) == 0:
        raise AssertionError(f"serve_caps with the obs flags: exit {rc}, "
                             f"launches {launches}")
    check_conv_launches("serve_caps --numerics-out", launches, 2)
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


# ---------------------------------------------------------------------------
# phase 10: training (repro_torch.captrain) on the card
# ---------------------------------------------------------------------------
def median_step_us(step, n: int = TRAIN_TIMED_STEPS) -> float:
    """Median of `n` calls of step(), each between two CUDA events on the
    current stream (host work included: the events bracket the call and
    the card waits on the host's launches), after 2 warm-up calls."""
    import torch
    for _ in range(2):
        step()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def state_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in state_leaves(tree[k])]
    return [tree]


def same_next_step(fresh, trainer, state, plan, x, y, what: str) -> None:
    """Step k+1 of the uninterrupted run equals step k+1 of a fresh
    trainer resumed from the checkpoint of step k, bit for bit, in loss
    and in every leaf of the state (and the resumed plan is the saved
    one)."""
    import torch
    k = trainer.step_index(state)
    restored, rplan = fresh.resume_or_init()
    if fresh.step_index(restored) != k or rplan != plan:
        raise AssertionError(f"{what}: resumed at step "
                             f"{fresh.step_index(restored)} with plan "
                             f"{'equal' if rplan == plan else 'different'}")
    a, ma = trainer.train_step(state, x, y, plan)
    b, mb = fresh.train_step(restored, x, y, rplan)
    bad = [i for i, (la, lb) in enumerate(zip(state_leaves(a),
                                              state_leaves(b)))
           if not torch.equal(la, lb)]
    if float(ma["loss"]) != float(mb["loss"]) or bad:
        raise AssertionError(f"{what}: step {k + 1} after a restore differs "
                             f"(loss {float(ma['loss'])!r} vs "
                             f"{float(mb['loss'])!r}; leaves {bad})")
    log(f"[train] resume {what}: step {k + 1} from the restored step-{k} "
        f"checkpoint equals the uninterrupted run bit for bit (loss "
        f"{float(ma['loss'])!r}, {len(state_leaves(a))} leaves"
        + (", plan from the side-car" if plan is not None else "") + ")")


def mnist_train_times(dev, card: str) -> tuple:
    """MNIST "L" at full size, batch 64 in 8 microbatches: float steps,
    then QAT steps on a derived plan; then each kind of step timed
    (median, CUDA events) with the device memory it peaks at above what
    was allocated before it.  Returns (trainer, config, state, plan,
    {kind: {"us", "peak_mib"}})."""
    import numpy as np
    import torch
    from repro_torch.captrain import CapsTrainer, TrainConfig
    from repro_torch.nn import MNIST
    tc = TrainConfig(dataset="mnist", batch=64, microbatches=8)
    trainer = CapsTrainer(MNIST, tc, device=dev)
    t0 = time.perf_counter()
    state, _, hist_f = trainer.fit(trainer.init_state(), TRAIN_FLOAT_STEPS)
    state, plan, hist_q = trainer.fit(state, TRAIN_QAT_STEPS, qat=True)
    fit_s = time.perf_counter() - t0
    losses_f = [h["loss"] for h in hist_f]
    losses_q = [h["loss"] for h in hist_q]
    if not all(np.isfinite(losses_f + losses_q)) or \
            losses_f[-1] >= losses_f[0]:
        raise AssertionError(f"mnist training: float losses {losses_f}, "
                             f"QAT losses {losses_q}")
    log(f"[train] mnist (capsnet_mnist, batch 64, 8 microbatches): "
        f"{TRAIN_FLOAT_STEPS} float steps, loss "
        + " ".join(f"{v:.4f}" for v in losses_f)
        + f"; {TRAIN_QAT_STEPS} QAT steps on a derived plan, loss "
        + " ".join(f"{v:.4f}" for v in losses_q)
        + f" ({fit_s:.2f} s with data and plan derivation)")
    x, y = trainer.task.batch(trainer.step_index(state), tc.batch)
    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y.astype(np.int64), device=dev)
    times = {}
    for what, p in (("float", None), ("qat", plan)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        us = median_step_us(lambda: trainer.train_step(state, xd, yd, p))
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        times[what] = {"us": us, "peak_mib": peak}
        log(f"[train] {card} | train_step_{what}_mnist: {us:.1f} us a step "
            f"(median of {TRAIN_TIMED_STEPS}, CUDA events), "
            f"{tc.batch / (us * 1e-6):.1f} img/s, peak {peak:.1f} MiB "
            f"above the {base / 2**20:.1f} MiB allocated before the steps")
    # the host's share of a step: the aten ops it dispatches (views and
    # allocations not counted)
    from repro_torch.dist.op_analysis import OpCounter
    for what, p in (("float", None), ("qat", plan)):
        with OpCounter() as oc:
            trainer.train_step(state, xd, yd, p)
        times[what]["ops"] = sum(oc.cost.ops.values())
    log(f"[train] aten ops a step (dist.op_analysis.OpCounter): float "
        f"{times['float']['ops']}, qat {times['qat']['ops']}")
    return trainer, tc, state, plan, times


def train_phase(dev, card: str) -> dict:
    """Phase 10: MNIST "L" float and QAT steps at full size, timed; same-
    step resume on the card; the EDGE_TINY Table-2 row; the QAT model
    served on the `cuda` backend and exported.  Returns the kernels'
    launches over the phase's int8 path (eval_q7 and serving)."""
    from types import SimpleNamespace
    from repro_torch.captrain import (CapsTrainer, TrainConfig, eval_q7,
                                      format_rows, table2_rows)
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.kernels import q7_matmul as kq
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.kernels import w8a8_matmul as kw
    from repro_torch.nn import EDGE_TINY, MNIST
    from repro_torch.nn.backend import get_backend
    from repro_torch.serving import ModelRegistry, serve_window
    kernels = (ks.squash_q7, kr.routing_q7, ks.squash_float, kq.matmul_q7,
               kq.bmm_q7, kw.w8a8_matmul)

    def counts():
        return {fn.__name__: fn.launches for fn in kernels}
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # 1. MNIST "L" at full size: float steps, QAT steps, step times
    before = counts()
    trainer, tc, state, plan, times = mnist_train_times(dev, card)
    steps_launched = {k: v - before[k] for k, v in counts().items()}
    if any(steps_launched.values()):
        raise AssertionError(f"the training steps launched a kernel: "
                             f"{steps_launched}")

    # 2. same-step resume on the card, float and QAT (plan side-car)
    for what, p in (("float", None), ("qat", plan)):
        rtc = dataclasses.replace(tc, ckpt_dir=str(TRAIN_DIR / what))
        saver = CapsTrainer(MNIST, rtc, device=dev)
        saver.save(state, p)
        xk, yk = trainer.task.batch(trainer.step_index(state), tc.batch)
        same_next_step(CapsTrainer(MNIST, rtc, device=dev), trainer, state,
                       p, xk, yk, what)

    # 3. the EDGE_TINY Table-2 row (the reference's acceptance call)
    etc = TrainConfig(dataset="edge_tiny", batch=32, microbatches=8,
                      calib_n=32, lr=3e-3, recalib_every=20)
    t0 = time.perf_counter()
    (row,) = table2_rows(EDGE_TINY, etc, float_steps=120, qat_steps=40,
                         eval_n=256, roundings=("floor",), device=dev)
    t2_s = time.perf_counter() - t0
    log("[train] table2_rows(EDGE_TINY, float_steps=120, qat_steps=40, "
        f"eval_n=256, roundings=('floor',)) on the card, {t2_s:.1f} s:")
    log(format_rows([row]))
    log(f"[train] {card} | edge_tiny Table 2: acc_f32 {row.acc_f32!r}, "
        f"acc_ptq {row.acc_ptq!r}, acc_qat {row.acc_qat!r}, delta_qat "
        f"{row.delta_qat!r} beside delta_ptq {row.delta_ptq!r}, saving "
        f"{row.saving_pct!r} %")
    if not (row.acc_f32 > 0.8 and row.saving_pct >= 70.0):
        raise AssertionError(f"Table 2 row out of bounds: {row}")

    # 4. the QAT model on the card: retrained with the same calls (each
    # step is deterministic), quantized, served and exported
    qtrainer = CapsTrainer(EDGE_TINY, etc, device=dev)
    qstate, _, _ = qtrainer.fit(qtrainer.init_state(), 120)
    qstate, _, _ = qtrainer.fit(qstate, 40, qat=True)
    qnet = qtrainer.quantize(qstate, backend="cuda")
    # the training path's int8 part: counts from 0 just before, read after
    ks.squash_q7.launches = kr.routing_q7.launches = 0
    images, labels = make_image_dataset("edge_tiny", 256, seed=999_999)
    acc = {be: eval_q7(qnet.with_backend(be), images, labels)
           for be in ("cuda", "torch")}
    if acc["cuda"] != acc["torch"]:
        raise AssertionError(f"eval_q7 differs between backends: {acc}")
    log(f"[train] the retrained QAT edge_tiny: eval_q7 {acc['cuda']!r} on "
        f"cuda and on torch (the row's acc_qat: {row.acc_qat!r})")
    fallbacks = get_backend("cuda").fallbacks
    fb0 = dict(fallbacks)
    reg = ModelRegistry(specs={}, device=dev)
    mid = "edge_tiny_qat@cuda"
    reg.install(mid, qnet)
    served = make_image_dataset("edge_tiny", N_OTHER, seed=SEED)[0]
    _, done, _ = serve_window(reg, BUCKETS, served, mid)
    check_completions(dict(spec=SimpleNamespace(model_id=mid), qnet=qnet,
                           images=served, completions=done))
    launches = {"squash_q7": ks.squash_q7.launches,
                "routing_q7": kr.routing_q7.launches}
    if min(launches.values()) == 0 or dict(fallbacks) != fb0:
        raise AssertionError(f"training path launches {launches}, cuda "
                             f"fallbacks {dict(fallbacks)} (were {fb0})")
    result = reg.export(mid, TRAIN_DIR / "export")
    if result["verified"] != 4:
        raise AssertionError(f"export of {mid} verified {result['verified']}")
    log(f"[train] {mid}: {len(done)} requests bit-identical to the torch "
        f"backend, no fallback; exported to "
        f"{result['paths']['capsbin'].name}, re-verified on "
        f"{result['verified']} images; launches over eval_q7 and serving "
        f"{launches}")
    return dict(launches=launches, step_times=times, row=row)


# ---------------------------------------------------------------------------
# phase 11: the search (repro_torch.search) on the card
# ---------------------------------------------------------------------------
def traced_search(cfg, dev) -> tuple:
    """(doc, tracer, wall s) of one run_search on the card."""
    from repro_torch import obs
    from repro_torch.search import run_search
    tr = obs.Tracer()
    t = time.perf_counter()
    with obs.tracing(tr):
        doc = run_search(cfg, device=dev)
    return doc, tr, time.perf_counter() - t


def log_search(card: str, what: str, doc, tr, wall: float,
               fallbacks: dict) -> None:
    """The `[search]` lines of one run (printed, not gated)."""
    import collections
    cands = doc["evaluated"]
    reasons = collections.Counter(c["reject_reason"].split(":")[0]
                                  for c in cands if not c["ok"])
    evals = tr.find("search.evaluate")
    ev = [s.dur_s for s in evals]
    # the EdgeVM's run inside each candidate: run_numerics on the host
    vm = [sum(r.dur_s for r in s.find("edgevm.run")) for s in evals]
    (setup,), (front,) = tr.find("search.setup"), tr.find("search.frontier")
    base = doc["baseline"]["metrics"]
    points = doc["frontier"]
    best = max(points, key=lambda p: (p["metrics"]["acc"],
                                      -p["metrics"]["flash_packed_bytes"]))
    cheaper = any(
        p["metrics"]["acc"] >= base["acc"] - 0.005
        and (p["metrics"]["flash_packed_bytes"] < base["flash_packed_bytes"]
             or p["metrics"]["est_ms_m7"] < base["est_ms_m7"])
        for p in points)

    def axes(m):
        return (f"acc {m['acc']!r}, flash_packed_bytes "
                f"{m['flash_packed_bytes']}, est_ms_m7 {m['est_ms_m7']!r}")
    log(f"[search] {card} | {what}: total {wall:.2f} s; search.setup "
        f"{setup.dur_s:.2f} s ({doc['config']['float_steps']} float steps + "
        f"calibration draw, float acc {doc['float_acc']!r}); "
        f"{len(cands)} candidates evaluated, "
        f"{sum(not c['ok'] for c in cands)} rejected {dict(reasons)}; "
        f"search.evaluate median {statistics.median(ev):.3f} s, max "
        f"{max(ev):.3f} s; search.frontier {front.dur_s:.2f} s")
    log(f"[search] {card} | {what}: per candidate, edgevm.run (the EdgeVM "
        f"on the host, inside run_numerics) median "
        f"{statistics.median(vm):.3f} s, {sum(vm) / sum(ev) * 100:.1f} % of "
        f"search.evaluate over {len(ev)} candidates; fallback decisions "
        f"{fallbacks}")
    log(f"[search] {card} | {what}: frontier {len(points)} point(s); "
        f"baseline {axes(base)}; best point {best['point']} "
        f"{axes(best['metrics'])}; a point dominates the baseline's memory "
        f"or latency within 0.5 % accuracy: {cheaper}")


def check_search_kernels(doc, st, dev, card: str) -> None:
    """Every accepted default-variant candidate of `doc` rebuilt on the
    card (the candidates whose eval_q7 and SNR pass launched the kernels
    during the search): eval_q7 over the eval set equal on the `cuda`
    and `torch` backends and to the doc's acc, and `forward`'s v_q
    equal at the SNR pass's batch and the eval set's, with both kernels
    counted from 0 over the comparison and no fallback.  Times one
    eval_q7 of the baseline on each backend (CUDA events)."""
    import torch
    from repro_torch.captrain import eval_q7
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.nn.backend import get_backend
    from repro_torch.nn.variants import VariantSet
    from repro_torch.search import CandidateSpec
    cfg = st.cfg
    nets = []
    for c in doc["evaluated"]:
        spec = CandidateSpec.from_json(c["spec"])
        qnet = st.space.build_qnet(spec, rounding=cfg.rounding)
        if c["ok"] and qnet.variants == VariantSet():
            nets.append((c, spec, qnet))
    if not nets:
        raise AssertionError("mnist search: no accepted default-variant "
                             "candidate")
    fallbacks = get_backend("cuda").fallbacks
    f0 = dict(fallbacks)
    ks.squash_q7.launches = kr.routing_q7.launches = 0
    for c, spec, qnet in nets:
        ref = qnet.with_backend("torch")
        acc = {be: eval_q7(q, st.images, st.labels)
               for be, q in (("cuda", qnet), ("torch", ref))}
        if acc["cuda"] != acc["torch"] or acc["cuda"] != c["metrics"]["acc"]:
            raise AssertionError(f"mnist candidate {spec.key}: eval_q7 "
                                 f"{acc}, doc {c['metrics']['acc']}")
        with torch.inference_mode():
            for n in (cfg.numerics_n, cfg.eval_n):
                x = qnet.quantize_input(torch.as_tensor(
                    st.images[:n], dtype=torch.float32, device=dev))
                got, want = qnet.forward(x), ref.forward(x)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"mnist candidate {spec.key}: v_q at B={n} differs "
                        f"from the torch backend by "
                        f"{max_abs_diff(got, want)}")
    moved = {"squash_q7": ks.squash_q7.launches,
             "routing_q7": kr.routing_q7.launches}
    if min(moved.values()) == 0 or dict(fallbacks) != f0:
        raise AssertionError(f"mnist candidates' kernel check: launches "
                             f"{moved}, fallbacks {dict(fallbacks)} vs {f0}")
    deepest = max(nets, key=lambda n: -sum(
        d for _, d in n[1].w_frac_deltas + n[1].out_frac_deltas))[1]
    first, base = nets[0][1], nets[0][2]
    base_ref = base.with_backend("torch")
    ms = {be: cuda_ms(lambda q=q: eval_q7(q, st.images, st.labels),
                      iters=5, warmup=1)
          for be, q in (("cuda", base), ("torch", base_ref))}
    log(f"[search] mnist: {len(nets)} accepted default-variant candidates "
        f"rebuilt on the card (the deepest frac reduction "
        f"w {list(deepest.w_frac_deltas)}, out "
        f"{list(deepest.out_frac_deltas)}): eval_q7 over {cfg.eval_n} "
        f"images equal on cuda and torch and to the doc's acc, v_q equal "
        f"at B={cfg.numerics_n} and B={cfg.eval_n}; launches over the "
        f"comparison {moved}, no fallback")
    log(f"[search] {card} | mnist eval_q7 of {first.key} over {cfg.eval_n} "
        f"images (CUDA events, mean of 5): cuda {ms['cuda']:.4f} ms, torch "
        f"backend {ms['torch']:.4f} ms")


def serve_exported(dev, capsbin, ref, model_id: str, images) -> tuple:
    """Install `capsbin` on the card and serve `images` through the
    engine, bit-identical to `ref` on the torch backend (card and CPU).
    Returns (installed net, launches, fallback decisions), counted from
    0 over the serving window."""
    from types import SimpleNamespace
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.nn.backend import get_backend
    from repro_torch.serving import ModelRegistry, serve_window
    fallbacks = get_backend("cuda").fallbacks
    reg = ModelRegistry(specs={}, device=dev)
    net = reg.install_artifact(capsbin, model_id=model_id)
    f0 = dict(fallbacks)
    ks.squash_q7.launches = kr.routing_q7.launches = 0
    _, done, _ = serve_window(reg, BUCKETS, images, model_id)
    served = {"squash_q7": ks.squash_q7.launches,
              "routing_q7": kr.routing_q7.launches}
    check_completions(dict(spec=SimpleNamespace(model_id=model_id),
                           qnet=ref, images=images, completions=done))
    return net, served, {k: v - f0.get(k, 0) for k, v in
                         dict(fallbacks).items() if v != f0.get(k, 0)}


def search_phase(dev, card: str) -> dict:
    """Phase 11: EDGE_TINY searches repeated byte for byte, the MNIST "L"
    search at full width with the kernels counted, its default-variant
    candidates held against the torch backend, its frontier points
    rebuilt, the two CLIs as subprocesses, and the exported point and a
    default-variant artifact served on the card.  Returns the kernels'
    launches over the MNIST search."""
    import os
    import torch
    from repro_torch.captrain import eval_q7
    from repro_torch.edge import export_artifacts
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.nn.backend import get_backend
    from repro_torch.nn.plans import plan_to_json
    from repro_torch.nn.variants import VariantSet
    from repro_torch.search import (CandidateSpec, SearchConfig,
                                    dominated_pairs, rebuild_point, save_doc)
    shutil.rmtree(SEARCH_DIR, ignore_errors=True)
    SEARCH_DIR.mkdir(parents=True)
    fallbacks = get_backend("cuda").fallbacks

    def fallbacks_since(f0):
        return {k: v - f0.get(k, 0) for k, v in dict(fallbacks).items()
                if v != f0.get(k, 0)}

    # 1. EDGE_TINY at the CLI's defaults, each strategy twice: same bytes
    for cfg in (SearchConfig(model="edge_tiny"),
                SearchConfig(model="edge_tiny", strategy="random",
                             budget=SEARCH_RANDOM_BUDGET)):
        paths = []
        for i in range(2):
            f0 = dict(fallbacks)
            doc, tr, wall = traced_search(cfg, dev)
            paths.append(SEARCH_DIR / f"edge_tiny_{cfg.strategy}_{i}.json")
            save_doc(doc, paths[-1])
            if i == 0:
                log_search(card, f"edge_tiny {cfg.strategy} budget "
                           f"{cfg.budget}", doc, tr, wall,
                           fallbacks_since(f0))
        if paths[0].read_bytes() != paths[1].read_bytes():
            raise AssertionError(f"edge_tiny {cfg.strategy}: two runs of one "
                                 f"seed wrote different docs")
        log(f"[search] edge_tiny {cfg.strategy}: two runs, byte-identical "
            f"docs ({paths[0].stat().st_size} bytes)")

    # 2. MNIST "L" at full width: counts from 0 just before, read after
    cfg = SearchConfig(model="mnist", budget=SEARCH_MNIST_BUDGET)
    f0 = dict(fallbacks)
    ks.squash_q7.launches = kr.routing_q7.launches = 0
    doc, tr, wall = traced_search(cfg, dev)
    launches = {"squash_q7": ks.squash_q7.launches,
                "routing_q7": kr.routing_q7.launches}
    log_search(card, f"mnist coordinate budget {cfg.budget}", doc, tr,
               wall, fallbacks_since(f0))
    log(f"[search] mnist: launches over the search {launches}")
    doc_path = SEARCH_DIR / "mnist_inproc.json"
    save_doc(doc, doc_path)
    points = doc["frontier"]
    if not points or dominated_pairs(points) != 0 or min(
            launches.values()) == 0:
        raise AssertionError(f"mnist search: {len(points)} frontier points, "
                             f"{dominated_pairs(points)} dominated pairs, "
                             f"launches {launches}")
    for p in points:
        if not (p["verified"] and p["checked"] and p["plan"]
                and p["metrics"]["checker_findings"] == 0):
            raise AssertionError(f"mnist frontier point {p['point']}: {p}")
    for c in doc["evaluated"]:
        if c["ok"] and c["metrics"]["int32_clip"] != 0:
            raise AssertionError(f"accepted candidate clipped: {c}")
    qnet0, _, st = rebuild_point(doc, 0, device=dev)
    check_search_kernels(doc, st, dev, card)
    for p in points:
        qnet = st.space.build_qnet(CandidateSpec.from_json(p["spec"]),
                                   rounding=cfg.rounding)
        if plan_to_json(qnet.plan) != p["plan"] or qnet.plan.check():
            raise AssertionError(f"mnist point {p['point']}: rebuilt plan "
                                 f"differs or fails plancheck")
        acc = {be: eval_q7(qnet.with_backend(be), st.images, st.labels)
               for be in ("cuda", "torch")}
        if acc["cuda"] != acc["torch"] or acc["cuda"] != p["metrics"]["acc"]:
            raise AssertionError(f"mnist point {p['point']}: eval_q7 {acc}, "
                                 f"doc {p['metrics']['acc']}")
    tags = [f"{p['spec']['softmax'] or '-'}+{p['spec']['squash'] or '-'}"
            for p in points]
    log(f"[search] mnist: {len(points)} frontier point(s) rebuilt on the "
        f"card (softmax+squash {tags}, '-' the default), plans equal to "
        f"the doc's and plancheck-clean, eval_q7 on cuda equal to torch "
        f"and to the doc's acc (a variant point runs the torch fallback "
        f"on both)")

    # 3. the CLIs, as a user runs them
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def cli(module, *args) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.launch.{module}",
             *map(str, args)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    cli_doc = SEARCH_DIR / "mnist.json"
    t = time.perf_counter()
    proc = cli("search_caps", "--model", "mnist", "--budget", cfg.budget,
               "--out", cli_doc)
    out, err = proc.communicate(timeout=600)
    sec = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"search_caps --model mnist: exit "
                             f"{proc.returncode}\n{out[-3000:]}\n"
                             f"{err[-3000:]}")
    same = cli_doc.read_bytes() == doc_path.read_bytes()
    log(f"[search] {card} | search_caps --model mnist --budget {cfg.budget}: "
        f"exit 0 in {sec:.1f} s (process included); its doc byte-identical "
        f"to the in-process run's: {same}")
    if not same:
        raise AssertionError("search_caps wrote another doc than run_search "
                             "for the same config on the same card")
    # the exports side by side: point 0, the first default-variant point
    # when it is another, and the tampered copy's refusal
    dflt = next((p["point"] for p in points
                 if not (p["spec"]["softmax"] or p["spec"]["squash"])), None)
    bad = json.loads(cli_doc.read_text())
    bad["frontier"][0]["plan"]["layers"]["conv0"]["out_shift"] += 1
    bad_path = SEARCH_DIR / "mnist_tampered.json"
    save_doc(bad, bad_path)
    jobs = [(cli_doc, 0, SEARCH_DIR / "mnist_p0"),
            (bad_path, 0, SEARCH_DIR / "tampered")]
    if dflt not in (None, 0):
        jobs.append((cli_doc, dflt, SEARCH_DIR / f"mnist_p{dflt}"))
    t = time.perf_counter()
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 2) // len(jobs)))
    procs = [cli("export_caps", "--from-search", path, "--point", k,
                 "--out", out) for path, k, out in jobs]
    outs = [p.communicate(timeout=600) for p in procs]
    sec = time.perf_counter() - t
    for (path, k, out_dir), p, (out, err) in zip(jobs, procs, outs):
        if path == bad_path:
            if p.returncode != 2 or out_dir.exists():
                raise AssertionError(f"export_caps on a doc with conv0's "
                                     f"out_shift changed: exit "
                                     f"{p.returncode}\n{err[-2000:]}")
            refusal = err.strip().splitlines()[-1][:100]
        elif p.returncode != 0:
            raise AssertionError(f"export_caps --from-search --point {k}: "
                                 f"exit {p.returncode}\n{out[-3000:]}\n"
                                 f"{err[-3000:]}")
    log(f"[search] {card} | export_caps --from-search mnist.json --point "
        f"{', '.join(str(k) for path, k, _ in jobs if path == cli_doc)}: "
        f"exit 0; on a copy with point 0's conv0 out_shift + 1: exit 2 "
        f"({refusal}); all side by side in {sec:.1f} s (process start and "
        f"rebuild included)")

    # 4. the exported point 0 on the card, counted from 0: a default-
    # variant point launches both kernels and counts no fallback; a
    # variant runs the counted fallback where the kernels lack it
    # (nn/backend.py)
    images = st.images[:SEARCH_SERVED]
    (capsbin,) = (SEARCH_DIR / "mnist_p0").glob("*.capsbin")
    net, served, fb = serve_exported(dev, capsbin, qnet0, "mnist_p0@cuda",
                                     images)
    v, dv = qnet0.variants, VariantSet()
    want = {"squash_q7": v.squash == dv.squash, "routing_q7": v == dv}
    if net.backend != "cuda" or want != {k: n > 0 for k, n in
                                         served.items()} \
            or bool(fb) != (v != dv):
        raise AssertionError(f"exported point ({v.tag}) served on "
                             f"{net.backend}, launches {served}, "
                             f"fallbacks {fb}")
    log(f"[search] {capsbin.name} ({v.tag}): installed on the card, "
        f"{len(images)} requests on the cuda backend bit-identical to the "
        f"rebuilt point on the torch backend; launches {served}, fallback "
        f"decisions {fb}")

    # 5. a default-variant result through the same install and serving
    # path, both kernels launched and no fallback: the first default-
    # variant frontier point's CLI export, else the baseline exported
    spec = CandidateSpec() if dflt is None else \
        CandidateSpec.from_json(points[dflt]["spec"])
    ref = st.space.build_qnet(spec, rounding=cfg.rounding)
    if dflt is None:
        export_artifacts(ref, SEARCH_DIR / "mnist_baseline",
                         stem="mnist_baseline",
                         verify_images=st.images[:cfg.verify_n])
        what = "the baseline (no frontier point has the default variants)"
        (capsbin,) = (SEARCH_DIR / "mnist_baseline").glob("*.capsbin")
    else:
        what = f"frontier point {dflt}"
        (capsbin,) = (SEARCH_DIR / f"mnist_p{dflt}").glob("*.capsbin")
    net, served, fb = serve_exported(dev, capsbin, ref,
                                     f"{capsbin.stem}@cuda", images)
    if net.backend != "cuda" or min(served.values()) == 0 or fb:
        raise AssertionError(f"default-variant artifact {capsbin.name} "
                             f"served on {net.backend}, launches {served}, "
                             f"fallbacks {fb}")
    log(f"[search] {capsbin.name}, {what}: installed on the card, "
        f"{len(images)} requests on the cuda backend bit-identical to the "
        f"rebuilt spec on the torch backend; launches {served}, no "
        f"fallback")
    torch.cuda.synchronize()
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# phase 12: the LM serving path (repro_torch.models, launch.serve) and the
# one-card sharded waves
# ---------------------------------------------------------------------------
# qwen3_14b's dense products (K, N): wq, wk/wv, wo, gate/up, down,
# lm_head; what `dense_kn` must read off its param tree
QWEN_DENSE_KN = ((5120, 1024), (5120, 6144), (5120, 17408), (5120, 152064),
                 (6144, 5120), (17408, 5120))
LM_DENSE_M = (8, 512)                  # a decode step, a prefill (8 x 64)
LM_RAGGED = (7, 100, 33)               # K % 16 != 0: the mma.sync loop
LM_SPLIT = (4, 2048, 8)                # one output tile, K cut between blocks
# M on both sides of gemm_plan's small-M switch (SMALL_M = 64), at
# qwen3_14b's down projection (K, N)
LM_SWEEP_M, LM_SWEEP_KN = (1, 8, 16, 64, 65), (17408, 5120)
LM_REQUESTS, LM_PROMPT, LM_GEN = 8, 64, 32
# the timed shapes of the JSON record: a decode step's down projection
# (the headline) and a prefill's gate/up projection
LM_TIMED = ((8, 17408, 5120), (512, 5120, 17408))
# decode/prefill consistency, the CPU tests' tolerance (the reference's
# own for this check)
CONSIST_ATOL, CONSIST_RTOL = 0.15, 0.05
# paligemma_3b at full depth in bf16 on an H100: 4 of 2,057,728 logits
# 0.1953 off (bound 0.15 + 0.05 |a|), the same in every run; its gate
# bounds how many and how far, and a float32 run of the same params
# must pass the tolerance with none beyond it
CONSIST_OUTLIERS, CONSIST_MAX = 8, 0.25
# xlstm_1_3b in full in bf16 on an H100: 0.3008 off, 1,021 logits beyond
# the tolerance, argmax equal on 8/8, the same in every run (its float32
# witness 0.004380, none beyond): the bf16 paths drift apart layer by
# layer, as the reference's do (tools/xlstm_drift.py).  Its gate lies
# between that and the readings of the faults it must catch
# (`drift_faults`): the mLSTM's C kept in bf16 0.4688 / 5,265 beyond,
# its m 0.5889 / 8,247, the sLSTM's state 0.3730 / 1,508.
DRIFT_BEYOND, DRIFT_MAX = 1250, 0.35
CONSIST_GATES = {
    "tol": "the CPU tests' tolerance, no logit beyond it; argmax printed "
    "(random weights leave near-ties among 152k-262k logits)",
    "bounded": f"the CPU tests' tolerance with at most {CONSIST_OUTLIERS} "
    f"logits beyond it, none more than {CONSIST_MAX} off; the float32 "
    "witness with none beyond it",
    "print": "none: W8A8 quantizes each activation tensor with one dynamic "
    "exponent, so 8 x 65 rows and 8 rows quantize a row differently",
    "drift": f"at most {DRIFT_BEYOND} logits beyond the CPU tests' "
    f"tolerance, none more than {DRIFT_MAX} off, argmax equal on every "
    "row; the float32 witness with none beyond it; the same check with "
    "the mLSTM's C or m or the sLSTM's state kept in bf16 fails it"}


def dense_bound(M: int, K: int, N: int):
    """w8a8_dense's bound: 2MKN int8 operations against MK + KN bytes of
    int8 in, 2MN of bf16 out and 4N of exponents."""
    return gemm_bound(M, K, N, M * N + 4 * N)


def dense_operands(M: int, K: int, N: int, g, dev):
    """Random int8 operands and exponents, drawn on the card from `g`: xq
    [M, K] and W stored K-major as the W8A8 leaf holds it, wt [N, K]."""
    import torch
    z = dict(generator=g, device=dev)
    xq = torch.randint(-128, 128, (M, K), dtype=torch.int8, **z)
    wt = torch.randint(-128, 128, (N, K), dtype=torch.int8, **z)
    xe = torch.randint(-24, 25, (), **z).float()
    n = torch.randint(-24, 25, (N,), dtype=torch.int32, **z)
    return xq, wt, xe, n


def tree_w(wt):
    """W as this tree's w8a8_dense takes it: K-major wt [..., N, K] where
    its weight argument is `wt`, else (a tree from before W was stored
    K-major, timed by `--device-times`) W [..., K, N]."""
    import inspect
    from repro_torch.kernels import w8a8_dense as kd
    if "wt" in inspect.signature(kd.w8a8_dense).parameters:
        return wt
    return wt.transpose(-1, -2).contiguous()


def plan_line(what: str, shape, xq, wt) -> str:
    """The `[library]` line of a W8A8 call's plan; on the stream-K
    schedule, each block's share of the (tile, K block) iterations and of
    W's bytes (a K block of a tile: 128 x 128 bytes of W, fewer on a
    ragged edge), the least and the most, and their spread."""
    from repro_torch.kernels import q7_matmul as kq
    plan = kq.plan_for(xq, wt, b_kmajor=True)
    line = (f"[library] {what} {tuple(shape)}: route {plan.route}, tile "
            f"{plan.tile}, schedule {plan.schedule}")
    if plan.schedule != "stream-k":
        return line + f", split {plan.split}"
    M, K = xq.shape[-2:]
    N, batch = wt.shape[-2], xq.numel() // (M * K)
    kb, n_tiles = -(-K // kq.K_BLOCK), -(-N // 128)
    iters = kq.streamk_iterations(M, K, N, batch)

    def w_bytes(i):
        nt, k = (i // kb) % n_tiles, i % kb
        return min(128, N - 128 * nt) * min(kq.K_BLOCK, K - kq.K_BLOCK * k)
    shares = kq.streamk_shares(iters, plan.ctas)
    sizes = [e - b for b, e in shares]
    loads = [sum(map(w_bytes, range(b, e))) for b, e in shares]
    return (line + f" on {plan.ctas} blocks: {min(sizes)}-{max(sizes)} "
            f"(tile, K block) iterations a block of {iters}, W bytes a block "
            f"{min(loads):,}-{max(loads):,} (spread "
            f"{(max(loads) - min(loads)) / min(loads):.2%})")


def dense_kn(cfg) -> list:
    """(K, N) of every W8A8 dense product of `cfg`, read off the
    quantized param tree of one pattern cycle (depth changes no shape)
    built on the meta device (no memory, no data)."""
    import torch
    from repro_torch.models.transformer import build_model
    from repro_torch.quant.lm_quant import init_quantized, is_qweight
    cycle = dataclasses.replace(cfg, num_layers=len(cfg.blocks))
    tree = init_quantized(build_model(cycle), torch.Generator(), "meta")
    out = set()

    def walk(t):
        if is_qweight(t):             # qt [..., N, K]: W stored K-major
            out.add(tuple(t["qt"].shape[-1:-3:-1]))
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
    walk(tree)
    return sorted(out)


def check_dense(dev, cfgs, tag: str = "[lm]") -> float:
    """w8a8_dense against its plain version on the card, bit for bit, at
    every product of the W8A8 configs `cfgs` (those a phase serves; M 8
    and 512: a decode step and a prefill of 8 x 64), a ragged shape, a
    one-tile shape whose K is cut between blocks, and M across the
    small-M switch at one qwen3_14b product, W stored K-major; returns
    the largest |difference| (0)."""
    import torch
    from repro_torch.kernels import q7_matmul as kq
    from repro_torch.kernels import w8a8_dense as kd
    users = {}
    for cfg in cfgs:
        kn = dense_kn(cfg)
        if cfg.name == "qwen3_14b" and kn != sorted(QWEN_DENSE_KN):
            raise AssertionError(f"qwen3_14b's products read {kn}")
        for k in kn:
            users.setdefault(k, []).append(cfg.name)
    g = torch.Generator(dev).manual_seed(SEED + 12)
    cases = [(M, K, N, "/".join(names)) for (K, N), names in users.items()
             for M in LM_DENSE_M]
    cases += [(*LM_RAGGED, "ragged"), (*LM_SPLIT, "one tile, K cut")]
    cases += [(M, *LM_SWEEP_KN, "small-M switch") for M in LM_SWEEP_M]
    worst = 0.0
    for M, K, N, who in cases:
        xq, wt, xe, n = dense_operands(M, K, N, g, dev)
        plan = kq.plan_for(xq, wt, b_kmajor=True)
        got = kd.w8a8_dense(xq, wt, xe, n)
        want = kd.w8a8_dense_plain(xq, wt, xe, n)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"w8a8_dense {(M, K, N)} ({plan}) differs "
                                 "from its plain version")
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        log(f"{tag} w8a8_dense {(M, K, N)} ({who}): route {plan.route}, "
            f"tile {plan.tile}, {plan.schedule}, split {plan.split}, "
            f"blocks {plan.ctas or 'a tile each'}: bit-exact against the "
            f"plain version (bf16 out)")
        del xq, wt, got, want
    if not {"wgmma", "mma.sync"} <= {
            r for r, c in kd.w8a8_dense.launches_by_route.items() if c}:
        raise AssertionError(f"w8a8_dense left a route unused: "
                             f"{kd.w8a8_dense.launches_by_route}")
    return worst


def extra_inputs(cfg, dev, frames: str = "zeros") -> dict:
    """The batch entries beside the tokens: a VLM's zero image embeds;
    an encoder-decoder's frame embeddings [8, 64, d_model] float32, zero
    as `launch.serve` gives them, or with frames="random" drawn from a
    seeded generator, so the cross-attention sees a non-zero encoder
    output."""
    import torch
    out = {}
    if cfg.family == "vlm":
        out["prefix_embeds"] = torch.zeros(
            (LM_REQUESTS, cfg.num_prefix_embeds, cfg.d_model), device=dev)
    if cfg.is_encoder_decoder:
        shape = (LM_REQUESTS, LM_PROMPT, cfg.d_model)
        out["frames"] = torch.zeros(shape, device=dev) if frames == "zeros" \
            else torch.randn(shape, device=dev, generator=torch.Generator(
                dev).manual_seed(SEED + 30))
    return out


def decode_vs_prefill(model, params, cfg, dev) -> tuple:
    """(prefill(t[:65]) logits, decode_step(t[64]) logits after
    prefill(t[:64])), float32, for 8 TokenTask rows (zero image embeds
    for a VLM; for an encoder-decoder the same random frames [8, 64, d]
    on both sides)."""
    import torch
    from repro_torch.data.synthetic import TokenTask
    toks = torch.as_tensor(TokenTask(cfg.vocab_size, LM_PROMPT + 1, seed=5)
                           .batch(0, LM_REQUESTS)["inputs"], device=dev)
    batch = extra_inputs(cfg, dev, frames="random")
    pos = LM_PROMPT + (cfg.num_prefix_embeds if cfg.family == "vlm" else 0)
    with torch.inference_mode():
        full, _ = model.prefill(params, dict(batch, inputs=toks), alloc=512)
        _, cache = model.prefill(params, dict(batch,
                                              inputs=toks[:, :LM_PROMPT]),
                                 alloc=512)
        dec, _ = model.decode_step(params, cache, toks[:, LM_PROMPT:], pos)
    a, b = full.float(), dec.float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return a, b


def tree_float32(tree):
    """A float32 copy of a param tree (nested dicts and tuples)."""
    if isinstance(tree, dict):
        return {k: tree_float32(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_float32(v) for v in tree)
    return tree.float()


def consist_numbers(a, b) -> tuple:
    """(logits beyond the tolerance as a mask, their count, the largest
    |difference|, rows whose argmax agree) of prefill logits `a` and
    decode logits `b`."""
    err = (a - b).abs()
    beyond = err > CONSIST_ATOL + CONSIST_RTOL * a.abs()
    return (beyond, int(beyond.sum()), float(err.max()),
            int((a.argmax(-1) == b.argmax(-1)).sum()))


def drift_ok(over: int, worst: float, agree: int) -> bool:
    return over <= DRIFT_BEYOND and worst <= DRIFT_MAX and \
        agree == LM_REQUESTS


def drift_faults(model, params, cfg, dev, tag: str) -> str:
    """The "drift" gate against the faults it must catch: the check run
    again with the mLSTM's C, its m, or the sLSTM's state rounded to bf16
    after every mixer call (a state kept in the activations' dtype) must
    fail it.  Returns the lines."""
    from repro_torch.models import xlstm

    def rounded(apply, names):
        def f(p, x, cfg_, *, mode, cache=None):
            y, c = apply(p, x, cfg_, mode=mode, cache=cache)
            if c is not None:
                for k in names:
                    c[k].copy_(c[k].bfloat16().float())
            return y, c
        return f
    lines = []
    for fn, names, what in (("mlstm_apply", "C", "the mLSTM's C"),
                            ("mlstm_apply", "m", "the mLSTM's m"),
                            ("slstm_apply", "cnmh", "the sLSTM's state")):
        orig = getattr(xlstm, fn)
        setattr(xlstm, fn, rounded(orig, names))
        try:
            a, b = decode_vs_prefill(model, params, cfg, dev)
        finally:
            setattr(xlstm, fn, orig)
        _, over, worst, agree = consist_numbers(a, b)
        line = (f"{tag} {cfg.name} with {what} kept in bf16: max |diff| "
                f"{worst:.4f}, {over} beyond, argmax equal on "
                f"{agree}/{LM_REQUESTS} rows")
        if drift_ok(over, worst, agree):
            raise AssertionError(f"{line}: the drift gate misses it")
        lines.append(line + ": fails the gate, as it must")
    return "\n".join(lines)


def lm_consistency(model, params, cfg, dev, quant: str, gate: str,
                   tag: str = "[lm]") -> str:
    """prefill(t[:64]) then decode_step(t[64]) against prefill(t[:65]);
    returns the lines.  `gate` "tol" raises on any logit past the CPU
    tests' tolerance; "bounded" on more than CONSIST_OUTLIERS of them or
    one more than CONSIST_MAX off, and runs the same check on a float32
    copy of the params (a witness that rounds neither path to bf16),
    which must have none; "drift" on more than DRIFT_BEYOND of them, one
    more than DRIFT_MAX off or an argmax that differs, then runs the
    witness and `drift_faults`; "print" never raises."""
    a, b = decode_vs_prefill(model, params, cfg, dev)
    beyond, over, worst, agree = consist_numbers(a, b)
    line = (f"{cfg.name} {quant}: decode after prefill({LM_PROMPT}) vs "
            f"prefill({LM_PROMPT + 1}): "
            f"max |diff| {worst:.4f} over logits up to "
            f"{float(a.abs().max()):.3f}, {over} beyond atol "
            f"{CONSIST_ATOL} + rtol {CONSIST_RTOL}, argmax equal on "
            f"{agree}/{LM_REQUESTS} rows")
    if (gate == "tol" and over) or (gate == "bounded" and (
            over > CONSIST_OUTLIERS or worst > CONSIST_MAX)) or (
            gate == "drift" and not drift_ok(over, worst, agree)):
        raise AssertionError(line)
    if gate not in ("bounded", "drift"):
        return line
    # the float32 witness: which bf16 path lies off the unrounded logits
    p32 = tree_float32(params)
    wa, wb = decode_vs_prefill(model, p32, cfg, dev)
    del p32
    werr = (wa - wb).abs()
    wover = int((werr > CONSIST_ATOL + CONSIST_RTOL * wa.abs()).sum())
    fa, fb = (a - wa).abs(), (b - wb).abs()
    at = (f"at the {over} logits beyond: prefill off float32 by up to "
          f"{float(fa[beyond].max()):.4f}, decode by up to "
          f"{float(fb[beyond].max()):.4f}" if over else "none beyond")
    line += (f"\n{tag} {cfg.name} float32 witness (the same params in "
             f"float32): decode vs prefill max |diff| "
             f"{float(werr.max()):.6f}, {wover} beyond the tolerance; bf16 "
             f"prefill({LM_PROMPT + 1}) off it by up to "
             f"{float(fa.max()):.4f}, bf16 decode by up to "
             f"{float(fb.max()):.4f}; {at}")
    if wover:
        raise AssertionError(line)
    if gate == "drift":
        line += "\n" + drift_faults(model, params, cfg, dev, tag)
    return line


def warm_times(res, cfg, dev, steps: int = 8) -> tuple:
    """One more prefill of the served prompts and `steps` decode steps on
    the served params, the kernels and cuBLAS warm: (prefill ms, decode
    ms a step), host clock around work ending in a synchronize."""
    import torch
    from repro_torch.models.transformer import decode_alloc
    model, params = res["model"], res["params"]
    batch = dict(extra_inputs(cfg, dev), inputs=res["prompts"])
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch,
                                      alloc=decode_alloc(LM_PROMPT + LM_GEN))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        for i in range(steps):
            logits, cache = model.decode_step(params, cache, tok,
                                              res["pos0"] + i)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3 / steps


def serve_lm(cfg, dev, card: str, quant: str, consist: str,
             tag: str = "[lm]"):
    """launch.serve.serve of `cfg` (8 x 64 prompts, 32 greedy tokens),
    finite logits required, the numbers logged (the serve call's, its
    first calls included, and a warm prefill and 8 decode steps after
    it; for a MoE config the assignments each layer drops at a prefill
    of the served prompts); then the consistency check (`consist`: a
    `lm_consistency` gate, "moe" for `moe_consistency`'s, or "none").
    Returns the tokens, the numbers and the serve call's w8a8_dense and
    w8a8_bmm launches, with the model and params dropped."""
    import torch
    from repro_torch.kernels import q7_matmul as kq
    from repro_torch.kernels import w8a8_dense as kd
    from repro_torch.launch.serve import serve
    torch.cuda.reset_peak_memory_stats()
    n0, b0 = kd.w8a8_dense.launches, kd.w8a8_bmm.launches
    t0 = kq.transpose_kn.launches
    res = serve(cfg, LM_REQUESTS, LM_PROMPT, LM_GEN, quant, dev, seed=SEED,
                log=lambda *a: log(tag, *a))
    launches = kd.w8a8_dense.launches - n0
    bmm_launches = kd.w8a8_bmm.launches - b0
    transposes = kq.transpose_kn.launches - t0
    if not torch.isfinite(res["logits"].float()).all():
        raise AssertionError(f"{cfg.name} {quant}: non-finite logits")
    if transposes:
        raise AssertionError(f"{cfg.name} {quant}: transpose_kn launched "
                             f"{transposes} times (W is stored K-major)")
    steps = LM_GEN - 1
    out = dict(tokens=res["tokens"], launches=launches,
               bmm_launches=bmm_launches, transposes=transposes,
               prefill_ms=res["prefill_s"] * 1e3,
               decode_ms_step=res["decode_s"] * 1e3 / steps,
               tok_per_s=res["tok_per_s"],
               param_mib=res["param_bytes"] / 2**20,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["warm_prefill_ms"], out["warm_decode_ms_step"] = \
        warm_times(res, cfg, dev)
    out["warm_tok_per_s"] = LM_REQUESTS / out["warm_decode_ms_step"] * 1e3
    log(f"{tag} {card} | {cfg.name} {quant} ({cfg.num_layers} layers, d "
        f"{cfg.d_model}): serve: prefill {out['prefill_ms']:.2f} ms for "
        f"{LM_REQUESTS}x{LM_PROMPT} tokens (first call), decode "
        f"{out['decode_ms_step']:.3f} ms a step over {steps} steps "
        f"({out['tok_per_s']:.1f} tok/s aggregate); warm: prefill "
        f"{out['warm_prefill_ms']:.2f} ms, decode "
        f"{out['warm_decode_ms_step']:.3f} ms a step "
        f"({out['warm_tok_per_s']:.1f} tok/s); params "
        f"{out['param_mib']:.1f} MiB, peak {out['peak_gib']:.2f} GiB, "
        f"w8a8_dense launches {launches}, transpose_kn launches "
        f"{transposes}"
        + (f", w8a8_bmm launches {bmm_launches}" if cfg.num_experts else ""))
    if cfg.num_experts:
        out["dropped"] = prefill_drops(res, cfg)
        log(f"{tag} {card} | {cfg.name} {quant}: assignments dropped per "
            f"layer at a prefill of the served {LM_REQUESTS}x{LM_PROMPT} "
            f"prompts (of {LM_REQUESTS * LM_PROMPT * cfg.experts_per_tok} "
            f"a layer, capacity {moe_capacity(LM_PROMPT, cfg)} an expert "
            f"and row): {out['dropped']}")
    if consist == "moe":
        for line in moe_consistency(res["params"], cfg, dev, quant):
            log(f"{tag} {line}")
    elif consist != "none":
        line = lm_consistency(res["model"], res["params"], cfg, dev, quant,
                              gate=consist, tag=tag)
        log(f"{tag} {line} (gate: {CONSIST_GATES[consist]})")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_cli(args, tag: str, card: str) -> None:
    """`python -m repro_torch.launch.serve ARGS` in its own process, exit
    0 required, its lines logged."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    args = [*map(str, args), "--requests", str(LM_REQUESTS), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN)]
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"launch.serve {args}: exit {proc.returncode}"
                             f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"{tag} {card} | python -m repro_torch.launch.serve "
        f"{' '.join(args)}: exit 0 in {time.perf_counter() - t:.1f} s "
        f"(process included):")
    for line in proc.stdout.strip().splitlines():
        log(f"{tag}   {line}")


def lm_phase(dev, card: str, run) -> dict:
    """Phase 12; returns the w8a8_dense record's pieces."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import w8a8_dense as kd
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm] device memory before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matmuls")
    # the W8A8 configs served below: qwen3_14b in full, gemma3_12b one
    # pattern cycle; stablelm_3b in full in phase 20's serving example
    qwen = get_config("qwen3_14b")
    gemma = dataclasses.replace(get_config("gemma3_12b"),
                                num_layers=len(get_config("gemma3_12b")
                                               .blocks))
    err = check_dense(dev, (qwen, gemma, get_config("stablelm_3b"),
                            get_config("qwen2_72b")))

    # qwen3_14b at full width and depth: float, then W8A8 counted from 0
    f = serve_lm(qwen, dev, card, "none", "tol")
    kd.w8a8_dense.launches = 0
    q = serve_lm(qwen, dev, card, "w8a8", "none")
    launches = q["launches"]
    want = (7 * qwen.num_layers + 1) * LM_GEN
    log(f"[lm] qwen3_14b w8a8: w8a8_dense launched {launches} times "
        f"over the serve call; expected {want} (7 "
        f"dense products x {qwen.num_layers} blocks + lm_head, per forward, "
        f"1 prefill + {LM_GEN - 1} decode steps)")
    if launches != want:
        raise AssertionError(f"w8a8_dense launched {launches} times on the "
                             f"qwen3_14b W8A8 run, not {want}")
    agree = float((q["tokens"] == f["tokens"]).mean())
    log(f"[lm] qwen3_14b: W8A8 and float greedy tokens agree on "
        f"{agree:.1%} of {f['tokens'].size} (not gated)")

    # gemma3_12b at full width, one pattern cycle; paligemma_3b in full
    g_f = serve_lm(gemma, dev, card, "none", "tol")
    g_q = serve_lm(gemma, dev, card, "w8a8", "print")
    gemma_launches = g_q["launches"]
    if gemma_launches != (7 * gemma.num_layers + 1) * LM_GEN:
        raise AssertionError(f"gemma3_12b: w8a8_dense launched "
                             f"{gemma_launches} times")
    p_f = serve_lm(get_config("paligemma_3b"), dev, card, "none",
                   "bounded")

    # qwen2_72b in full, W8A8 (its bf16 tree is over the card), counted
    # from 0 just before, and its CLI
    q72 = qwen2_full(dev, card)

    # serve_caps --mesh host, and waves with and without the host mesh
    import contextlib
    import io
    from repro_torch.launch import serve_caps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.sharded import compile_wave
    buf = io.StringIO()
    ks.squash_q7.launches = kr.routing_q7.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = serve_caps.main(["--model", "mnist@cuda", "--requests",
                              str(N_REQUESTS), "--mesh", "host"])
    text = buf.getvalue()
    mesh_line = "mesh={'pod': 1, 'model': 1, 'data': 1}"
    if rc != 0 or mesh_line not in text or min(
            ks.squash_q7.launches, kr.routing_q7.launches) == 0:
        raise AssertionError(f"serve_caps --mesh host: exit {rc}\n{text}")
    log(f"[lm] serve_caps --model mnist@cuda --requests {N_REQUESTS} --mesh "
        f"host: exit 0, {mesh_line}, kernels launched "
        f"(squash_q7 {ks.squash_q7.launches}, routing_q7 "
        f"{kr.routing_q7.launches})")
    mesh = make_host_mesh(("pod", "model", "data"))
    qnet = run["qnet"]
    for b in BUCKETS:
        x = run["images"][:b]
        plain, meshed = compile_wave(qnet, b), compile_wave(qnet, b, mesh)
        for u, v in zip(plain(x), meshed(x)):
            if not torch.equal(u, v):
                raise AssertionError(f"bucket {b}: the host-mesh wave "
                                     "differs from the plain one")
    log(f"[lm] waves under the host mesh {mesh.shape} bit-identical to "
        f"waves without one at buckets {BUCKETS}")
    return dict(launches=launches, launches_by_path={
        "lm": launches, "lm_gemma3_12b": gemma_launches,
        "lm_qwen2_72b": q72["launches"]},
        max_abs_err=err, qwen_float=f, qwen_w8a8=q, gemma_float=g_f,
        gemma_w8a8=g_q, paligemma_float=p_f, qwen2_72b_w8a8=q72,
        token_agreement=agree)


def time_dense(dev, card: str) -> dict:
    """w8a8_dense at LM_TIMED: the wrapper's wall time, its plain
    version's, the bound and torch._int_mm (where it takes the shape)."""
    import torch
    from repro_torch.kernels import q7_matmul as kq
    from repro_torch.kernels import w8a8_dense as kd
    g = torch.Generator(dev).manual_seed(SEED + 13)
    rows = []
    for M, K, N in LM_TIMED:
        xq, wt, xe, n = dense_operands(M, K, N, g, dev)
        bound, by = dense_bound(M, K, N)
        log(f"{plan_line('w8a8_dense', (M, K, N), xq, wt)} | {card}")
        rows.append(dict(
            shape=[M, K, N], ms=cuda_ms(lambda: kd.w8a8_dense(xq, wt, xe, n)),
            plain_ms=cuda_ms(lambda: kd.w8a8_dense_plain(xq, wt, xe, n),
                             iters=5),
            bound_ms=bound, bound_by=by, int_mm_ms=int_mm_ms(xq, wt.t()),
            plan=str(tuple(kq.plan_for(xq, wt, b_kmajor=True)))))
        yard = "n/a (M <= 16)" if rows[-1]["int_mm_ms"] is None \
            else f"{rows[-1]['int_mm_ms']:.4f} ms"
        log(f"[time] {card} | w8a8_dense {[M, K, N]} ({rows[-1]['plan']}): "
            f"kernel {rows[-1]['ms']:.4f} ms, plain "
            f"{rows[-1]['plain_ms']:.4f} ms, bound {bound:.6f} ms ({by}), "
            f"torch._int_mm yardstick {yard}")
    return dict(rows[0], shapes=rows)


def kernel_parts(parts: dict) -> str:
    return ", ".join(f"{k.split('(')[0].split('<')[0].split('::')[-1]}"
                     f" {v:.5f}" for k, v in parts.items())


def dense_device_times(dev, card: str, rows: list) -> None:
    """Profiler device time of w8a8_dense at each row's shape, summed
    over every kernel of the call (the product, and a split-K reduction
    or the stream-K schedule's zeroed counts; a tree from before W was
    stored K-major also its transpose), into `rows`, beside the bound and
    the share of it the call reaches."""
    import torch
    from repro_torch.kernels import w8a8_dense as kd
    g = torch.Generator(dev).manual_seed(SEED + 13)
    for row in rows:
        M, K, N = row["shape"]
        xq, wt, xe, n = dense_operands(M, K, N, g, dev)
        w = tree_w(wt)
        parts = {}
        row["device_ms"] = device_ms(lambda: kd.w8a8_dense(xq, w, xe, n),
                                     None, calls=20, parts=parts)
        row["int_mm_device_ms"] = int_mm_device_ms(xq, wt.t())
        log(f"[device] {card} | w8a8_dense {row['shape']}: "
            f"{row['device_ms']:.5f} ms, every kernel of the call "
            f"({kernel_parts(parts)}); bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}), {row['bound_ms'] / row['device_ms']:.1%}"
            f" of it")


# ---------------------------------------------------------------------------
# phase 13: the MoE FFN (repro_torch.models.moe, q_einsum on w8a8_bmm)
# ---------------------------------------------------------------------------
# depth cuts: phi35_moe's bf16 tree is 83.6 GB at its 32 layers, over the
# card's 80 GB; mixtral_8x22b holds ~5 GB of bf16 a layer
MOE_LAYERS = {"phi35_moe": 16, "mixtral_8x22b": 4}
# (E, M, K, N): K % 16 != 0, the mma.sync loop; one tile an expert, its K
# cut between blocks
MOE_RAGGED = (3, 7, 100, 33)
MOE_SPLIT = (4, 4, 2048, 8)
# M of the expert products: C at a decode step of 8 rows (one group), and
# 8 * C at a prefill of 8 x 64 (a group a row)
MOE_M = {"phi35_moe": (4, 96), "mixtral_8x22b": (4, 160),
         "jamba_v01_52b": (4, 96)}
# the timed shapes of the JSON record: phi35_moe's gate/up product at a
# decode step (the headline) and at a prefill of 8 x 64
MOE_TIMED = ((16, 4, 4096, 6400), (16, 96, 4096, 6400))
MOE_CLI_D = 1024


def moe_configs() -> dict:
    """phi35_moe and mixtral_8x22b at full width, depth cut to MOE_LAYERS."""
    from repro_torch.configs import get_config
    return {name: dataclasses.replace(get_config(name), num_layers=layers)
            for name, layers in MOE_LAYERS.items()}


def moe_capacity(tokens_per_group: int, cfg) -> int:
    from repro_torch.models import moe
    return moe.capacity(tokens_per_group, cfg)


def expert_ekn(cfg) -> list:
    """(E, K, N) of every W8A8 expert product of `cfg`, read off the
    quantized param tree of one pattern cycle built on the meta device."""
    import torch
    from repro_torch.models.transformer import build_model
    from repro_torch.quant.lm_quant import init_quantized
    cycle = dataclasses.replace(cfg, num_layers=len(cfg.blocks))
    tree = init_quantized(build_model(cycle), torch.Generator(), "meta")
    return sorted({tuple(b["moe"][k]["qt"].shape[i] for i in (-3, -1, -2))
                   for b in tree["blocks"] if "moe" in b
                   for k in ("w_gate", "w_up", "w_down")})


def bmm_bound(E: int, M: int, K: int, N: int):
    """w8a8_bmm's bound: 2EMKN int8 operations against E(MK + KN) bytes of
    int8 in, 2EMN of bf16 out and 4EN of exponents."""
    bytes_ms = E * (M * K + K * N + 2 * M * N + 4 * N) / HBM_BYTES_PER_S \
        * 1e3
    ops_ms = 2 * E * M * K * N / INT8_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def bmm_operands(E: int, M: int, K: int, N: int, g, dev):
    """Random int8 operands and exponents on the card from `g`, W stored
    K-major (wt [E, N, K]), every expert's n its own draw."""
    import torch
    z = dict(generator=g, device=dev)
    xq = torch.randint(-128, 128, (E, M, K), dtype=torch.int8, **z)
    wt = torch.randint(-128, 128, (E, N, K), dtype=torch.int8, **z)
    xe = torch.randint(-24, 25, (), **z).float()
    n = torch.randint(-24, 25, (E, N), dtype=torch.int32, **z)
    return xq, wt, xe, n


def check_bmm(dev, cfgs, tag: str = "[moe]") -> float:
    """w8a8_bmm against its plain version on the card, bit for bit (bf16
    out), at every expert product of `cfgs` at its decode and prefill M,
    on the route gemm_plan picks (counted) and on the other one
    (mma.sync, or wgmma where TMA takes the shape), plus a ragged and a
    split-K shape; every case's experts have exponents of their own, and
    the plain product with expert 0's exponents everywhere must differ
    from it (a kernel reading expert 0's n for all would fail).  Returns
    the largest |difference| (0)."""
    import torch
    from repro_torch.kernels import q7_matmul as kq
    from repro_torch.kernels import w8a8_dense as kd
    g = torch.Generator(dev).manual_seed(SEED + 20)
    cases = []
    for cfg in cfgs:
        ekn = expert_ekn(cfg)
        want = sorted({(cfg.num_experts, cfg.d_model, cfg.d_ff),
                       (cfg.num_experts, cfg.d_ff, cfg.d_model)})
        if ekn != want:
            raise AssertionError(f"{cfg.name}'s expert products read {ekn}")
        Ms = (moe_capacity(LM_REQUESTS, cfg),
              LM_REQUESTS * moe_capacity(LM_PROMPT, cfg))
        if Ms != MOE_M[cfg.name]:
            raise AssertionError(f"{cfg.name}: expert rows {Ms}")
        cases += [(E, M, K, N, cfg.name) for E, K, N in ekn for M in Ms]
    cases += [(*MOE_RAGGED, "ragged"), (*MOE_SPLIT, "split K")]
    worst = 0.0
    for E, M, K, N, who in cases:
        xq, wt, xe, n = bmm_operands(E, M, K, N, g, dev)
        want = kd.w8a8_dense_plain(xq, wt, xe, n)
        if torch.equal(want, kd.w8a8_dense_plain(xq, wt, xe,
                                                 n[:1].expand(E, N))):
            raise AssertionError(f"{(E, M, K, N)}: the experts' exponents "
                                 "do not tell them apart")
        plan = kq.plan_for(xq, wt, b_kmajor=True)
        other = kq.GemmPlan("mma.sync", (kq.TILE_M, 128), 1) \
            if plan.route == "wgmma" else None
        if other is None and K % 16 == 0:
            other = kq.gemm_plan(M, K, N, E, 0)
        runs = [("planned", plan, kd.w8a8_bmm(xq, wt, xe, n))]
        if other is not None:
            runs.append(("forced", other,
                         kd._launch(xq, wt, xe, n, torch.bfloat16,
                                    other)[0]))
        torch.cuda.synchronize()
        for what, p, got in runs:
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"w8a8_bmm {(E, M, K, N)} ({what} "
                                     f"{p}) differs from its plain version")
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max()))
        log(f"{tag} w8a8_bmm {(E, M, K, N)} ({who}): "
            + "; ".join(f"{what} route {p.route}, tile {p.tile}, "
                        f"{p.schedule}, split {p.split}, blocks "
                        f"{p.ctas or 'a tile each'}" for what, p, _ in runs)
            + ": bit-exact against the plain version (bf16 out), per-expert "
            "exponents")
        del xq, wt, want, runs
    if not {"wgmma", "mma.sync"} <= {
            r for r, c in kd.w8a8_bmm.launches_by_route.items() if c}:
        raise AssertionError(f"w8a8_bmm left a route unused: "
                             f"{kd.w8a8_bmm.launches_by_route}")
    return worst


def moe_layers(cfg) -> int:
    return cfg.num_cycles * sum(ffn == "moe" for _, ffn in cfg.blocks)


def moe_kept(fn):
    """fn() with models.moe.moe_apply wrapped; returns fn's result and,
    for each MoE layer call, (is_decode, keep [B, S, k], experts [B, S,
    k]): whether each token's assignment was kept, and its experts in
    ascending order."""
    from repro_torch.models import moe
    orig, calls = moe.moe_apply, []

    def spy(params, x, cfg, *, is_decode=False):
        B, S, D = x.shape
        xg = x.reshape(1, B * S, D) if is_decode else x
        r = moe.route(params, xg, cfg)
        shape = (B, S, cfg.experts_per_tok)
        calls.append((is_decode, r.keep.reshape(shape),
                      r.eidx.reshape(shape).sort(-1).values))
        return orig(params, x, cfg, is_decode=is_decode)
    moe.moe_apply = spy
    try:
        return fn(), calls
    finally:
        moe.moe_apply = orig


def prefill_drops(res, cfg) -> list:
    """Assignments dropped in each MoE layer at a prefill of the served
    prompts."""
    import torch
    with torch.inference_mode():
        _, calls = moe_kept(lambda: res["model"].prefill(
            res["params"], {"inputs": res["prompts"]}, alloc=512))
    return [int((~keep).sum()) for _, keep, _ in calls]


def moe_consistency(params, cfg, dev, quant: str) -> list:
    """prefill(t[:64]) then decode_step(t[64]) against prefill(t[:65]),
    held to the CPU tests' tolerance (float; W8A8 printed only) on the
    rows whose compared token kept all its assignments at every MoE layer
    on both sides, to the same experts: at the config's capacity factor,
    and at E / k, where no expert can overflow.  A decode step groups
    the batch (8 tokens), a prefill each row (65), so a token dropped on
    one side only is the reference's semantics, not a fault; nor is a
    token whose router, a near-tie, reads the two sides' bf16 roundings
    as different experts.  Returns the lines; raises when a gated row is
    beyond the tolerance, or no row was gated (W8A8: printed only; its
    prefill(65) and decode step quantize the router's inputs with other
    activation exponents, so at 32 layers every compared token of
    phi35_moe met other experts at some layer)."""
    import torch
    from repro_torch.models.transformer import build_model
    lines, gated = [], 0
    for cf in (cfg.capacity_factor, cfg.num_experts / cfg.experts_per_tok):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        (a, b), calls = moe_kept(lambda: decode_vs_prefill(
            build_model(c), params, c, dev))
        full = [(k[:, -1], e[:, -1]) for d, k, e in calls
                if not d and k.shape[1] == LM_PROMPT + 1]
        dec = [(k[:, 0], e[:, 0]) for d, k, e in calls if d]
        if len(full) != moe_layers(cfg) or len(dec) != moe_layers(cfg):
            raise AssertionError(f"{cfg.name}: {len(full)} prefill and "
                                 f"{len(dec)} decode MoE calls")
        kept = torch.stack([k1.all(-1) & k2.all(-1)
                            for (k1, _), (k2, _) in zip(full, dec)]).all(0)
        same = torch.stack([(e1 == e2).all(-1)
                            for (_, e1), (_, e2) in zip(full, dec)]).all(0)
        rows = kept & same
        err = (a - b).abs()
        beyond = (err > CONSIST_ATOL + CONSIST_RTOL * a.abs())[rows]
        over = int(beyond.sum())
        worst = float(err[rows].max()) if rows.any() else float("nan")
        agree = int((a.argmax(-1) == b.argmax(-1))[rows].sum())
        gated += int(rows.sum())
        line = (f"{cfg.name} {quant} capacity factor {cf:g} (C "
                f"{moe_capacity(LM_PROMPT + 1, c)} at "
                f"prefill({LM_PROMPT + 1}),"
                f" {moe_capacity(LM_REQUESTS, c)} at decode): decode after "
                f"prefill({LM_PROMPT}) vs prefill({LM_PROMPT + 1}) on the "
                f"{int(rows.sum())} rows whose compared token kept every "
                f"assignment at every layer on both sides, to the same "
                f"experts ({int((~kept).sum())} set aside for a drop, "
                f"{int((kept & ~same).sum())} for other experts): max |diff| "
                f"{worst:.4f}, {over} logits beyond atol {CONSIST_ATOL} + "
                f"rtol {CONSIST_RTOL}, argmax equal on {agree}; all rows: "
                f"max |diff| {float(err.max()):.4f}")
        lines.append(line + (" (printed, not gated: W8A8)" if quant == "w8a8"
                             else " (gated)"))
        if quant != "w8a8" and over:
            raise AssertionError(line)
    if quant != "w8a8" and gated == 0:
        raise AssertionError(f"{cfg.name} {quant}: no row gated: {lines}")
    lines.append(f"{cfg.name} {quant}: {gated} rows gated over both "
                 "capacity factors")
    return lines


def moe_phase(dev, card: str) -> dict:
    """Phase 13; returns the w8a8_bmm record's pieces."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import w8a8_dense as kd
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] device memory before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cfgs = moe_configs()
    err = check_bmm(dev, cfgs.values())
    err = max(err, check_dense(dev, [get_config("phi35_moe")], "[moe]"))
    runs, counts, dense = {}, {}, {}
    for name, cfg in cfgs.items():
        runs[f"{name}_float"] = serve_lm(cfg, dev, card, "none", "moe",
                                         "[moe]")
        kd.w8a8_bmm.launches = kd.w8a8_dense.launches = 0
        q = runs[f"{name}_w8a8"] = serve_lm(cfg, dev, card, "w8a8", "moe",
                                            "[moe]")
        L = cfg.num_layers
        want = (3 * L * LM_GEN, (4 * L + 1) * LM_GEN)
        got = (q["bmm_launches"], q["launches"])
        log(f"[moe] {name} w8a8: w8a8_bmm launched {got[0]} times over the "
            f"serve call, expected {want[0]} (3 expert products x {L} "
            f"layers, per forward, 1 prefill + {LM_GEN - 1} decode steps); "
            f"w8a8_dense {got[1]}, expected {want[1]} (wq, wk, wv, wo x {L}"
            f" + lm_head, per forward)")
        if got != want:
            raise AssertionError(f"{name} w8a8: launches {got}, not {want}")
        counts[name], dense[f"moe_{name}"] = got
        agree = float((q["tokens"] == runs[f"{name}_float"]["tokens"])
                      .mean())
        log(f"[moe] {name}: W8A8 and float greedy tokens agree on "
            f"{agree:.1%} (not gated)")

    run_cli(["--arch", "phi35_moe", "--quant", "w8a8", "--d-model",
             MOE_CLI_D], "[moe]", card)
    for r in runs.values():
        r.pop("tokens")
    # phi35_moe in full, W8A8, counted from 0 just before
    full = runs["phi35_moe_full_w8a8"] = phi35_full(dev, card)
    counts["phi35_moe_full"] = full["bmm_launches"]
    dense["moe_phi35_moe_full"] = full["launches"]
    return dict(launches=counts["phi35_moe"], launches_by_path={
        f"moe_{k}": v for k, v in counts.items()}, max_abs_err=err,
        runs=runs, dense_launches_by_path=dense)


# ---------------------------------------------------------------------------
# phases 14-15: the SSM, hybrid and encoder-decoder LMs
# (repro_torch.models.{mamba,xlstm}, EncDecLM), on w8a8_dense / w8a8_bmm
# ---------------------------------------------------------------------------
# W8A8 launches a forward pass (a prefill, or one decode step), predicted
# from the code: xlstm_1_3b 42 mLSTM blocks x 5 products (up_proj, wq, wk,
# wv, down_proj) + 6 sLSTM blocks x 3 (wx, ffn_up, ffn_down) + lm_head;
# jamba_v01_52b's cycle 7 mamba x 2 (in_proj, out_proj) + 4 attention
# products + 4 MLP blocks x 3 + lm_head on w8a8_dense, 4 MoE blocks x 3
# expert products on w8a8_bmm
SSM_DENSE_PER_PASS = {"xlstm_1_3b": 229, "jamba_v01_52b": 31}
SSM_BMM_PER_PASS = {"xlstm_1_3b": 0, "jamba_v01_52b": 12}
# seamless_m4t_medium: the encoder runs once, at prefill (12 layers x (4
# attention + 3 MLP products); the frontend stays float), the decoder's
# prefill 12 x (4 self + 4 cross (wq, then wk and wv of the encoder's
# output, wo) + 3 MLP) + lm_head = 84 + 132 + 1; a decode step 12 x (4
# self + 2 cross (wq, wo: the cross K/V are cached) + 3) + lm_head
ENCDEC_DENSE = (217, 109)
ENCDEC_CLI = ["--arch", "seamless_m4t_medium", "--no-reduce", "--quant",
              "w8a8"]
# an mLSTM decode step of xlstm_1_3b at 8 requests reads and writes C,
# float32 [8, 4, 1024, 1024]: twice 134.2 MB
MLSTM_TIMED_CALLS = 20


def ssm_configs() -> dict:
    """xlstm_1_3b in full (48 layers); jamba_v01_52b at full width cut to
    one 8-layer pattern cycle (51.57 B parameters in full, 103 GB of
    bf16, over the card's 80 GB)."""
    from repro_torch.configs import get_config
    jamba = get_config("jamba_v01_52b")
    return {"xlstm_1_3b": get_config("xlstm_1_3b"),
            "jamba_v01_52b": dataclasses.replace(
                jamba, num_layers=len(jamba.blocks))}


def serve_counted(cfg, dev, card: str, tag: str, consist: str,
                  dense_per_pass: tuple, bmm_per_pass: int = 0) -> dict:
    """`cfg` served in bf16 (decode/prefill gate `consist`) and in W8A8
    (printed), w8a8_dense and w8a8_bmm counted from 0 just before the
    W8A8 run and read just after, required to launch exactly as
    predicted: `dense_per_pass` (a prefill, a decode step) and
    `bmm_per_pass` a forward pass, 1 prefill and LM_GEN - 1 decode
    steps."""
    from repro_torch.kernels import w8a8_dense as kd
    f = serve_lm(cfg, dev, card, "none", consist, tag)
    kd.w8a8_dense.launches = kd.w8a8_bmm.launches = 0
    q = serve_lm(cfg, dev, card, "w8a8",
                 "moe" if consist == "moe" else "print", tag)
    pre, step = dense_per_pass
    want = (pre + step * (LM_GEN - 1), bmm_per_pass * LM_GEN)
    got = (q["launches"], q["bmm_launches"])
    log(f"{tag} {cfg.name} w8a8: w8a8_dense launched {got[0]} times over "
        f"the serve call, expected {want[0]} ({pre} at the prefill + "
        f"{step} x {LM_GEN - 1} decode steps); w8a8_bmm {got[1]}, expected "
        f"{want[1]} ({bmm_per_pass} a forward pass)")
    if got != want:
        raise AssertionError(f"{cfg.name} w8a8: launches {got}, not {want}")
    agree = float((q["tokens"] == f["tokens"]).mean())
    log(f"{tag} {cfg.name}: W8A8 and float greedy tokens agree on "
        f"{agree:.1%} (not gated)")
    for r in (f, q):
        r.pop("tokens")
    return dict(float=f, w8a8=q, launches=got, token_agreement=agree)


def ssm_phase(dev, card: str) -> dict:
    """Phase 14; returns the runs and the kernels' launches by path."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ssm] device memory before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cfgs = ssm_configs()
    err = max(check_dense(dev, cfgs.values(), "[ssm]"),
              check_bmm(dev, [cfgs["jamba_v01_52b"]], "[ssm]"))
    runs = {}
    for name, cfg in cfgs.items():
        per_pass = SSM_DENSE_PER_PASS[name]
        runs[name] = serve_counted(
            cfg, dev, card, "[ssm]", "moe" if cfg.num_experts else "drift",
            (per_pass, per_pass), SSM_BMM_PER_PASS[name])
    # jamba_v01_52b in full, W8A8, counted from 0 just before
    full = runs["jamba_v01_52b_full_w8a8"] = jamba_full(dev, card)
    return dict(runs=runs, max_abs_err=err, dense={
        **{f"ssm_{k}": runs[k]["launches"][0] for k in cfgs},
        "ssm_jamba_v01_52b_full": full["launches"]}, bmm={
        "ssm_jamba_v01_52b": runs["jamba_v01_52b"]["launches"][1],
        "ssm_jamba_v01_52b_full": full["bmm_launches"]})


def encdec_phase(dev, card: str) -> dict:
    """Phase 15; returns the runs and w8a8_dense's launches."""
    import torch
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("seamless_m4t_medium")
    err = check_dense(dev, [cfg], "[encdec]")
    run = serve_counted(cfg, dev, card, "[encdec]", "tol", ENCDEC_DENSE)
    run_cli(ENCDEC_CLI, "[encdec]", card)
    return dict(runs={cfg.name: run}, max_abs_err=err, dense={
        "encdec_seamless_m4t_medium": run["launches"][0]})


# ---------------------------------------------------------------------------
# phases 12-14's W8A8 runs at full depth: the LMs whose bf16 tree is over
# the card (qwen2_72b 145.42 GB, jamba_v01_52b 103.15 GB, phi35_moe 83.75
# GB), their int8 trees drawn one cycle at a time (`init_quantized`)
# ---------------------------------------------------------------------------
# (w8a8_dense, w8a8_bmm) launches of a serve call (1 prefill + 31 decode
# steps, each one forward pass), from the code: qwen2_72b (7 dense
# products x 80 blocks + lm_head) x 32 = 17,952; phi35_moe (wq, wk, wv, wo
# x 32 + lm_head) x 32 = 4,128 and its 3 expert products x 32 layers x 32
# = 3,072 on w8a8_bmm; jamba_v01_52b's 4 cycles of SSM_DENSE_PER_PASS's
# 30 (lm_head once: 30 x 4 + 1) x 32 = 3,872 and 12 x 4 x 32 = 1,536
FULL_W8A8 = {"qwen2_72b": (17952, 0), "phi35_moe": (4128, 3072),
             "jamba_v01_52b": (3872, 1536)}
FULL_CLI = ["--arch", "qwen2_72b", "--no-reduce", "--quant", "w8a8"]
BITS_LAYERS = 16      # phi35_moe's bf16 tree (42 GB) and int8 (21 GB) fit


def serve_full(name: str, dev, card: str, tag: str, consist: str) -> dict:
    """`name` in full, W8A8 alone (its bf16 tree is over the card, so
    no float run beside it): w8a8_dense and w8a8_bmm counted from 0
    just before the serve call and read just after, required to equal
    FULL_W8A8; its peak printed beside its int8 tree's GiB and the
    card's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import w8a8_dense as kd
    cfg = get_config(name)
    kd.w8a8_dense.launches = kd.w8a8_bmm.launches = 0
    q = serve_lm(cfg, dev, card, "w8a8", consist, tag)
    got, want = (q["launches"], q["bmm_launches"]), FULL_W8A8[name]
    log(f"{tag} {name} w8a8 in full ({cfg.num_layers} layers): w8a8_dense "
        f"launched {got[0]} times over the serve call, w8a8_bmm {got[1]}; "
        f"expected {want[0]} and {want[1]}")
    if got != want:
        raise AssertionError(f"{name} w8a8 in full: launches {got}, not "
                             f"{want}")
    q["card_gib"] = torch.cuda.get_device_properties(dev).total_memory \
        / 2**30
    log(f"{tag} {card} | {name} w8a8 in full: peak {q['peak_gib']:.2f} GiB "
        f"(init and serve call) against its int8 tree's "
        f"{q['param_mib'] / 1024:.2f} GiB and the card's "
        f"{q['card_gib']:.2f} GiB")
    q.pop("tokens")
    return q


def streamed_bits(cfg, dev, card: str, tag: str) -> dict:
    """On the card's generator: the W8A8 tree drawn one cycle at a time
    (`init_quantized`) against `quantize_lm_params` of the whole float
    tree from the same seed, leaf for leaf (`torch.equal`), each init's
    seconds and its peak above what was allocated before it."""
    import torch
    from repro_torch.models.transformer import build_model
    from repro_torch.quant.lm_quant import (init_quantized,
                                            quantize_lm_params,
                                            quantized_bytes)
    from repro_torch.tree import leaves_with_paths
    model = build_model(cfg)
    out = {}

    def timed(what, fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = fn(torch.Generator(dev).manual_seed(SEED))
        torch.cuda.synchronize()
        out[what] = dict(s=time.perf_counter() - t0, peak_gib=(
            torch.cuda.max_memory_allocated() - base) / 2**30)
        return tree
    got = leaves_with_paths(timed("streamed", lambda g: init_quantized(
        model, g, dev)))
    want = leaves_with_paths(timed("whole", lambda g: quantize_lm_params(
        model.init(g, dev), consume=True)))
    if [p for p, _ in got] != [p for p, _ in want]:
        raise AssertionError(f"{cfg.name}: the streamed tree's leaves differ")
    for (path, a), (_, b) in zip(got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{cfg.name}: the streamed tree differs at "
                                 f"{path}")
    out["leaves"] = len(got)
    out["int8_gib"] = quantized_bytes([t for _, t in got]) / 2**30
    log(f"{tag} {card} | {cfg.name} ({cfg.num_layers} layers) on the card's "
        f"generator: the W8A8 tree drawn one cycle at a time equals "
        f"quantize_lm_params of the whole float tree, {out['leaves']} "
        f"leaves ({out['int8_gib']:.2f} GiB) bit for bit; init "
        f"{out['streamed']['s']:.1f} s, peak {out['streamed']['peak_gib']:.2f}"
        f" GiB, against {out['whole']['s']:.1f} s, peak "
        f"{out['whole']['peak_gib']:.2f} GiB above the streamed tree")
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def qwen2_full(dev, card: str) -> dict:
    """Phase 12's qwen2_72b in full (80 layers, 72.7 B parameters): the
    serve call (consistency printed: a W8A8 prefill(65) quantizes its
    activations with other exponents than prefill(64) and a decode step),
    then the CLI in its own process."""
    run = serve_full("qwen2_72b", dev, card, "[lm]", "print")
    run_cli(FULL_CLI, "[lm]", card)
    return run


def phi35_full(dev, card: str) -> dict:
    """Phase 13's phi35_moe: the streamed tree's bits at BITS_LAYERS, then
    all 32 layers served in W8A8 (its MoE consistency printed)."""
    from repro_torch.configs import get_config
    bits = streamed_bits(dataclasses.replace(get_config("phi35_moe"),
                                             num_layers=BITS_LAYERS),
                         dev, card, "[moe]")
    run = serve_full("phi35_moe", dev, card, "[moe]", "moe")
    return dict(run, streamed_bits=bits)


def jamba_full(dev, card: str) -> dict:
    """Phase 14's jamba_v01_52b in full (4 cycles, 32 layers), W8A8."""
    return serve_full("jamba_v01_52b", dev, card, "[ssm]", "moe")


# ---------------------------------------------------------------------------
# phase 16: LM training (repro_torch.launch.{train,steps}), in a process of
# its own (deterministic algorithms, CUBLAS_WORKSPACE_CONFIG)
# ---------------------------------------------------------------------------
LM_TRAIN_DIR = ROOT / "build" / "lm_train_smoke"
LM_TRAIN_ARGV = ["--arch", "stablelm_3b", "--steps", "12", "--batch", "8",
                 "--seq", "256", "--log-every", "1"]
# (b): the same width cut to 2 of 32 layers (0.42 B parameters), so that
# its three checkpoints (5.0 GB each) stay well inside the 45 GiB a chip
# call may write to its disk (one full-size snapshot is 33.5 GB), and
# the whole run inside its time limit
LM_RESUME_LAYERS = 2
LM_RESUME_CKPT = ["--ckpt-every", "4"]
LM_TRAIN_FAULT = 6                 # the crashed run raises before step 6
LM_TRAIN_GC_STEPS = 4              # --grad-compress steps
LM_TRAIN_OTHERS = ("paligemma_3b", "phi35_moe", "xlstm_1_3b",
                   "jamba_v01_52b", "seamless_m4t_medium")
LM_TRAIN_OTHER_ARGV = ["--reduce", "--steps", "4", "--batch", "4", "--seq",
                       "128", "--log-every", "1"]
# the port's CPU step 0 against the card's, on the same weights and batch
# (measured at most 1.55e-4 and 3.75e-3, xlstm's grad norm, on an H100
# 80GB HBM3 at 700 W)
LM_TRAIN_CPU_RTOL = {"loss": 1e-3, "grad_norm": 1.5e-2}
LM_TRAIN_LEARN_LR = 1e-3           # the learning check's constant lr
LM_TRAIN_LEARN_STEPS = 4


def train_lm_phase(card: str) -> dict:
    """Phase 16 in a process of its own (`--train-lm`): its lines are
    logged here and its summary returned."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train-lm] device memory before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved by this "
        f"process")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--train-lm"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=1000)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0:
        raise AssertionError(f"phase 16 (--train-lm): exit {proc.returncode}"
                             f"\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-5000:]}")
    log(f"[train-lm] the phase's process: exit 0 in "
        f"{time.perf_counter() - t:.1f} s")
    return json.loads(lines[-1])["train_lm"]


def train_lm_cli(argv, fail_at=None) -> tuple:
    """`launch.train.main(argv)` with its printed lines captured and
    logged: (its result, its stdout).  With `fail_at`, the first time the
    loop asks for batch `fail_at` it raises instead (a fault for the
    restart path)."""
    import contextlib
    import io
    from unittest import mock
    from repro_torch.launch import train
    real, armed = train.make_batch, [fail_at is not None]

    def make_batch(cfg, task, i, batch, device):
        if armed[0] and i == fail_at:
            armed[0] = False
            raise RuntimeError(f"injected fault before step {i}")
        return real(cfg, task, i, batch, device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            mock.patch.object(train, "make_batch", make_batch):
        res = train.main(argv)
    out = buf.getvalue()
    for line in out.strip().splitlines():
        log(f"[train-lm]   {line}")
    return res, out


def task_seq(cfg) -> int:
    argv = LM_TRAIN_ARGV if cfg.name == "stablelm_3b" else \
        LM_TRAIN_OTHER_ARGV
    return int(argv[argv.index("--seq") + 1])


def task_batch(cfg) -> int:
    argv = LM_TRAIN_ARGV if cfg.name == "stablelm_3b" else \
        LM_TRAIN_OTHER_ARGV
    return int(argv[argv.index("--batch") + 1])


def train_summary(res, tokens: int) -> dict:
    log_ = res["log"]
    warm = [r["ms"] for r in log_[1:]]
    ms = statistics.median(warm)
    return {"ms": ms, "tok_per_s": tokens / (ms / 1e3),
            "first_ms": log_[0]["ms"], "losses": [r["loss"] for r in log_],
            "grad_norms": [r["grad_norm"] for r in log_]}


def check_finite(tag: str, res) -> None:
    import math
    rows = res["log"]
    if not rows or not all(math.isfinite(r["loss"])
                           and math.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError(f"{tag}: a loss or grad norm is not finite: "
                             f"{rows}")


def learns(tag: str, cfg, dev, n: int = LM_TRAIN_LEARN_STEPS) -> dict:
    """The port's train step with AdamW at a constant lr of
    LM_TRAIN_LEARN_LR (the CLI's cosine schedule warms up over 2,000
    steps, so its lr stays below 2e-6 in a smoke run's few steps and its
    loss moves by noise): batch 0's loss before and after `n` steps on
    batches 0..n-1 of the token stream, which must fall."""
    import torch
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_batch
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.adam import AdamW
    model = build_model(cfg)
    state = steps.init_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                   dev)
    opt = AdamW(lr=LM_TRAIN_LEARN_LR, weight_decay=0.1, clip_norm=1.0)
    task = TokenTask(cfg.vocab_size, task_seq(cfg), seed=7)
    B = task_batch(cfg)
    b0 = make_batch(cfg, task, 0, B, dev)
    with torch.no_grad():
        before = float(model.train_loss(state["params"], b0)[0])
    split = []
    for i in range(n):
        # make_train_step's two calls, timed apart (host clock after a
        # synchronize)
        batch = make_batch(cfg, task, i, B, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, grads = steps.loss_and_grads(model, state["params"], batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.update_(grads, state["opt"], state["params"])
        torch.cuda.synchronize()
        split.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    with torch.no_grad():
        after = float(model.train_loss(state["params"], b0)[0])
    fb, up = (statistics.median(x[k] for x in split[1:]) for k in (0, 1))
    log(f"{tag}: batch 0's loss {before:.5f} -> {after:.5f} after {n} "
        f"steps of AdamW at a constant lr {LM_TRAIN_LEARN_LR:g}; a step's "
        f"split (median of steps 1-{n - 1}): forward + backward {fb:.1f} "
        f"ms, the in-place AdamW {up:.1f} ms")
    if not after < before:
        raise AssertionError(f"{tag}: batch 0's loss did not fall: "
                             f"{before} -> {after}")
    return {"batch0_before": before, "batch0_after": after,
            "fwd_bwd_ms": fb, "adamw_ms": up}


def train_lm_child(dev, card: str) -> dict:
    """Phase 16 (`chip_smoke.py --train-lm`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_batch, reduced
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.models.transformer import build_model
    from repro_torch.tree import leaves, tree_map
    out = {}
    torch.use_deterministic_algorithms(True)
    shutil.rmtree(LM_TRAIN_DIR, ignore_errors=True)
    cfg = get_config("stablelm_3b")
    B, S = task_batch(cfg), task_seq(cfg)
    tokens = B * S

    # (a) stablelm_3b in full through the CLI's main
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res, _ = train_lm_cli(LM_TRAIN_ARGV)
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in leaves(res["state"]["params"]))
    summ = train_summary(res, tokens)
    check_finite("[train-lm] stablelm_3b", res)
    flops = 6 * n_params * tokens
    flops_remat = 8 * n_params * tokens
    # bytes: the weights read by the forward, the recompute and the
    # backward (bf16), the optimizer's reads of p, g (bf16), m, v (f32)
    # and its writes of p, m, v
    state_bytes = n_params * (3 * 2 + 2 + 2 + 4 + 4 + 2 + 4 + 4)
    bound = {"flop_ms": flops / BF16_OPS_PER_S * 1e3,
             "flop_remat_ms": flops_remat / BF16_OPS_PER_S * 1e3,
             "bytes_ms": state_bytes / HBM_BYTES_PER_S * 1e3}
    bound["bound_ms"] = max(bound["flop_remat_ms"], bound["bytes_ms"])
    log(f"[train-lm] {card} | stablelm_3b in full ({n_params / 1e9:.3f} B "
        f"params, {cfg.num_layers} layers, d {cfg.d_model}), B {B} x S {S}, "
        f"deterministic algorithms on: 12 steps in {wall:.1f} s; median "
        f"warm step {summ['ms']:.1f} ms ({summ['tok_per_s']:.0f} tok/s), "
        f"step 0 {summ['first_ms']:.1f} ms; peak device memory "
        f"{peak:.2f} GiB")
    log(f"[train-lm] stablelm_3b loss step 0 {summ['losses'][0]:.4f}, step "
        f"11 {summ['losses'][-1]:.4f}; grad norm step 0 "
        f"{summ['grad_norms'][0]:.4f}, step 11 {summ['grad_norms'][-1]:.4f} "
        f"(lr <= {3e-4 * 12 / 2000:.2e} in the schedule's warmup)")
    log(f"[train-lm] stablelm_3b step bound: 6 N T = {flops / 1e12:.1f} "
        f"TFLOP ({bound['flop_ms']:.1f} ms), 8 N T with the remat's extra "
        f"forward = {flops_remat / 1e12:.1f} TFLOP "
        f"({bound['flop_remat_ms']:.1f} ms) at {BF16_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s (H100 SXM dense bf16, 700 W data sheet; this card: "
        f"{card}); {state_bytes / 1e9:.1f} GB of weights and optimizer "
        f"state ({bound['bytes_ms']:.1f} ms at 3.35 TB/s); the step is "
        f"{summ['ms'] / bound['bound_ms']:.1f} x its bound")
    if len(res["log"]) != 12 or res["attempts"] != 1:
        raise AssertionError(f"(a): {len(res['log'])} steps, "
                             f"{res['attempts']} attempts")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    learned = learns("[train-lm] stablelm_3b in full", cfg, dev)
    out["stablelm_3b"] = dict(summ, peak_gib=peak, n_params=n_params,
                              wall_s=wall, **bound, **learned)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) at full width, LM_RESUME_LAYERS deep: a straight run, then the
    # same command with checkpoints and a fault before LM_TRAIN_FAULT
    from unittest import mock
    from repro_torch.launch import train
    cut = cfg.scaled(num_layers=LM_RESUME_LAYERS)
    with mock.patch.object(train, "get_config", lambda arch: cut):
        res, _ = train_lm_cli(LM_TRAIN_ARGV)
        want = [x.cpu() for x in leaves(res["state"])]
        del res
        b_dir = str(LM_TRAIN_DIR / "b")
        t = time.perf_counter()
        res, text = train_lm_cli(LM_TRAIN_ARGV + LM_RESUME_CKPT
                                 + ["--ckpt-dir", b_dir],
                                 fail_at=LM_TRAIN_FAULT)
        wall = time.perf_counter() - t
    for line in (f"[restart 1/2] RuntimeError: injected fault before step "
                 f"{LM_TRAIN_FAULT}", "[resume] from step 4"):
        if line not in text:
            raise AssertionError(f"(b): no line {line!r}")
    saved = sorted(p.name for p in (LM_TRAIN_DIR / "b").iterdir())
    if saved != ["LATEST", "step_00000004.npz", "step_00000008.npz",
                 "step_00000012.npz"]:
        raise AssertionError(f"(b) checkpoints: {saved}")
    snap = (LM_TRAIN_DIR / "b" / "step_00000012.npz").stat().st_size
    got = leaves(res["state"])
    differ = [i for i, (x, y) in enumerate(zip(got, want))
              if not torch.equal(x.cpu(), y)]
    if len(got) != len(want) or differ or res["attempts"] != 2:
        raise AssertionError(f"(b): {len(differ)} of {len(want)} leaves "
                             f"differ from the straight run "
                             f"({res['attempts']} attempts)")
    n_cut = sum(p.numel() for p in leaves(res["state"]["params"]))
    log(f"[train-lm] {card} | stablelm_3b at full width, {LM_RESUME_LAYERS} "
        f"of {cfg.num_layers} layers ({n_cut / 1e9:.3f} B params), a fault "
        f"before step {LM_TRAIN_FAULT}, resumed from "
        f"step 4: after step 12 its params, m, v and steps equal the "
        f"straight run's bit for bit ({len(want)} leaves); {wall:.1f} s for "
        f"the two attempts (three {snap / 1e9:.2f} GB checkpoints written, "
        f"one read, 5 s backoff)")
    out["resume"] = {"leaves": len(want), "wall_s": wall, "equal": True,
                     "layers": LM_RESUME_LAYERS, "snapshot_bytes": snap}
    del res, got, want
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(LM_TRAIN_DIR / "b")

    # (c) --grad-compress, the same model and batch
    torch.cuda.reset_peak_memory_stats()
    argv = list(LM_TRAIN_ARGV)
    argv[argv.index("--steps") + 1] = str(LM_TRAIN_GC_STEPS)
    res, _ = train_lm_cli(argv + ["--grad-compress"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    summ = train_summary(res, tokens)
    errs = leaves(res["state"]["err"])
    if not all(torch.isfinite(e).all() for e in errs) or \
            not any(e.abs().max() > 0 for e in errs):
        raise AssertionError("(c): the error buffer is not finite or zero")
    log(f"[train-lm] {card} | stablelm_3b --grad-compress: median warm "
        f"step {summ['ms']:.1f} ms ({summ['tok_per_s']:.0f} tok/s) against "
        f"{out['stablelm_3b']['ms']:.1f} ms without; peak device memory "
        f"{peak:.2f} GiB (the float32 error buffer); loss step 0 "
        f"{summ['losses'][0]:.4f}, step {LM_TRAIN_GC_STEPS - 1} "
        f"{summ['losses'][-1]:.4f}")
    out["grad_compress"] = dict(summ, peak_gib=peak)
    del res, errs
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the other families at --reduce: first one step of each under
    # deterministic algorithms, naming any op that has no deterministic
    # CUDA kernel (it raises there); then their runs with them off
    out["deterministic"] = {}
    for arch in LM_TRAIN_OTHERS:
        cfg = reduced(get_config(arch))
        params = build_model(cfg).init(torch.Generator(dev).manual_seed(0),
                                       dev)
        batch = make_batch(cfg, TokenTask(cfg.vocab_size, task_seq(cfg),
                                          seed=7), 0, task_batch(cfg), dev)
        try:
            steps.loss_and_grads(build_model(cfg), params, batch)
            verdict = "ran"
        except RuntimeError as e:           # names the op, then go on
            verdict = str(e).splitlines()[0][:200]
        out["deterministic"][arch] = verdict
        del params, batch
    log(f"[train-lm] one step of each family at --reduce under "
        f"deterministic algorithms: {out['deterministic']}")
    torch.use_deterministic_algorithms(False)
    out["others"] = {}
    for arch in LM_TRAIN_OTHERS:
        cfg = reduced(get_config(arch))
        res, _ = train_lm_cli(["--arch", arch] + LM_TRAIN_OTHER_ARGV)
        check_finite(f"[train-lm] {arch}", res)
        # the port's CPU step 0 on the card's initial weights and batch 0
        params = build_model(cfg).init(torch.Generator(dev).manual_seed(0),
                                       dev)
        params = tree_map(lambda x: x.cpu(), params)
        batch = make_batch(cfg, TokenTask(cfg.vocab_size, task_seq(cfg),
                                          seed=7), 0, task_batch(cfg), "cpu")
        loss, _, grads = steps.loss_and_grads(build_model(cfg), params,
                                              batch)
        from repro_torch.optim.adam import global_norm
        cpu = {"loss": float(loss), "grad_norm": float(global_norm(grads))}
        card0 = {k: res["log"][0][k] for k in cpu}
        rel = {k: abs(card0[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
        summ = train_summary(res, task_seq(cfg) * task_batch(cfg))
        log(f"[train-lm] {card} | {arch} --reduce (d {cfg.d_model}, "
            f"{cfg.num_layers} layers): median warm step {summ['ms']:.1f} "
            f"ms; step 0 loss {card0['loss']:.5f} / grad norm "
            f"{card0['grad_norm']:.5f} on the card, {cpu['loss']:.5f} / "
            f"{cpu['grad_norm']:.5f} on the CPU (relative "
            f"{rel['loss']:.2e} / {rel['grad_norm']:.2e})")
        for k, tol in LM_TRAIN_CPU_RTOL.items():
            if not rel[k] <= tol:
                raise AssertionError(f"{arch}: step 0's {k} on the card "
                                     f"{card0[k]} vs the CPU {cpu[k]}: "
                                     f"{rel[k]:.2e} > {tol}")
        del res, params, grads
        learned = learns(f"[train-lm] {arch} --reduce", cfg, dev)
        out["others"][arch] = dict(summ, cpu=cpu, card=card0, rel=rel,
                                   **learned)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def kernel_records(fn) -> int:
    """Device activities (kernels, copies, sets) of one fn() call in a
    torch.profiler trace (CUDA activity; the host's runtime calls, which
    the trace also holds, left out): the larger count of two traces,
    since a trace may drop records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA))
    return max(counts)


def mlstm_decode_device(params, cfg, dev, card: str, quant: str) -> dict:
    """One mLSTM layer's decode step (xlstm_1_3b's first block, 8 rows)
    from the profiler, every kernel of the call, against its bound: C
    read and written once (state) and, beside it, the layer's weights
    read once."""
    import torch
    from repro_torch.models import layers, xlstm
    from repro_torch.models.transformer import _cycle
    from repro_torch.quant.lm_quant import quantized_bytes
    p = _cycle(params["blocks"][0], 0)["mlstm"]
    cache = xlstm.init_mlstm_cache(cfg, LM_REQUESTS, dev)
    x = torch.randn((LM_REQUESTS, 1, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(SEED + 31)
                    ).to(torch.bfloat16)
    parts = {}
    with torch.inference_mode(), layers.full_bf16_sums():
        ms = device_ms(lambda: xlstm.mlstm_apply(p, x, cfg, mode="decode",
                                                 cache=cache), None,
                       calls=MLSTM_TIMED_CALLS, parts=parts)
        launches = kernel_records(lambda: xlstm.mlstm_apply(
            p, x, cfg, mode="decode", cache=cache))
    state = sum(t.numel() * t.element_size() for t in cache.values())
    weights = quantized_bytes(p)
    bound_state = 2 * state / HBM_BYTES_PER_S * 1e3
    bound = (2 * state + weights) / HBM_BYTES_PER_S * 1e3
    top = sorted(parts.items(), key=lambda kv: -kv[1])[:6]
    log(f"[recurrent] {card} | xlstm_1_3b {quant}: one mLSTM decode layer (8 "
        f"rows): {ms:.5f} device ms, {launches} device launches; bound "
        f"{bound_state:.5f} ms for the state alone ({2 * state / 1e6:.1f} "
        f"MB read + written at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
        f"{bound:.5f} ms with the layer's {weights / 1e6:.1f} MB of "
        f"weights; largest kernels: "
        + ", ".join(f"{k.split('(')[0].split('<')[0][-40:]} {v:.5f}"
                    for k, v in top))
    return dict(device_ms=ms, launches=launches, bound_state_ms=bound_state,
                bound_ms=bound, state_bytes=state, weight_bytes=weights)


def recurrent_device_counts(dev, card: str) -> dict:
    """(run after phase 9, with phase 8: torch.profiler sessions) the
    device launches of one prefill of 8 x 64 tokens and of one decode
    step for each config of phases 14-15, bf16 and W8A8, on weights from
    seed 0; and one mLSTM decode layer's device time against its
    bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.models.transformer import build_model, decode_alloc
    from repro_torch.quant.lm_quant import init_quantized
    cfgs = dict(ssm_configs(),
                seamless_m4t_medium=get_config("seamless_m4t_medium"))
    out = {}
    for name, cfg in cfgs.items():
        model = build_model(cfg)
        for quant in ("none", "w8a8"):
            gc.collect()
            torch.cuda.empty_cache()
            gen = torch.Generator(dev).manual_seed(SEED)
            params = init_quantized(model, gen, dev) if quant == "w8a8" \
                else model.init(gen, dev)
            toks = torch.as_tensor(TokenTask(cfg.vocab_size, LM_PROMPT,
                                             seed=3).batch(0, LM_REQUESTS)
                                   ["inputs"], device=dev)
            batch = dict(extra_inputs(cfg, dev), inputs=toks)
            alloc = decode_alloc(LM_PROMPT + LM_GEN)
            one = torch.ones((LM_REQUESTS, 1), dtype=torch.int32,
                             device=dev)
            with torch.inference_mode():
                _, cache = model.prefill(params, batch, alloc=alloc)
                pre = kernel_records(lambda: model.prefill(params, batch,
                                                           alloc=alloc))
                step = kernel_records(lambda: model.decode_step(
                    params, cache, one, LM_PROMPT))
            row = dict(prefill=pre, decode_step=step)
            log(f"[recurrent] {card} | {name} {quant}: {pre} device "
                f"launches a prefill of {LM_REQUESTS}x{LM_PROMPT}, {step} a "
                f"decode step ({cfg.num_layers} layers)")
            if name == "xlstm_1_3b":
                row["mlstm_decode"] = mlstm_decode_device(params, cfg, dev,
                                                          card, quant)
            out[f"{name}_{quant}"] = row
            del params, cache
    return out


def time_bmm(dev, card: str) -> dict:
    """w8a8_bmm at MOE_TIMED: the wrapper's wall time, its plain
    version's, the bound and E calls of torch._int_mm (where it takes
    the shape: M > 16)."""
    import torch
    from repro_torch.kernels import q7_matmul as kq
    from repro_torch.kernels import w8a8_dense as kd
    g = torch.Generator(dev).manual_seed(SEED + 21)
    rows = []
    for E, M, K, N in MOE_TIMED:
        xq, wt, xe, n = bmm_operands(E, M, K, N, g, dev)
        bound, by = bmm_bound(E, M, K, N)
        log(f"{plan_line('w8a8_bmm', (E, M, K, N), xq, wt)} | {card}")
        yard = None if M <= 16 else cuda_ms(
            lambda: [torch._int_mm(xq[e], wt[e].t()) for e in range(E)])
        rows.append(dict(
            shape=[E, M, K, N], ms=cuda_ms(lambda: kd.w8a8_bmm(xq, wt, xe,
                                                                n)),
            plain_ms=cuda_ms(lambda: kd.w8a8_dense_plain(xq, wt, xe, n),
                             iters=5),
            bound_ms=bound, bound_by=by, int_mm_ms=yard,
            plan=str(tuple(kq.plan_for(xq, wt, b_kmajor=True)))))
        yard = "n/a (M <= 16)" if yard is None \
            else f"{yard:.4f} ms ({E} calls)"
        log(f"[time] {card} | w8a8_bmm {[E, M, K, N]} ({rows[-1]['plan']}): "
            f"kernel {rows[-1]['ms']:.4f} ms, plain "
            f"{rows[-1]['plain_ms']:.4f} ms, bound {bound:.6f} ms ({by}), "
            f"torch._int_mm yardstick {yard}")
        del xq, wt
    return dict(rows[0], shapes=rows)


def bmm_device_times(dev, card: str, rows: list) -> None:
    """Profiler device time of w8a8_bmm at each row's shape, summed over
    every kernel of the call (the product, and a split-K reduction or the
    stream-K schedule's zeroed counts; a tree from before W was stored
    K-major also the transpose of every expert's W), and of the E
    torch._int_mm calls, into `rows`, beside the bound and the share of
    it the call reaches."""
    import torch
    from repro_torch.kernels import w8a8_dense as kd
    g = torch.Generator(dev).manual_seed(SEED + 21)
    for row in rows:
        E, M, K, N = row["shape"]
        xq, wt, xe, n = bmm_operands(E, M, K, N, g, dev)
        w = tree_w(wt)
        parts = {}
        row["device_ms"] = device_ms(lambda: kd.w8a8_bmm(xq, w, xe, n),
                                     None, calls=20, parts=parts)
        row["int_mm_device_ms"] = None if M <= 16 else device_ms(
            lambda: [torch._int_mm(xq[e], wt[e].t()) for e in range(E)],
            None, calls=20)
        yard = "n/a" if row["int_mm_device_ms"] is None \
            else f"{row['int_mm_device_ms']:.5f} ms"
        log(f"[device] {card} | w8a8_bmm {row['shape']}: "
            f"{row['device_ms']:.5f} ms, every kernel of the call "
            f"({kernel_parts(parts)}); bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}), {row['bound_ms'] / row['device_ms']:.1%}"
            f" of it; {E} torch._int_mm calls {yard}")
        del xq, wt, w


def w8a8_device_times(dev, card: str) -> dict:
    """`--device-times`'s W8A8 rows: both faces' device ms at the timed
    shapes (LM_TIMED, MOE_TIMED) and w8a8_dense's across the small-M
    switch (LM_SWEEP_M at LM_SWEEP_KN), each beside its bound."""
    dense = [dict(shape=list(s), **dict(zip(("bound_ms", "bound_by"),
                                            dense_bound(*s))))
             for s in LM_TIMED + tuple((M, *LM_SWEEP_KN)
                                       for M in LM_SWEEP_M)]
    bmm = [dict(shape=list(s), **dict(zip(("bound_ms", "bound_by"),
                                          bmm_bound(*s))))
           for s in MOE_TIMED]
    dense_device_times(dev, card, dense)
    bmm_device_times(dev, card, bmm)
    return {"w8a8_dense": dense, "w8a8_bmm": bmm}


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
            "conv0 (conv_q7 kernel, relu fused)": lambda: conv0.fwd_q7(
                qnet.qweights["conv0"], plan["conv0"], xq, backend="cuda"),
            "pcap conv (conv_q7 kernel)": lambda: pcap.conv.fwd_q7(
                qnet.qweights["pcap"], plan["pcap"].conv, h, backend="cuda"),
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
    """The route, tile, split and schedule that gemm_plan picks for these
    operands, as one line's words."""
    from repro_torch.kernels import q7_matmul as kq
    plan = kq.plan_for(a.contiguous(), b.contiguous())
    return f"route {plan.route} tile {plan.tile[0]}x{plan.tile[1]} " \
        f"split {plan.split} {plan.schedule}" \
        + (f" on {plan.ctas} blocks" if plan.ctas else "")


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


# the benchmark cells' convs at their B 256 waves: (cell, layer, geometry
# (H, W, Cin, kernel, stride, Cout))
CONV_WAVE = 256
CONV_CELLS = (("capsnet_mnist_L", "capsnet_mnist"),
              ("capsnet_cifar10_S", "capsnet_cifar10"))


def conv_rows(dev, card: str) -> list:
    """`csrc/conv_q7.cu` at the seven convs of the two benchmark cells
    (B 256, scalar face, floor, relu as the layer runs it), operands from
    SEED + 5: bit for bit against its plain version, then its device ms
    (profiler), its wall ms a call (CUDA events), its bound (input,
    weights and bias read once and output written once at HBM's rate, or
    2 M K Cout int8 operations at the int8 peak, whichever is larger)
    and the plain version's ms.  No single PyTorch call computes an int8
    conv with these shifts, so library_ms is none."""
    import torch
    from repro_torch.kernels import conv as kc
    from repro_torch.nn.config import CAPSNET_CONFIGS
    g = torch.Generator().manual_seed(SEED + 5)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)
    rows = []
    for cell, name in CONV_CELLS:
        geoms = CAPSNET_CONFIGS[name].conv_geometries
        for i, (H, W, Cin, k, st, Cout) in enumerate(geoms):
            layer = "pcap" if i == len(geoms) - 1 else f"conv{i}"
            relu = layer != "pcap"
            x, w, b = i8((CONV_WAVE, H, W, Cin)), i8((k, k, Cin, Cout)), \
                i8((Cout,))
            with torch.inference_mode():
                def call():
                    return kc.conv2d_q7(x, w, b, 9, 2, stride=st, relu=relu)

                def plain():
                    y = kc.conv2d_q7_plain(x, w, b, 9, 2, stride=st)
                    return y.clamp(min=0) if relu else y
                require_equal(f"conv_q7 {cell} {layer}", call(), plain())
                OH, OW = (H - k) // st + 1, (W - k) // st + 1
                M, K = CONV_WAVE * OH * OW, k * k * Cin
                nbytes = x.numel() + w.numel() + Cout + M * Cout
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = 2 * M * K * Cout / INT8_OPS_PER_S * 1e3
                dev_ms = device_ms(call, "conv_q7")
                row = dict(cell=cell, layer=layer,
                           shape=[CONV_WAVE, H, W, Cin, k, st, Cout],
                           M=M, K=K, plan=kc.conv_plan(
                               M, Cout, kc._sm_count(0))._asdict(),
                           device_ms=dev_ms, kernel_ms=cuda_ms(call),
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms
                           else "operations",
                           plain_ms=cuda_ms(plain, iters=5, warmup=1),
                           library_ms=None)
            rows.append(row)
            log(f"[device] {card} | conv_q7 {cell} {layer} "
                f"{shape_key(row['shape'][:4])} k{k} s{st} -> {Cout} (M "
                f"{M}, K {K}, tile {row['plan']['bm']}x{row['plan']['bn']}, "
                f"{row['plan']['blocks']} blocks): device {dev_ms:.5f} ms, "
                f"kernel {row['kernel_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.6f} ms ({row['bound_by']}, "
                f"{row['bound_ms'] / dev_ms:.2%} of it), plain "
                f"{row['plain_ms']:.4f} ms, library none")
            del x, w, b
    return rows


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
            split = kernel_parts(dt["parts"][f"{name} {key}"])
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


# ---------------------------------------------------------------------------
# phase 17: the dry run (repro_torch.launch.dryrun, meta tensors on the
# host's CPU, one card and 512) and its bounds against the card's
# measured steps
# ---------------------------------------------------------------------------
DRYRUN_DIR = ROOT / "build" / "dryrun_smoke"
DRYRUN_TARGET_S = 180         # the four grids at once (printed, not gated)
ROOFLINE_SHARE_MAX = 1.05     # bound / measured: above it the count is wrong
DRYRUN_PEAK_RTOL = 0.25       # the dry run's training peak against the card's


DRYRUN_GRIDS = tuple((mesh, quant) for mesh in ("single", "multi")
                     for quant in (False, True))


def dryrun_grid_args(mesh: str, quant: bool) -> list:
    return ["--all", "--mesh", mesh, "--force", "--out",
            str(DRYRUN_DIR)] + (["--quant"] if quant else [])


def dryrun_grids(card: str, card_gib: float) -> dict:
    """`python -m repro_torch.launch.dryrun --all --mesh M [--quant]` for
    M single and multi, the four grids in four processes at once, into
    DRYRUN_DIR: each exit 0 required, every record `ok` or `skipped` with
    a reason, every `ok` multi-card record with collective bytes; a
    `[dryrun]` line a cell; {grid: its seconds}."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    logs = {grid: DRYRUN_DIR / f"{grid[0]}{'_w8a8' if grid[1] else ''}.log"
            for grid in DRYRUN_GRIDS}
    t0 = time.perf_counter()
    procs, secs = {}, {}
    try:
        for grid in DRYRUN_GRIDS:
            with open(logs[grid], "w") as f:
                procs[grid] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     *dryrun_grid_args(*grid)], cwd=ROOT, env=env,
                    stdout=f, stderr=subprocess.STDOUT)
        while len(secs) < len(procs):
            for grid, proc in procs.items():
                if grid not in secs and proc.poll() is not None:
                    secs[grid] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 900:
                raise AssertionError(f"the dry-run grids ran past 900 s: "
                                     f"{len(secs)} of {len(procs)} done")
            time.sleep(0.2)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for grid, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(
                f"launch.dryrun {dryrun_grid_args(*grid)}: exit "
                f"{proc.returncode}\n{logs[grid].read_text()[-3000:]}")
    for grid in DRYRUN_GRIDS:
        log_dryrun_grid(card, *grid, card_gib, secs[grid])
    return {f"{mesh}{' w8a8' if quant else ''}": s
            for (mesh, quant), s in secs.items()}


def log_dryrun_grid(card: str, mesh: str, quant: bool, card_gib: float,
                    secs: float) -> None:
    """A `[dryrun]` line a record of one grid (a multi-card one: the
    rank's collective ms by fabric beside its bound), then the grid's
    tally; a record neither `ok` nor skipped with a reason fails."""
    from repro_torch.configs.base import ARCH_IDS, SHAPES
    from repro_torch.launch.roofline import IB_BW, LINK_BW
    recs = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            name = f"{arch}__{shape}__{mesh}{'__w8a8' if quant else ''}.json"
            rec = json.loads((DRYRUN_DIR / name).read_text())
            recs.append(rec)
            what = f"[dryrun] {card} | {arch} x {shape} x {mesh}" + (
                " w8a8" if quant else "")
            if rec["status"] == "skipped" and rec.get("reason"):
                log(f"{what}: skipped: {rec['reason']}")
                continue
            if rec["status"] != "ok":
                raise AssertionError(f"{what}: {rec['status']} "
                                     f"{rec.get('error')}")
            gib = rec["hbm_gib_per_dev"]
            extra = ""
            if mesh == "multi":
                if not rec["collective_bytes_per_dev"] > 0:
                    raise AssertionError(f"{what}: no collective bytes on "
                                         f"a mesh of {rec['chips']} cards")
                fab = rec["collectives"]["bytes_by_fabric"]
                extra = (f"; rank {rec['rank']} of {rec['chips']}: "
                         f"collective {fab['nvlink'] / LINK_BW * 1e3:.3f} ms "
                         f"NVLink + {fab['infiniband'] / IB_BW * 1e3:.3f} ms "
                         f"InfiniBand")
            log(f"{what}: dominant {rec['dominant']}, bound "
                f"{rec['step_time_lower_bound_s'] * 1e3:.3f} ms{extra}, "
                f"{gib:.2f} GiB a card, fits one card's {card_gib:.2f} GiB: "
                f"{'yes' if gib <= card_gib else 'no'}")
    log(f"[dryrun] {card} | the {mesh} {'W8A8 ' if quant else ''}grid: "
        f"{sum(r['status'] == 'ok' for r in recs)} cells ok, "
        f"{sum(r['status'] == 'skipped' for r in recs)} skipped, in "
        f"{secs:.1f} s (its process included, four grids at once)")


def dryrun_phase(card: str, lm: dict, train_lm: dict) -> dict:
    """Phase 17: (a) the four grids (one card and 512, float and W8A8);
    (b) the cells the card ran, dry-run in this process, each bound held
    against the step the card measured (phase 12's warm decode ms a
    step, phase 16's median step): a share above ROOFLINE_SHARE_MAX
    fails; the meta-counted `w8a8_dense` calls of a W8A8 decode step
    must equal phase 12's launches a step, and the dry run's training
    peak must lie within DRYRUN_PEAK_RTOL of phase 16's
    `torch.cuda.max_memory_allocated`."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import analyze_step
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    secs = dryrun_grids(card, card_gib)
    log(f"[dryrun] {card} | the four grids in {max(secs.values()):.1f} s "
        f"(target {DRYRUN_TARGET_S} s, the chip host's CPU)")

    qwen, stablelm = get_config("qwen3_14b"), get_config("stablelm_3b")
    # phase 12 decodes 8 rows at positions LM_PROMPT .. LM_PROMPT + LM_GEN
    # - 2 of a decode_alloc(LM_PROMPT + LM_GEN) = 512-slot cache; the dry
    # run decodes at the shape's last slot, seq_len - 1
    decode = ShapeSpec("phase12_decode", "decode", LM_PROMPT + LM_GEN - 1,
                       LM_REQUESTS)
    train = ShapeSpec("phase16_train", "train", task_seq(stablelm),
                      task_batch(stablelm))
    per_step = lm["qwen_w8a8"]["launches"] / LM_GEN
    rows = []
    for what, cfg, shape, quant, measured in (
            ("qwen3_14b decode float", qwen, decode, False,
             lm["qwen_float"]["warm_decode_ms_step"]),
            ("qwen3_14b decode w8a8", qwen, decode, True,
             lm["qwen_w8a8"]["warm_decode_ms_step"]),
            ("stablelm_3b train", stablelm, train, False,
             train_lm["stablelm_3b"]["ms"])):
        with contextlib.redirect_stdout(io.StringIO()):
            rec, cost = analyze_step(cfg, shape, quant=quant)
        bound = rec["step_time_lower_bound_s"] * 1e3
        t = rec["terms"]
        row = dict(what=what, flops=rec["flops_per_dev"],
                   bytes=rec["bytes_per_dev"],
                   terms_ms={k: v * 1e3 for k, v in t.items()},
                   dominant=rec["dominant"], bound_ms=bound,
                   measured_ms=measured, share=bound / measured,
                   gib=rec["hbm_gib_per_dev"], seconds=rec["compile_s"])
        extra = ""
        if quant:
            row["w8a8_dense_a_step"] = cost.ops.get("w8a8_dense", 0)
            row["card_launches_a_step"] = per_step
            extra = (f"; w8a8_dense counted {row['w8a8_dense_a_step']} a "
                     f"step on meta, the card launched "
                     f"{lm['qwen_w8a8']['launches']} over {LM_GEN} forwards "
                     f"({per_step:g} a step)")
        if shape.kind == "train":
            row["card_peak_gib"] = train_lm["stablelm_3b"]["peak_gib"]
            row["peak_rel"] = row["gib"] / row["card_peak_gib"] - 1
            extra = (f"; peak {row['gib']:.2f} GiB dry-run against "
                     f"{row['card_peak_gib']:.2f} GiB max_memory_allocated "
                     f"({row['peak_rel']:+.1%})")
        log(f"[roofline] {card} | {what} (B {shape.global_batch}, S "
            f"{shape.seq_len}): {row['flops']:.4e} flops, "
            f"{row['bytes']:.4e} bytes; compute {t['compute_s'] * 1e3:.3f} "
            f"ms, memory {t['memory_s'] * 1e3:.3f} ms, collective "
            f"{t['collective_s'] * 1e3:.3f} ms; bound {bound:.3f} ms "
            f"({rec['dominant']}) against {measured:.3f} ms measured: share "
            f"{row['share']:.3f}" + extra)
        if row["share"] > ROOFLINE_SHARE_MAX:
            raise AssertionError(f"{what}: bound {bound:.3f} ms above the "
                                 f"measured {measured:.3f} ms: the count is "
                                 "wrong")
        if quant and row["w8a8_dense_a_step"] != per_step:
            raise AssertionError(f"{what}: w8a8_dense counted "
                                 f"{row['w8a8_dense_a_step']} a step on "
                                 f"meta, the card launched {per_step}")
        if shape.kind == "train" and abs(row["peak_rel"]) > DRYRUN_PEAK_RTOL:
            raise AssertionError(f"{what}: dry-run peak {row['gib']:.2f} GiB "
                                 f"against the card's "
                                 f"{row['card_peak_gib']:.2f}")
        rows.append(row)
    return dict(grid_s=secs, rows=rows)


# ---------------------------------------------------------------------------
# phase 18: data-parallel meshes across processes (repro_torch.dist.world)
# ---------------------------------------------------------------------------
MULTI_RANKS = 2
MULTI_BUCKETS = (64, 16, 3, 1)
MULTI_TIMED = 20                   # calls of each per-rank timing
MULTI_TRAIN = (3, 2)               # float, then QAT steps of (c)
MULTI_STEPS = 5                    # timed float steps of (c), a rank
MULTI_LABEL = ("2 ranks sharing one card, gloo through the host: not a "
               "multi-card throughput")
MULTI_AXES = ("pod", "model", "data")      # serving's mesh: data = ranks
MULTI_MID = "mnist@cuda"


def multi_inputs() -> dict:
    """{bucket: the wave's float images}, from SEED."""
    from repro_torch.serving import default_specs
    spec = default_specs()[MULTI_MID]
    return {b: spec.images(b, SEED + 100 + b) for b in MULTI_BUCKETS}


def multi_psum_inputs() -> list:
    """Per-rank inputs of (d), their exponents apart (one payload shifts
    past 31)."""
    import numpy as np
    g = np.random.default_rng(SEED + 18)
    scales = ((0.7, 11.0), (2e9, 1e-7), (0.0, 3e-3))
    return [[(g.standard_normal(4096) * s).astype(np.float32) for s in pair]
            for pair in scales]


def multi_train(mesh, dev) -> tuple:
    """MULTI_TRAIN steps of MNIST "L" (batch 64, 8 microbatches): the
    losses and the state on the CPU."""
    from repro_torch.captrain import CapsTrainer, TrainConfig
    from repro_torch.nn import MNIST
    tc = TrainConfig(dataset="mnist", batch=64, microbatches=8)
    t = CapsTrainer(MNIST, tc, mesh=mesh, device=None if mesh else dev)
    s, _, h1 = t.fit(t.init_state(), MULTI_TRAIN[0])
    s, _, h2 = t.fit(s, MULTI_TRAIN[1], qat=True)
    return [h["loss"] for h in h1 + h2], \
        [t.detach().cpu() for t in state_leaves(s)]


def multi_step_ms(mesh, dev) -> tuple:
    """The median ms of MULTI_STEPS float steps of MNIST "L" (batch 64,
    8 microbatches) from a fresh state, CUDA events around each, and the
    number of parameters."""
    import numpy as np
    import torch
    from repro_torch.captrain import CapsTrainer, TrainConfig
    from repro_torch.nn import MNIST
    tc = TrainConfig(dataset="mnist", batch=64, microbatches=8)
    t = CapsTrainer(MNIST, tc, mesh=mesh, device=None if mesh else dev)
    s = t.init_state()
    x, y = t.task.batch(0, tc.batch)
    xd = torch.as_tensor(x, device=t.device)
    yd = torch.as_tensor(y.astype(np.int64), device=t.device)
    return median_step_us(lambda: t.train_step(s, xd, yd, None),
                          n=MULTI_STEPS) / 1e3, \
        sum(p.numel() for p in state_leaves(s["params"]))


def multi_rank(inputs: dict, psum: list) -> dict:
    """(a), (c) and (d) on one rank of the gloo world."""
    import torch
    from repro_torch.dist import api
    from repro_torch.dist.world import current_world
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.grad_compress import compressed_psum
    from repro_torch.serving import ModelRegistry
    world = current_world()
    mesh = make_host_mesh(MULTI_AXES)
    reg = ModelRegistry(mesh=mesh)
    qnet = reg.model(MULTI_MID)
    out = {"rank": world.rank, "backend": world.backend,
           "device": str(world.device), "mesh": mesh.tag(),
           "registry_device": str(reg.device), "waves": {},
           "launches": {}, "rows": {}}
    for b in MULTI_BUCKETS:
        exe = reg.executable(MULTI_MID, b)
        x = torch.as_tensor(inputs[b])
        # counts from 0 just before this rank's wave, read just after
        ks.squash_q7.launches = kr.routing_q7.launches = 0
        v, lengths, pred = exe(x)
        torch.cuda.synchronize()
        out["launches"][b] = {"routing_q7": kr.routing_q7.launches,
                              "squash_q7": ks.squash_q7.launches}
        out["waves"][b] = [t.cpu() for t in (v, lengths, pred)]
        out["rows"][b] = int(api.split_rows(x, mesh).shape[0])
    # each rank's forward on its share of a bucket-64 wave, and the gather
    xq = qnet.quantize_input(api.split_rows(
        torch.as_tensor(inputs[64]), mesh).to(world.device))
    out["forward_ms"] = cuda_ms(lambda: qnet.forward(xq), iters=MULTI_TIMED)
    v = qnet.forward(xq)
    api.gather_rows(v, mesh, 64)                    # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MULTI_TIMED):
        api.gather_rows(v, mesh, 64)
    torch.cuda.synchronize()
    out["gather_ms"] = (time.perf_counter() - t0) * 1e3 / MULTI_TIMED
    # (c) training split over the ranks, beside the one-rank run here
    out["train_mesh"] = multi_train(mesh, world.device)
    out["train_one"] = multi_train(None, world.device)
    out["step_ms"] = {"mesh": multi_step_ms(mesh, world.device),
                      "one": multi_step_ms(None, world.device)}
    # (d) compressed_psum on CUDA tensors
    out["psum"] = [compressed_psum(torch.from_numpy(xs[world.rank])
                                   .to(world.device)).cpu() for xs in psum]
    return out


def multi_nccl_rank(x) -> dict:
    """(e): one bucket-64 wave through a one-rank NCCL world's group."""
    import torch
    from repro_torch.dist.world import current_world
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import ModelRegistry
    world = current_world()
    mesh = make_host_mesh(MULTI_AXES)
    reg = ModelRegistry(mesh=mesh)
    exe = reg.executable(MULTI_MID, 64)
    ks.squash_q7.launches = kr.routing_q7.launches = 0
    out = [t.cpu() for t in exe(torch.as_tensor(x))]
    return {"backend": world.backend, "mesh": mesh.tag(), "wave": out,
            "launches": {"routing_q7": kr.routing_q7.launches,
                         "squash_q7": ks.squash_q7.launches}}


def psum_formula(xs) -> "torch.Tensor":
    """compressed_psum's formula on the CPU over every worker's input."""
    import torch
    from repro_torch.kernels.w8a8_dense import pow2
    from repro_torch.optim.grad_compress import compress
    pairs = [compress(torch.from_numpy(x)) for x in xs]
    e_min = min(e for _, e in pairs)
    tot = sum(q.to(torch.int32) >> torch.clamp(e - e_min, max=31)
              .to(torch.int32) for q, e in pairs)
    return tot.to(torch.float32) * pow2(-e_min)


def serve_digest(text: str) -> str:
    lines = [ln for ln in text.splitlines()
             if ln.startswith("[serve_caps] completions:")]
    if len(lines) != 1:
        raise AssertionError(f"{len(lines)} completion digests in:\n{text}")
    return lines[0]


def multi_phase(dev, card: str) -> dict:
    """Phase 18: (a) mnist@cuda waves over 2 gloo ranks on the one card,
    bit for bit against the one-process wave, each rank's launches and
    times; (b) serve_caps --mesh host under torchrun; (c) CapsTrainer
    over the ranks against the one-rank run; (d) compressed_psum on CUDA
    tensors; (e) a one-rank NCCL world; (f) NCCL for 2 ranks on one card
    refused.  Returns the multi path's launches."""
    import contextlib
    import io
    import torch
    import torch.distributed as tdist
    from repro_torch.dist import world as dworld
    from repro_torch.launch import serve_caps
    from repro_torch.serving import ModelRegistry
    t_phase = time.perf_counter()
    inputs, psum = multi_inputs(), multi_psum_inputs()
    reg = ModelRegistry(device=dev)
    want = {b: [t.cpu() for t in reg.executable(MULTI_MID, b)(inputs[b])]
            for b in MULTI_BUCKETS}

    # (a), (c), (d): one gloo world of 2 ranks on cuda:0
    t0 = time.perf_counter()
    got = dworld.spawn(multi_rank, MULTI_RANKS, backend="gloo",
                       device="cuda", timeout_s=120, deadline_s=400,
                       args=(inputs, psum))
    world_s = time.perf_counter() - t0
    backend = got[0]["backend"]
    log(f"[multi] (a) world of {MULTI_RANKS} ranks on "
        f"{[g['device'] for g in got]}, backend {backend}, "
        f"mesh {got[0]['mesh']}, registry devices "
        f"{[g['registry_device'] for g in got]} ({world_s:.1f} s for the "
        f"world, start-up included)")
    launches = {"routing_q7": 0, "squash_q7": 0}
    for b in MULTI_BUCKETS:
        for g in got:
            for name, a, w in zip(("v_q", "lengths", "pred"),
                                  g["waves"][b], want[b]):
                if a.dtype != w.dtype or not torch.equal(a, w):
                    raise AssertionError(
                        f"[multi] bucket {b} rank {g['rank']}: {name} "
                        "differs from the one-process wave")
            n = g["launches"][b]
            empty = g["rows"][b] == 0
            if (min(n.values()) == 0) != empty or (empty and any(
                    n.values())):
                raise AssertionError(f"[multi] bucket {b} rank {g['rank']}"
                                     f" ({g['rows'][b]} rows) launched {n}")
            for k in launches:
                launches[k] += n[k]
        log(f"[multi] (a) bucket {b}: v_q, lengths and pred of both ranks "
            f"bit-identical to the one-process {MULTI_MID} wave; rows "
            f"{[g['rows'][b] for g in got]}; launches "
            + "; ".join(f"rank {g['rank']} {g['launches'][b]}" for g in got)
            + f"; backend {backend}")
    log(f"[multi] (a) {card} | {MULTI_LABEL}: forward_q7 on a rank's 32 "
        "rows of a bucket-64 wave "
        + ", ".join(f"rank {g['rank']} {g['forward_ms']!r} ms" for g in got)
        + f" (CUDA events, mean of {MULTI_TIMED}); gather_rows of the "
        "int8 v_q " + ", ".join(f"rank {g['rank']} {g['gather_ms']!r} ms"
                                for g in got)
        + f" (host clock, mean of {MULTI_TIMED})")

    # (c) training: every rank against its own one-rank run, and against
    # the one-rank run of this process
    one_losses, one_state = multi_train(None, dev)
    for g in got:
        for what, (losses, leaves) in (("its own", g["train_one"]),
                                       ("this process's",
                                        (one_losses, one_state))):
            m_losses, m_leaves = g["train_mesh"]
            if m_losses != losses or len(m_leaves) != len(leaves) or \
                    not all(torch.equal(a, b)
                            for a, b in zip(m_leaves, leaves)):
                raise AssertionError(
                    f"[multi] (c) rank {g['rank']}: training over the mesh "
                    f"differs from {what} one-rank run: {m_losses} vs "
                    f"{losses}")
    log(f"[multi] (c) CapsTrainer(MNIST, batch 64, 8 microbatches) over "
        f"{MULTI_RANKS} ranks: {MULTI_TRAIN[0]} float and {MULTI_TRAIN[1]} "
        f"QAT steps, losses {one_losses} and all {len(one_state)} state "
        "leaves bit-identical to the one-rank run (in each rank and in "
        f"this process); backend {backend}")
    from repro_torch.captrain.steps import tree_blocks
    from repro_torch.dist.api import row_share
    rows = [len(tree_blocks(*row_share(8, MULTI_RANKS, r)))
            for r in range(MULTI_RANKS)]
    width = 1 + got[0]["step_ms"]["mesh"][1]
    log(f"[multi] (c) {card} | {MULTI_LABEL}: a float step "
        + ", ".join(f"rank {g['rank']} {g['step_ms']['mesh'][0]!r} ms "
                    f"over the mesh, {g['step_ms']['one'][0]!r} ms alone"
                    for g in got)
        + f" (CUDA events, median of {MULTI_STEPS}, both ranks stepping "
        f"at once); a step all_gathers {rows} rows of {width} float32 "
        f"(the halving tree's sums of loss and gradient), "
        f"{sum(rows) * width * 4 / 1e6:.1f} MB on every rank")

    # (d) compressed_psum on CUDA tensors over the 2 ranks
    for i, xs in enumerate(psum):
        w = psum_formula(xs)
        for g in got:
            if not torch.equal(g["psum"][i], w):
                raise AssertionError(f"[multi] (d) input {i} rank "
                                     f"{g['rank']}: compressed_psum differs "
                                     "from the formula")
    log(f"[multi] (d) compressed_psum of CUDA tensors over {MULTI_RANKS} "
        f"ranks equals the CPU formula on both inputs ({len(psum)} inputs, "
        f"a shift past 31 among them); backend {backend}")

    # (b) the serving CLI under torchrun, against a one-rank run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_caps.main(["--model", MULTI_MID, "--requests",
                              str(N_REQUESTS)])
    one = serve_digest(buf.getvalue())
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(MULTI_RANKS), "-m",
           "repro_torch.launch.serve_caps", "--model", MULTI_MID, "--mesh",
           "host", "--requests", str(N_REQUESTS)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=400,
                          env=env, cwd=ROOT)
    cli_s = time.perf_counter() - t0
    text = proc.stdout
    if rc != 0 or proc.returncode != 0 or \
            text.count("[serve_caps] serve:") != 1 or \
            f"over {MULTI_RANKS}xcuda/gloo" not in text or \
            serve_digest(text) != one:
        raise AssertionError(f"[multi] (b) torchrun serve_caps: exit "
                             f"{proc.returncode}\n{text}\n{proc.stderr[-3000:]}"
                             f"\none-rank: {one}")
    log(f"[multi] (b) torchrun --standalone --nproc-per-node {MULTI_RANKS} "
        f"-m repro_torch.launch.serve_caps --model {MULTI_MID} --mesh host "
        f"--requests {N_REQUESTS}: exit 0 in {cli_s:.1f} s, one report "
        f"(rank 0's), completions equal to a one-rank run's ({one}); "
        f"backend gloo")

    # (e) a one-rank NCCL world
    nccl = dworld.spawn(multi_nccl_rank, 1, backend="nccl", device="cuda",
                        timeout_s=120, deadline_s=300, args=(inputs[64],))[0]
    if nccl["backend"] != "nccl" or \
            min(nccl["launches"].values()) == 0 or not all(
                torch.equal(a, w) for a, w in zip(nccl["wave"], want[64])):
        raise AssertionError(f"[multi] (e) NCCL world: {nccl['backend']}, "
                             f"launches {nccl['launches']}")
    log(f"[multi] (e) a one-rank NCCL world, mesh {nccl['mesh']}: a "
        f"bucket-64 wave through the NCCL group bit-identical to (a)'s; "
        f"launches {nccl['launches']}; backend nccl")

    # (f) NCCL asked for 2 ranks on this one card
    try:
        dworld.init_world(rank=0, world_size=MULTI_RANKS, local_rank=0,
                          local_world_size=MULTI_RANKS, backend="nccl",
                          device="cuda")
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("[multi] (f) NCCL for 2 ranks on one card was "
                             "not refused")
    if dworld.current_world() is not None or tdist.is_initialized():
        raise AssertionError("[multi] (f) a process group was made")
    log(f"[multi] (f) backend nccl for {MULTI_RANKS} ranks on "
        f"{torch.cuda.device_count()} card refused before any process "
        f"group: ValueError: {refusal}")
    log(f"[multi] phase 18 passed in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "nccl_launches": nccl["launches"],
            "forward_ms": [g["forward_ms"] for g in got],
            "gather_ms": [g["gather_ms"] for g in got],
            "step_ms": [g["step_ms"] for g in got]}


# ---------------------------------------------------------------------------
# every launch of a run held against its plain version (phases 19, 20)
# ---------------------------------------------------------------------------
SPIED = ("routing_q7", "squash_q7", "w8a8_dense", "conv2d_q7")


def conv_plain_relu(x, w, bias, out_shift, bias_shift, relu=False, **kw):
    """`conv2d_q7`'s plain version, then the relu the kernel fuses."""
    from repro_torch.kernels import conv as kc
    y = kc.conv2d_q7_plain(x, w, bias, out_shift, bias_shift, **kw)
    return y.clamp(min=0) if relu else y


def launch_spy(pending: list):
    """Patch the `routing_q7`, `squash_q7` and `conv2d_q7` wrappers (the
    module attributes `CudaBackend` calls) and `lm_quant.w8a8_dense` so that
    every launch's inputs and output are copied into `pending` as (name,
    plain version, args, kwargs, output), for `check_pending` to hold
    against the plain version after the run: the run's own times carry
    the copies (up to three device copies a launch), not the plain
    versions.  A wrapper counts its launches on the module attribute of
    its name, so while patched the spies hold `routing_q7`, `squash_q7`
    and `conv2d_q7`'s counts, handed back by the undo.  Returns the
    undo."""
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.kernels.w8a8_dense import w8a8_dense_plain
    from repro_torch.quant import lm_quant
    rq, sq, wd = kr.routing_q7, ks.squash_q7, lm_quant.w8a8_dense
    cq = kc.conv2d_q7

    def routing(u_hat, **kw):
        n = routing.launches
        v = rq(u_hat, **kw)
        if routing.launches != n:
            pending.append(("routing_q7", kr.routing_q7_plain,
                            (u_hat.clone(),), {k: a for k, a in kw.items()
                                               if k not in ("cs", "stage")},
                            v.clone()))
        return v

    def squash(s, in_frac, out_frac=7):
        n = squash.launches
        out = sq(s, in_frac, out_frac)
        if squash.launches != n:
            pending.append(("squash_q7", ks.squash_q7_plain, (s.clone(),),
                            dict(in_frac=in_frac, out_frac=out_frac),
                            out.clone()))
        return out

    def dense(xq, wt, xe, n, out_dtype):
        y = wd(xq, wt, xe, n, out_dtype)
        pending.append(("w8a8_dense", w8a8_dense_plain,
                        (xq.clone(), wt, xe.clone(), n, out_dtype), {},
                        y.clone()))
        return y

    def conv(x, w, bias, out_shift, bias_shift, **kw):
        n = conv.launches
        y = cq(x, w, bias, out_shift, bias_shift, **kw)
        if conv.launches != n:
            pending.append(("conv2d_q7", conv_plain_relu,
                            (x.clone(), w, bias, out_shift, bias_shift), kw,
                            y.clone()))
        return y
    routing.launches, squash.launches = rq.launches, sq.launches
    conv.launches = cq.launches
    kr.routing_q7, ks.squash_q7, lm_quant.w8a8_dense = routing, squash, dense
    kc.conv2d_q7 = conv

    def undo():
        rq.launches, sq.launches = routing.launches, squash.launches
        cq.launches = conv.launches
        kr.routing_q7, ks.squash_q7, lm_quant.w8a8_dense = rq, sq, wd
        kc.conv2d_q7 = cq
    return undo


def check_pending(pending: list, checked: dict) -> None:
    """Each recorded launch's plain version on its inputs: the max
    |kernel - plain| of each into checked[name], which must be 0;
    `pending` emptied."""
    import torch
    with torch.inference_mode():
        while pending:
            name, plain, args, kw, out = pending.pop()
            want = plain(*args, **kw)
            err = float((out.float() - want.float()).abs().max())
            checked[name].append(err)
            if err != 0:
                raise AssertionError(f"{name}: a launch of the examples "
                                     f"differs from its plain version by "
                                     f"{err}")


# ---------------------------------------------------------------------------
# phase 19: tensor parallelism on the model axis (dist.api's groups and
# Functions, the models' shard sites, launch.steps.make_cell on meshes)
# ---------------------------------------------------------------------------
TP_RANKS = 2
TP_LABEL = ("2 ranks sharing one card, gloo through the host: the split, "
            "the collectives and the bits, not a multi-card rate")
TP_DIR = ROOT / "build" / "tp_smoke"
TP_DECODE = 32                   # greedy decode steps of (a), after prefill
TP_TIMED = 4                     # warm decode steps timed in (a)
TP_REPLAYS = 2                   # replays of a decode step's collectives
TP_TRAIN_LAYERS = LM_RESUME_LAYERS           # (b): phase 16's resume depth
# (a): qwen3_14b at full width cut to 8 of its 40 layers, to keep the
# whole run inside its time limit (a layer's products and collectives
# are those of every other)
TP_QWEN_LAYERS = 8
TP_TRAIN_B, TP_TRAIN_S, TP_TRAIN_STEPS = 8, 256, 3
TP_C_B, TP_C_STEPS = 8, 4                    # (c): rows, decode steps
TP_PARAM_RTOL = 0.05             # a rank's params against its share
# api.collective's kinds -> the dry run's (`dist.op_analysis`)
TP_KINDS = {"sum": "all-reduce", "min": "all-reduce", "max": "all-reduce",
            "all_gather": "all-gather"}


def tp_record_collectives():
    """Patch `api.collective` so that every call's kind, input shape,
    dtype, device, group and group size go into a list (the calls of
    an autograd backward too, whatever its thread).  Returns (the list,
    the undo)."""
    import torch.distributed as dist
    from repro_torch.dist import api
    calls, orig = [], api.collective

    def record(kind, t, group=None):
        calls.append((kind, tuple(t.shape), t.dtype, t.device, group,
                      dist.get_world_size(group)))
        return orig(kind, t, group)
    api.collective = record

    def undo():
        api.collective = orig
    return calls, undo


def tp_by_kind(calls) -> dict:
    """{the dry run's kind: [calls, output bytes]} of recorded calls: an
    all-reduce's output is its input, an all-gather's the input times
    the group's size."""
    out = {}
    for kind, shape, dtype, _, _, size in calls:
        k = TP_KINDS[kind]
        n = math.prod(shape) * dtype.itemsize * (
            size if k == "all-gather" else 1)
        c = out.setdefault(k, [0, 0])
        c[0] += 1
        c[1] += n
    return out


def tp_prompts(cfg, dev):
    """The served prompts of phase 12 (`launch.serve`'s TokenTask)."""
    import torch
    from repro_torch.data.synthetic import TokenTask
    return torch.as_tensor(TokenTask(cfg.vocab_size, LM_PROMPT, seed=3)
                           .batch(0, LM_REQUESTS)["inputs"], device=dev)


def tp_digest(x) -> tuple:
    """A tensor's shape and two sums of its bits (plain and weighted),
    computed where it lies: equal digests mean, short of a collision,
    equal bits."""
    import torch
    bits = x.detach().contiguous().view(
        {1: torch.int8, 2: torch.int16, 4: torch.int32,
         8: torch.int64}[x.element_size()]).reshape(-1).to(torch.int64)
    w = torch.arange(1, bits.numel() + 1, dtype=torch.int64,
                     device=bits.device) % 65521
    return tuple(x.shape), int(bits.sum()), int((bits * w).sum())


def tp_spy(exps):
    """Patch `lm_quant.quantize_activation` so that every W8A8 product's
    input digest and activation exponent go into `exps`.  Returns the
    undo."""
    from repro_torch.quant import lm_quant
    qa = lm_quant.quantize_activation

    def quantize(x):
        q, e = qa(x)
        exps.append((tp_digest(x), float(e)))
        return q, e
    lm_quant.quantize_activation = quantize

    def undo():
        lm_quant.quantize_activation = qa
    return undo


def tp_generate(model, params, prompts, feed=None, exps=None):
    """A prefill of `prompts` into decode_alloc(LM_PROMPT + LM_GEN) = 512
    slots, then TP_DECODE decode steps fed `feed` [B, TP_DECODE] (greedy
    when None); `exps` records the prefill's W8A8 exponents.  Returns
    (logits [TP_DECODE + 1, B, V] float32 on the host, the tokens fed)."""
    import torch
    from repro_torch.models.transformer import decode_alloc
    undo = tp_spy(exps) if exps is not None else None
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"inputs": prompts},
                                      alloc=decode_alloc(LM_PROMPT + LM_GEN))
        if undo:
            undo()
        out, toks = [logits.float().cpu()], []
        for i in range(TP_DECODE):
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32) \
                if feed is None else feed[:, i:i + 1].to(prompts.device)
            toks.append(tok.cpu())
            logits, cache = model.decode_step(params, cache, tok,
                                              LM_PROMPT + i)
            out.append(logits.float().cpu())
    return torch.stack(out), torch.cat(toks, 1)


def tp_times(model, params, prompts, feed) -> tuple:
    """(prefill ms, warm decode ms a step over TP_TIMED steps fed `feed`),
    host clock around work ending in a synchronize."""
    import torch
    from repro_torch.models.transformer import decode_alloc
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.prefill(params, {"inputs": prompts},
                                 alloc=decode_alloc(LM_PROMPT + LM_GEN))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(TP_TIMED):
            _, cache = model.decode_step(params, cache,
                                         feed[:, i:i + 1].to(prompts.device),
                                         LM_PROMPT + i)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3 / TP_TIMED


def tp_param_bytes(cfg, quant: str) -> tuple:
    """(the one-process tree's bytes, the bytes a rank of the model line
    should hold: half of every leaf `param_specs` splits, all of the
    others), from meta structs."""
    from repro_torch.dist import sharding
    from repro_torch.launch.steps import input_specs
    from repro_torch.configs.base import ShapeSpec
    p = input_specs(cfg, ShapeSpec("p", "prefill", LM_PROMPT, LM_REQUESTS),
                    quant=quant == "w8a8")["params"]
    specs = sharding.flat_specs(p, sharding.param_specs(p))
    from repro_torch.tree import leaves
    total = share = 0
    for t, spec in zip(leaves(p), specs):
        b = t.numel() * t.element_size()
        total += b
        share += b / TP_RANKS if "model" in spec else b
    return total, share


def tp_one(cfg, dev, quant: str) -> dict:
    """(a)'s one-process run: the logits and greedy tokens of
    `tp_generate`, the prefill's exponents, written for the ranks into
    TP_DIR; its times.  The card is freed after."""
    import torch
    from repro_torch.models.transformer import build_model
    from repro_torch.quant.lm_quant import init_quantized, quantized_bytes
    model = build_model(cfg)
    gen = torch.Generator(dev).manual_seed(SEED)
    params = init_quantized(model, gen, dev) if quant == "w8a8" \
        else model.init(gen, dev)
    prompts = tp_prompts(cfg, dev)
    exps = []
    logits, toks = tp_generate(model, params, prompts, exps=exps)
    one = {"logits": logits, "tokens": toks, "exps": exps,
           "bytes": quantized_bytes(params)}
    one["prefill_ms"], one["decode_ms"] = tp_times(model, params, prompts,
                                                    toks)
    TP_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(one, TP_DIR / f"one_{quant}.pt")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: one[k] for k in ("bytes", "prefill_ms", "decode_ms")}


def tp_serve_rank(cfg, mesh, quant: str) -> dict:
    """(a) on one rank of the model line: the rank's shares drawn from the
    seed, the checked run under the mesh (every `w8a8_dense` launch held
    against its plain version, the prefill's exponents recorded, the
    one-process tokens fed), its logits against the one-process run's,
    the greedy agreement, the times, and the collectives of a decode
    step replayed alone."""
    import torch
    from repro_torch.dist import api
    from repro_torch.kernels import w8a8_dense as kd
    from repro_torch.models.transformer import build_model
    from repro_torch.quant.lm_quant import init_quantized, quantized_bytes
    dev = mesh.device
    secs = {}
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(dev).manual_seed(SEED)
    params = init_quantized(model, gen, dev, mesh) if quant == "w8a8" \
        else model.init(gen, dev, mesh)
    one = torch.load(TP_DIR / f"one_{quant}.pt", weights_only=False)
    secs["init"] = time.perf_counter() - t0
    prompts = tp_prompts(cfg, dev)
    exps, pending = [], []
    checked = {name: [] for name in SPIED}
    undo = launch_spy(pending)
    kd.w8a8_dense.launches = 0          # from 0 just before the TP path
    t0 = time.perf_counter()
    try:
        with mesh:
            logits, _ = tp_generate(model, params, prompts,
                                    feed=one["tokens"], exps=exps)
    finally:
        undo()
    launches = kd.w8a8_dense.launches
    check_pending(pending, checked)
    torch.cuda.synchronize()
    secs["checked"] = time.perf_counter() - t0
    want = one["logits"]
    diff = (logits - want).abs()
    over = diff > CONSIST_ATOL + CONSIST_RTOL * want.abs()
    beyond = int(over.sum())
    # greedy tokens: the mesh's argmax against the one-process token, on
    # every (row, step) whose top two logits lie further apart than twice
    # the largest difference measured on that row (a near-tie otherwise)
    top2 = torch.topk(want, 2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 2 * diff.amax(-1)
    fed = torch.cat([one["tokens"], torch.argmax(want[-1], -1)[:, None]
                     .to(torch.int32)], 1).T          # [steps + 1, B]
    agree = (torch.argmax(logits, -1).to(torch.int32) == fed)
    # exponents of the prefill's products: equal wherever the input is
    mism = [i for i, ((d1, e1), (d2, e2)) in enumerate(zip(one["exps"],
                                                            exps))
            if e1 != e2]
    first_diff = next((i for i, ((d1, _), (d2, _)) in enumerate(
        zip(one["exps"], exps)) if d1 != d2), None)
    out = {"resident": quantized_bytes(params), "launches": launches,
           "dense_checked": len(checked["w8a8_dense"]),
           "dense_max_err": max(checked["w8a8_dense"], default=0.0),
           "max_diff": float(diff.max()), "beyond": beyond,
           "step_max": [round(float(d), 6) for d in diff.amax((1, 2))],
           "step_beyond": [int(n) for n in over.sum((1, 2))],
           "agree": int(agree[~tie].sum()), "compared": int((~tie).sum()),
           "ties": int(tie.sum()), "tie_agree": int(agree[tie].sum()),
           "products": len(exps), "want_products": len(one["exps"]),
           "mismatched": mism, "first_input_diff": first_diff}
    t0 = time.perf_counter()
    with mesh:
        out["prefill_ms"], out["decode_ms"] = tp_times(
            model, params, prompts, one["tokens"])
        secs["timed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the collectives of one decode step, by kind, then replayed alone
        from repro_torch.models.transformer import decode_alloc
        with torch.inference_mode():
            _, cache = model.prefill(params, {"inputs": prompts},
                                     alloc=decode_alloc(LM_PROMPT + LM_GEN))
            calls, undo = tp_record_collectives()
            try:
                model.decode_step(params, cache, one["tokens"][:, :1].to(dev),
                                  LM_PROMPT)
            finally:
                undo()
        orig = api.collective
        out["by_kind"] = tp_by_kind(calls)
        bufs = [(k, torch.zeros(s, dtype=d, device=v), g)
                for k, s, d, v, g, _ in calls]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(TP_REPLAYS):
            for k, b, g in bufs:
                orig(k, b, g)
        torch.cuda.synchronize()
        out["gather_ms"] = (time.perf_counter() - t1) * 1e3 / TP_REPLAYS
        secs["replay"] = time.perf_counter() - t0
        out["secs"] = {k: round(v, 1) for k, v in secs.items()}
        out["collectives"] = len(calls)
        out["collective_bytes"] = sum(b.numel() * b.element_size()
                                      for _, b, _ in bufs)
    del model, params, cache, bufs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_share(t, spec, index: int):
    """Rank `index`'s share of a whole leaf on a model line of TP_RANKS,
    as `sharding.local_shard` lays it out."""
    from repro_torch.dist.api import row_share
    for i, ent in enumerate(spec):
        if ent == "model" or (isinstance(ent, tuple) and "model" in ent):
            lo, hi = row_share(t.shape[i], TP_RANKS, index)
            t = t.narrow(i, lo, hi - lo)
    return t


def tp_train_batches(cfg, dev) -> list:
    import torch
    from repro_torch.data.synthetic import TokenTask
    task = TokenTask(cfg.vocab_size, TP_TRAIN_S, seed=SEED + 19)
    return [{k: torch.as_tensor(v, device=dev) for k, v in
             task.batch(i, TP_TRAIN_B).items()}
            for i in range(TP_TRAIN_STEPS)]


def tp_qwen_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3_14b"),
                               num_layers=TP_QWEN_LAYERS)


def tp_train_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("stablelm_3b"),
                               num_layers=TP_TRAIN_LAYERS)


def tp_train_one(dev) -> dict:
    """(b)'s one-process steps: losses and grad norms."""
    import torch
    from repro_torch.launch import steps
    cfg = tp_train_cfg()
    state = steps.init_train_state(cfg, torch.Generator(dev).manual_seed(
        SEED), dev)
    step = steps.make_train_step(cfg)
    losses, norms = [], []
    for b in tp_train_batches(cfg, dev):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "norms": norms}


def tp_train_rank(mesh) -> dict:
    """(b) on one rank: TP_TRAIN_STEPS make_cell steps on the rank's
    shares, timed; then from the same init one step, a sharded save, a
    fault (the state dropped), a restore into a fresh state and the
    remaining steps, which must equal the uninterrupted run bit for bit;
    the saved state's digest, gathered, for this process's restore."""
    import torch
    from repro_torch import ckpt
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.quant.lm_quant import quantized_bytes
    from repro_torch.tree import leaves, tree_map
    torch.use_deterministic_algorithms(True)
    t_start = time.perf_counter()
    dev = mesh.device
    cfg = tp_train_cfg()
    shape = ShapeSpec("tp_train", "train", TP_TRAIN_S, TP_TRAIN_B)
    step, _, in_specs, _ = steps.make_cell(cfg, shape, mesh)
    st_spec = in_specs[0]
    batches = tp_train_batches(cfg, dev)

    def fresh():
        return steps.init_train_state(cfg, torch.Generator(dev).manual_seed(
            SEED), dev, mesh)
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    out = {"resident": quantized_bytes(state), "losses": [], "norms": [],
           "ms": []}
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # a fault after step 1's save, a resume from the sharded checkpoint
    b_state = fresh()
    calls, undo = tp_record_collectives()     # one step's, by kind
    try:
        b_state, _ = step(b_state, batches[0])
    finally:
        undo()
    out["by_kind"] = tp_by_kind(calls)
    t0 = time.perf_counter()
    ckpt.save(TP_DIR / "ckpt", 1, b_state, specs=st_spec, mesh=mesh)
    out["save_s"] = time.perf_counter() - t0
    out["saved_digest"] = [tp_digest(t) for t in leaves(b_state)]
    del b_state                                   # the fault
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    b_state = ckpt.restore(TP_DIR / "ckpt", 1,
                           tree_map(torch.zeros_like, state), into=True,
                           specs=st_spec, mesh=mesh)
    out["restore_s"] = time.perf_counter() - t0
    for b in batches[1:]:
        b_state, _ = step(b_state, b)
    out["resume_equal"] = all(torch.equal(x, y) for x, y in zip(
        leaves(b_state), leaves(state)))
    torch.use_deterministic_algorithms(False)
    out["secs"] = round(time.perf_counter() - t_start, 1)
    del state, b_state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_dryrun_cells() -> tuple:
    """(key, config, shape, W8A8, decode position) of the steps phase 19
    runs on each rank: qwen3_14b's decode at phase 12's 8 rows and
    512-slot cache at position LM_PROMPT, bf16 and W8A8, and (b)'s
    stablelm_3b train step."""
    from repro_torch.configs.base import ShapeSpec
    qwen = tp_qwen_cfg()
    decode = ShapeSpec("tp_decode", "decode", LM_PROMPT + LM_GEN - 1,
                       LM_REQUESTS)
    train = ShapeSpec("tp_train", "train", TP_TRAIN_S, TP_TRAIN_B)
    return (("none", qwen, decode, False, LM_PROMPT),
            ("w8a8", qwen, decode, True, LM_PROMPT),
            ("train", tp_train_cfg(), train, False, None))


def tp_count() -> dict:
    """`--tp-count`, a process of its own (one process group a process):
    the dry run of `tp_dryrun_cells` on a fake world of phase 19's mesh,
    (pod 1, data 1, model TP_RANKS), rank by rank: {"key rank": the
    collectives by kind as [calls, output bytes], the bound and its
    terms in ms, the rank's GiB and the count's seconds}."""
    import contextlib
    import io
    import torch
    from repro_torch.dist.api import Mesh
    from repro_torch.launch.dryrun import analyze_step
    layout = Mesh(("pod", "data", "model"), (1, 1, TP_RANKS),
                  [torch.device("meta")] * TP_RANKS)
    out = {}
    for key, cfg, shape, quant, pos in tp_dryrun_cells():
        for rank in range(TP_RANKS):
            with contextlib.redirect_stdout(io.StringIO()):
                rec, cost = analyze_step(cfg, shape, "tp", quant,
                                         mesh=layout, rank=rank, pos=pos)
            out[f"{key} {rank}"] = {
                "by_kind": {k: [cost.collective_count_by_kind[k],
                                int(cost.collective_bytes_by_kind[k])]
                            for k in sorted(cost.collective_count_by_kind)},
                "fabric": rec["collectives"]["bytes_by_fabric"],
                "bound_ms": rec["step_time_lower_bound_s"] * 1e3,
                "terms_ms": {k: v * 1e3 for k, v in rec["terms"].items()},
                "dominant": rec["dominant"], "gib": rec["hbm_gib_per_dev"],
                "seconds": rec["compile_s"]}
    return out


def tp_dryrun(card: str, got: list) -> dict:
    """Phase 19's steps dry-run in a process of its own (`--tp-count`):
    each rank's collectives by kind and bytes must equal what the rank
    recorded (its decode steps' and its train step's), and each bound,
    against the rank's measured ms (warm decode ms a step, the median
    train step), must give a share of at most ROOFLINE_SHARE_MAX."""
    from repro_torch.models.transformer import decode_alloc
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--tp-count"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"chip_smoke.py --tp-count: exit "
                             f"{proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    count = json.loads(proc.stdout.strip().splitlines()[-1])["tp_count"]
    rows = []
    for g in got:
        for key, cfg, shape, quant, pos in tp_dryrun_cells():
            dry = count[f"{key} {g['rank']}"]
            r = g[key]
            measured = r["decode_ms"] if key != "train" else \
                statistics.median(r["ms"])
            what = (f"qwen3_14b x{TP_QWEN_LAYERS} decode {key}"
                    if key != "train" else
                    f"stablelm_3b x{TP_TRAIN_LAYERS} train") + \
                f" rank {g['rank']}"
            if r["by_kind"] != dry["by_kind"]:
                raise AssertionError(
                    f"[tp] {what}: the rank's collectives {r['by_kind']} "
                    f"against the dry run's {dry['by_kind']}")
            share = dry["bound_ms"] / measured
            t = dry["terms_ms"]
            log(f"[tp] {what}: collectives by kind [calls, output bytes] "
                f"{r['by_kind']}, the dry run's on a fake world of "
                f"{TP_RANKS} equal ({dry['seconds']} s to count)")
            cell = (f"B {shape.global_batch}, {decode_alloc(shape.seq_len)} "
                    f"slots, position {pos}" if key != "train" else
                    f"B {shape.global_batch} x S {shape.seq_len}")
            log(f"[roofline] {card} | {what} ({cell}, model {TP_RANKS}): "
                f"compute "
                f"{t['compute_s']:.3f} ms, memory {t['memory_s']:.3f} ms, "
                f"collective {t['collective_s']:.3f} ms "
                f"(NVLink {dry['fabric']['nvlink']:,.0f} bytes); bound "
                f"{dry['bound_ms']:.3f} ms ({dry['dominant']}) against "
                f"{measured:.3f} ms measured ({TP_LABEL}): share "
                f"{share:.4f}, {dry['gib']:.2f} GiB the rank")
            if share > ROOFLINE_SHARE_MAX:
                raise AssertionError(f"[roofline] {what}: bound "
                                     f"{dry['bound_ms']:.3f} ms above the "
                                     f"measured {measured:.3f} ms")
            rows.append(dict(what=what, by_kind=r["by_kind"],
                             bound_ms=dry["bound_ms"], measured_ms=measured,
                             share=share, gib=dry["gib"]))
    log(f"[tp] the dry run's count of phase 19's steps: {secs:.1f} s "
        "(its process included)")
    return {"rows": rows, "seconds": secs}


def tp_rank() -> dict:
    """(a) and (b) on one rank of the 2-rank world, whose default host
    mesh puts both ranks on the model axis."""
    from repro_torch.dist import api
    from repro_torch.dist.world import current_world
    from repro_torch.launch.mesh import make_host_mesh
    world = current_world()
    mesh = make_host_mesh()
    if api.tp_size(mesh) != TP_RANKS:
        raise AssertionError(f"make_host_mesh() in a world of {world.size}: "
                             f"{mesh.shape}")
    out = {"rank": world.rank, "mesh": mesh.tag(), "tp_rank":
           api.tp_rank(mesh), "device": str(world.device)}
    qwen = tp_qwen_cfg()
    for quant in ("none", "w8a8"):
        out[quant] = tp_serve_rank(qwen, mesh, quant)
    out["train"] = tp_train_rank(mesh)
    return out


def tp_c_rank(waves: dict) -> dict:
    """(c) on one rank of the 4-rank (data 2, model 2) world: qwen3_14b
    reduced (d 256) through make_cell's train, prefill and decode on the
    rank's shares beside the one-process steps in this rank, and
    mnist@cuda waves through a registry on the mesh."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist import api, sharding
    from repro_torch.dist.api import Mesh
    from repro_torch.dist.world import current_world
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.launch import steps
    from repro_torch.launch.train import reduced
    from repro_torch.serving import ModelRegistry
    from repro_torch.tree import tree_map
    world = current_world()
    dev = world.device
    mesh = Mesh(("pod", "data", "model"), (1, 2, 2), world.devices,
                world=world)
    one_mesh = Mesh(("pod", "data", "model"), (1, 1, 1), [dev])
    cfg = reduced(get_config("qwen3_14b"), d_model=256)
    B, S = TP_C_B, LM_PROMPT
    out = {"rank": world.rank, "dp_rank": api.dp_rank(mesh),
           "tp_rank": api.tp_rank(mesh)}
    from repro_torch.data.synthetic import TokenTask
    task = TokenTask(cfg.vocab_size, S + TP_C_STEPS, seed=SEED + 20)
    toks = torch.as_tensor(task.batch(0, B)["inputs"], device=dev)
    tb = {"inputs": toks[:, :S], "targets": toks[:, 1:S + 1]}
    rows = sharding.dp_shardable(B, mesh)

    def mine(t):
        return api.split_rows(t, mesh) if rows else t
    res = {}
    for key, m in (("one", one_mesh), ("tp", mesh)):
        state = steps.init_train_state(cfg, torch.Generator(dev).manual_seed(
            SEED), dev, m)
        params = tree_map(torch.clone, state["params"])
        tr, *_ = steps.make_cell(cfg, ShapeSpec("t", "train", S, B), m)
        pre, *_ = steps.make_cell(cfg, ShapeSpec("p", "prefill", S, B), m)
        dec, *_ = steps.make_cell(cfg, ShapeSpec("d", "decode", S, B), m)
        part = (lambda t: t) if m is one_mesh else mine
        _, met = tr(state, {k: part(v) for k, v in tb.items()})
        logits, _ = pre(params, {"inputs": part(tb["inputs"])})
        with m, api.rows_split(rows and m is mesh):
            _, cache = steps.build_model(cfg).prefill(
                params, {"inputs": part(tb["inputs"])}, alloc=2 * S)
        got = [logits]
        for i in range(TP_C_STEPS):
            lg, cache = dec(params, cache, part(toks[:, S + i:S + i + 1]),
                            S + i)
            got.append(lg)
        if m is mesh and rows:
            got = [api.gather_rows(g.float(), mesh, B) for g in got]
        res[key] = {"loss": float(met["loss"]),
                    "norm": float(met["grad_norm"]),
                    "logits": [g.float().cpu() for g in got]}
    out["loss"] = (res["one"]["loss"], res["tp"]["loss"])
    out["norm"] = (res["one"]["norm"], res["tp"]["norm"])
    worst = beyond = 0
    for a, b in zip(res["one"]["logits"], res["tp"]["logits"]):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        beyond += int((d > CONSIST_ATOL + CONSIST_RTOL * a.abs()).sum())
    out["logit_max_diff"], out["logit_beyond"] = worst, beyond
    # mnist@cuda waves through a registry on the (data 2, model 2) mesh
    reg = ModelRegistry(mesh=mesh)
    out["waves"], out["launches"] = {}, {}
    for b, x in waves.items():
        exe = reg.executable(MULTI_MID, b)
        ks.squash_q7.launches = kr.routing_q7.launches = 0
        got = [t.cpu() for t in exe(torch.as_tensor(x))]
        torch.cuda.synchronize()
        out["launches"][b] = {"routing_q7": kr.routing_q7.launches,
                              "squash_q7": ks.squash_q7.launches}
        out["waves"][b] = got
    return out


def tp_phase(dev, card: str) -> dict:
    """Phase 19: (a) qwen3_14b at full width, TP_QWEN_LAYERS deep, bf16
    and W8A8, over a model line of 2 gloo ranks sharing cuda:0 against
    the one-process run before it; (b) stablelm_3b at full width, 2 layers, 3 make_cell train steps
    over the same ranks against the one-process steps, a fault and a
    resume from the sharded checkpoint bit for bit, the checkpoint
    restored into this process equal to the state the ranks gathered;
    (c) a (data 2, model 2) world of 4 ranks: qwen3_14b at d 256 through
    make_cell and mnist@cuda waves.  Returns the TP path's launches."""
    import torch
    from repro_torch import ckpt
    from repro_torch.dist import world as dworld
    from repro_torch.launch import steps
    from repro_torch.serving import ModelRegistry
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    qwen = tp_qwen_cfg()
    one = {q: tp_one(qwen, dev, q) for q in ("none", "w8a8")}
    train_one = tp_train_one(dev)
    one_s = time.perf_counter() - t_phase
    log(f"[tp] {card} | one process: qwen3_14b x{TP_QWEN_LAYERS} params "
        + ", ".join(f"{q} {one[q]['bytes']:,} bytes, prefill "
                    f"{one[q]['prefill_ms']:.2f} ms, decode "
                    f"{one[q]['decode_ms']:.3f} ms a step" for q in one)
        + f"; stablelm_3b x{TP_TRAIN_LAYERS} losses {train_one['losses']} "
        f"({one_s:.1f} s for the one-process runs)")

    # (a), (b): one gloo world of 2 ranks on cuda:0, deterministic cuBLAS
    # for (b)'s bits (each rank turns deterministic algorithms on there)
    old = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    t0 = time.perf_counter()
    try:
        got = dworld.spawn(tp_rank, TP_RANKS, backend="gloo", device="cuda",
                           timeout_s=300, deadline_s=900)
    finally:
        if old is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old
    world_s = time.perf_counter() - t0
    log(f"[tp] (a)-(b) world of {TP_RANKS} ranks on "
        f"{[g['device'] for g in got]}, mesh {got[0]['mesh']} "
        f"(make_host_mesh()), tp ranks {[g['tp_rank'] for g in got]} "
        f"({world_s:.1f} s for the world, start-up included)")
    launches = 0
    for q in ("none", "w8a8"):
        total, share = tp_param_bytes(qwen, q)
        want_launches = (7 * qwen.num_layers + 1) * (TP_DECODE + 1) \
            if q == "w8a8" else 0
        for g in got:
            r = g[q]
            what = f"[tp] (a) qwen3_14b x{TP_QWEN_LAYERS} {q} rank {g['rank']}"
            if abs(r["resident"] / share - 1) > TP_PARAM_RTOL:
                raise AssertionError(f"{what}: {r['resident']:,} param "
                                     f"bytes, its share is {share:,.0f}")
            # bf16: the prefill and every decode step; W8A8: the prefill
            # (its decode steps are printed: a float sum's order moves a
            # value across an int8 rounding boundary, and the next
            # product's codes follow)
            beyond = r["beyond"] if q == "none" else r["step_beyond"][0]
            if beyond or r["agree"] != r["compared"]:
                raise AssertionError(f"{what}: {beyond} logits beyond the "
                                     f"tolerance (max {r['max_diff']}), "
                                     f"greedy {r['agree']}/{r['compared']}")
            if r["launches"] != want_launches or r["dense_max_err"] != 0 \
                    or r["dense_checked"] != want_launches:
                raise AssertionError(f"{what}: w8a8_dense {r['launches']} "
                                     f"launches (want {want_launches}), "
                                     f"{r['dense_checked']} checked, max "
                                     f"|kernel - plain| "
                                     f"{r['dense_max_err']}")
            if r["products"] != r["want_products"] or (
                    r["mismatched"] and (r["first_input_diff"] is None or
                                         r["mismatched"][0]
                                         < r["first_input_diff"])):
                raise AssertionError(f"{what}: exponents of "
                                     f"{r['products']} products, mismatched "
                                     f"{r['mismatched'][:5]}, first input "
                                     f"differing {r['first_input_diff']}")
            launches += r["launches"]
            log(f"{what}: seconds {r['secs']}; per step max |diff| "
                f"{r['step_max']}, beyond {r['step_beyond']}; "
                f"params {r['resident']:,} bytes on the rank "
                f"against {total:,} in one process ({r['resident'] / total:.4f}"
                f"; its share {share:,.0f}); logits of the prefill and "
                f"{TP_DECODE} decode steps max |diff| {r['max_diff']:.6f}, "
                f"{r['beyond']} beyond atol {CONSIST_ATOL} + rtol "
                f"{CONSIST_RTOL}; greedy tokens equal on {r['agree']} of "
                f"{r['compared']} (row, step)s without a near-tie ({r['ties']}"
                f" near-ties, {r['tie_agree']} of them equal); W8A8 "
                f"exponents of {r['products']} prefill products compared, "
                f"{len(r['mismatched'])} mismatched (first input differing: "
                f"{r['first_input_diff']}); w8a8_dense {r['launches']} "
                f"launches, {r['dense_checked']} held against the plain "
                f"version, max |kernel - plain| {r['dense_max_err']}")
            log(f"[tp] {card} | {TP_LABEL}: qwen3_14b x{TP_QWEN_LAYERS} {q} "
                f"rank {g['rank']}: "
                f"prefill {r['prefill_ms']:.2f} ms ({LM_REQUESTS}x"
                f"{LM_PROMPT}), warm decode {r['decode_ms']:.3f} ms a step "
                f"(one process {one[q]['prefill_ms']:.2f} / "
                f"{one[q]['decode_ms']:.3f}); a decode step's "
                f"{r['collectives']} collectives ({r['collective_bytes']:,} "
                f"bytes) replayed alone {r['gather_ms']:.3f} ms")

    # (b): the steps against the one-process steps, the resume, and the
    # sharded checkpoint restored here
    for g in got:
        r = g["train"]
        what = f"[tp] (b) stablelm_3b x{TP_TRAIN_LAYERS} rank {g['rank']}"
        for key, rtol in (("losses", LM_TRAIN_CPU_RTOL["loss"]),
                          ("norms", LM_TRAIN_CPU_RTOL["grad_norm"])):
            for a, b in zip(r[key], train_one[key]):
                if not abs(a - b) <= rtol * abs(b):
                    raise AssertionError(f"{what}: {key} {r[key]} against "
                                         f"one process {train_one[key]}")
        if not r["resume_equal"]:
            raise AssertionError(f"{what}: the resumed run differs from the "
                                 "uninterrupted one")
    cfg = tp_train_cfg()
    ex = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                  steps.train_state_structs(cfg))
    t0 = time.perf_counter()
    step_n, restored = ckpt.restore_latest(TP_DIR / "ckpt", ex, into=True)
    restore_s = time.perf_counter() - t0
    from repro_torch.dist import sharding
    from repro_torch.dist.api import Mesh
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.tree import leaves
    record = Mesh(("pod", "data", "model"), (1, 1, TP_RANKS),
                  [dev] * TP_RANKS)
    st_spec = steps.make_cell(cfg, ShapeSpec("tp_train", "train",
                                             TP_TRAIN_S, TP_TRAIN_B),
                              record)[2][0]
    specs = sharding.flat_specs(restored, st_spec)
    for g in got:
        mine = [tp_digest(tp_share(t, spec, g["tp_rank"]))
                for t, spec in zip(leaves(restored), specs)]
        if step_n != 1 or mine != g["train"]["saved_digest"]:
            raise AssertionError(f"[tp] (b) the sharded checkpoint restored "
                                 f"in one process: rank {g['rank']}'s share "
                                 "differs from the state it saved")
    n_leaves = len(specs)
    del ex, restored
    gc.collect()
    torch.cuda.empty_cache()
    for g in got:
        r = g["train"]
        log(f"[tp] {card} | {TP_LABEL}: (b) stablelm_3b x{TP_TRAIN_LAYERS} "
            f"(d {tp_train_cfg().d_model}, B {TP_TRAIN_B} x S {TP_TRAIN_S}) rank "
            f"{g['rank']}: "
            f"state {r['resident']:,} bytes; steps "
            + ", ".join(f"{ms:.1f}" for ms in r["ms"])
            + f" ms, peak {r['peak_gib']:.2f} GiB; losses {r['losses']} "
            f"(one process {train_one['losses']}), grad norms {r['norms']} "
            f"(one process {train_one['norms']}), within rtol "
            f"{LM_TRAIN_CPU_RTOL['loss']} / {LM_TRAIN_CPU_RTOL['grad_norm']};"
            f" sharded save {r['save_s']:.1f} s, restore "
            f"{r['restore_s']:.1f} s, (b) {r['secs']} s; a fault after step 1 and the resume "
            "equal the uninterrupted run bit for bit")
    log(f"[tp] (b) the sharded checkpoint of step 1 restored into one "
        f"process ({restore_s:.1f} s): each rank's share of every leaf "
        f"({n_leaves}) has the digest of the share that rank saved")
    shutil.rmtree(TP_DIR, ignore_errors=True)
    dry = tp_dryrun(card, got)

    # (c): a (data 2, model 2) world of 4 ranks
    inputs = multi_inputs()
    reg = ModelRegistry(device=dev)
    want = {b: [t.cpu() for t in reg.executable(MULTI_MID, b)(inputs[b])]
            for b in MULTI_BUCKETS}
    del reg
    t0 = time.perf_counter()
    got_c = dworld.spawn(tp_c_rank, 4, backend="gloo", device="cuda",
                         timeout_s=300, deadline_s=600, args=(inputs,))
    c_s = time.perf_counter() - t0
    caps = {"routing_q7": 0, "squash_q7": 0}
    for g in got_c:
        what = f"[tp] (c) rank {g['rank']} (data {g['dp_rank']}, model " \
            f"{g['tp_rank']})"
        (l1, l2), (n1, n2) = g["loss"], g["norm"]
        if abs(l2 - l1) > LM_TRAIN_CPU_RTOL["loss"] * abs(l1) or \
                abs(n2 - n1) > LM_TRAIN_CPU_RTOL["grad_norm"] * abs(n1) or \
                g["logit_beyond"]:
            raise AssertionError(f"{what}: loss {l2} / {l1}, grad norm {n2} "
                                 f"/ {n1}, {g['logit_beyond']} logits beyond"
                                 f" (max {g['logit_max_diff']})")
        for b in MULTI_BUCKETS:
            if not all(torch.equal(a, w) for a, w in zip(g["waves"][b],
                                                         want[b])):
                raise AssertionError(f"{what}: bucket {b} wave differs from "
                                     "the one-process wave")
            for k in caps:
                caps[k] += g["launches"][b][k]
        log(f"{what}: qwen3_14b d 256 through make_cell, loss {l2:.6f} "
            f"(one process {l1:.6f}), grad norm {n2:.6f} ({n1:.6f}), "
            f"prefill and {TP_C_STEPS} decode logits max |diff| "
            f"{g['logit_max_diff']:.6f}, none beyond; mnist@cuda waves at "
            f"buckets {MULTI_BUCKETS} bit-identical to the one-process "
            f"wave, launches " + "; ".join(
                f"{b}: {g['launches'][b]}" for b in MULTI_BUCKETS))
    if min(caps.values()) == 0:
        raise AssertionError(f"[tp] (c) the waves launched {caps}")
    log(f"[tp] phase 19 passed in {time.perf_counter() - t_phase:.1f} s "
        f"((a)-(b) world {world_s:.1f} s, (c) world {c_s:.1f} s)")
    return {"launches": {"w8a8_dense": launches, **caps},
            "serve": {q: [{k: v for k, v in g[q].items()
                           if k not in ("mismatched",)} for g in got]
                      for q in ("none", "w8a8")},
            "train": [{k: v for k, v in g["train"].items()
                       if k != "saved_digest"} for g in got],
            "one": one, "train_one": train_one, "dryrun": dry}


# ---------------------------------------------------------------------------
# phase 20: the repository's four examples on the port (examples/torch_*.py)
# ---------------------------------------------------------------------------
EXAMPLES_DIR = ROOT / "build" / "examples_smoke"
EXAMPLE_DATASETS = ("mnist", "smallnorb", "cifar10")
EXAMPLE_CAPS_STEPS = 250         # the example's --steps default; with
                                 # --ckpt-dir its float run saves every 50
EXAMPLE_LM_ARGV = ["--arch", "stablelm_3b", "--no-reduce"]
EXAMPLE_LM_GEN = 24                # the example's --gen default
EXAMPLE_TRAIN_LM_STEPS = (200, 220)  # the default run, then its resume
# the reference example's own MNIST row at its defaults, run once on a
# CPU (PERF.md §6): the card's acc_f32 may lie at most 0.05 below it
REF_MNIST_ACC_F32 = 1.0
REF_ACC_MARGIN = 0.05
# the spans of table2_rows timed on the host clock, each after a
# synchronize: (module, attribute) patched for the run
TABLE2_SPANS = (("repro_torch.captrain.evalq", "eval_q7"),
                ("repro_torch.captrain.evalq", "eval_float"),
                ("repro_torch.captrain.trainer", "CapsTrainer.fit"),
                ("repro_torch.captrain.trainer", "CapsTrainer.quantize"),
                ("repro_torch.edge", "lower"),
                ("repro_torch.obs.numerics", "run_numerics"))


def table2_spans(secs: dict):
    """Patch TABLE2_SPANS so that each call's host seconds, ended by a
    synchronize, add up in secs[attribute].  Returns the undo."""
    import importlib
    import torch
    undo = []
    for mod_name, attr in TABLE2_SPANS:
        owner = importlib.import_module(mod_name)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        orig = owner.__dict__[name]

        def timed(*a, _orig=orig, _attr=attr, **kw):
            t0 = time.perf_counter()
            try:
                return _orig(*a, **kw)
            finally:
                torch.cuda.synchronize()
                secs[_attr] = secs.get(_attr, 0.0) + time.perf_counter() - t0
        setattr(owner, name, timed)
        undo.append((owner, name, orig))

    def restore():
        for owner, name, orig in reversed(undo):
            setattr(owner, name, orig)
    return restore


def run_example(name: str, argv: list, pending: list | None = None,
                checked: dict | None = None) -> tuple:
    """`examples/NAME.py`'s `main(argv)` in this process, its printed
    lines captured and logged: (its result, its lines, wall seconds);
    then the launches it recorded in `pending` (`launch_spy`) are held
    against their plain versions into `checked`."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = mod.main([str(a) for a in argv])
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[examples]   {line}")
    secs = time.perf_counter() - t0
    if pending is not None:
        check_pending(pending, checked)
    return res, buf.getvalue().splitlines(), secs


def examples_phase(dev, card: str) -> dict:
    """Phase 20: each example's `main(argv)` in this process, every
    `routing_q7`, `squash_q7`, `conv2d_q7` and `w8a8_dense` launch held
    against its plain version (`launch_spy`), the counts from 0 just
    before the first example and read after each.  (a) torch_quickstart: the cuda
    backend bit-identical to the torch oracle, `quickstart OK`; (b)
    torch_train_capsnet --dataset mnist, smallnorb, cifar10 at the
    reference's defaults (with --ckpt-dir, which keeps each float state):
    the Table-2 rows on the card, each saving_pct equal to
    TABLE2_FOOTPRINTS', acc_f32 above twice chance and MNIST's within
    REF_ACC_MARGIN of the reference's CPU row, table2_rows' spans timed;
    (c) torch_serve_quantized_lm --arch stablelm_3b --no-reduce: bf16 and
    W8A8 in full, (7 L + 1) x gen `w8a8_dense` launches; (d)
    torch_train_lm at its defaults, then with --steps 220, which must
    resume at step 200; it launches no kernel of the port.  After the
    counts are read, (c) once more with the recorder off, for the times
    a user sees."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels import routing as kr
    from repro_torch.kernels import squash as ks
    from repro_torch.kernels import w8a8_dense as kd
    from repro_torch.nn.config import CAPSNET_CONFIGS
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    kernels = {"routing_q7": kr, "squash_q7": ks, "w8a8_dense": kd,
               "conv2d_q7": kc}
    checked = {name: [] for name in kernels}
    pending = []

    def counts():       # the module attributes: the spies while patched
        return {name: getattr(mod, name).launches
                for name, mod in kernels.items()}

    def launched(before):
        return {k: v - before[k] for k, v in counts().items()}
    for name, mod in kernels.items():            # from 0 just before
        getattr(mod, name).launches = 0
    out = {"runs": {}}
    undo = launch_spy(pending)
    try:
        # (a) the quickstart
        before = counts()
        res, lines, secs = run_example("torch_quickstart", [], pending,
                                       checked)
        got = launched(before)
        if res["match"] is not True or lines[-1] != "quickstart OK" or \
                min(got["routing_q7"], got["squash_q7"],
                    got["conv2d_q7"]) == 0:
            raise AssertionError(f"torch_quickstart: match {res['match']}, "
                                 f"last line {lines[-1]!r}, launches {got}")
        fp = res["footprint"]
        log(f"[examples] {card} | torch_quickstart: {secs:.1f} s; fp32 "
            f"{fp['fp32_kb']:.2f} KB -> int8 {fp['int8_kb']:.2f} KB, cuda "
            f"== torch oracle, preds {res['preds']}, flash "
            f"{res['report']['flash_bytes']}, RAM {res['report']['ram_bytes']}"
            f", arena {res['report']['arena_bytes']} B; launches {got}")
        out["runs"]["torch_quickstart"] = dict(
            s=secs, launches=got, saving_pct=fp["saving_pct"],
            preds=res["preds"])

        # (b) the paper's Table 2 for its three networks
        for ds in EXAMPLE_DATASETS:
            cfg = CAPSNET_CONFIGS[f"capsnet_{ds}"]
            fp32, int8 = TABLE2_FOOTPRINTS[ds]
            spans = {}
            before = counts()
            restore = table2_spans(spans)
            try:
                rows, _, secs = run_example(
                    "torch_train_capsnet",
                    ["--dataset", ds, "--ckpt-dir", EXAMPLES_DIR / ds],
                    pending, checked)
            finally:
                restore()
            got = launched(before)
            for r in rows:
                log(f"[examples] {card} | torch_train_capsnet --dataset {ds} "
                    f"{r.rounding}: acc_f32 {r.acc_f32!r}, acc_ptq "
                    f"{r.acc_ptq!r}, acc_qat {r.acc_qat!r}, saving_pct "
                    f"{r.saving_pct!r}, flash {r.flash_bytes}, RAM "
                    f"{r.ram_bytes}, est. M7 {r.est_ms_m7:.2f} ms")
                if r.saving_pct != 100.0 * (1 - int8 / fp32):
                    raise AssertionError(f"{ds}: saving_pct {r.saving_pct!r}"
                                         f", pinned {fp32} -> {int8} bytes")
                if not r.acc_f32 > 2.0 / cfg.num_classes:
                    raise AssertionError(f"{ds}: acc_f32 {r.acc_f32} not "
                                         f"above twice chance")
                if ds == "mnist" and \
                        r.acc_f32 < REF_MNIST_ACC_F32 - REF_ACC_MARGIN:
                    raise AssertionError(
                        f"mnist: acc_f32 {r.acc_f32} more than "
                        f"{REF_ACC_MARGIN} below the reference's CPU row "
                        f"({REF_MNIST_ACC_F32})")
            if min(got["routing_q7"], got["squash_q7"],
                   got["conv2d_q7"]) == 0:
                raise AssertionError(f"{ds}: eval_q7 launched {got}")
            log(f"[examples] {card} | torch_train_capsnet --dataset {ds}: "
                f"{secs:.1f} s wall; " + ", ".join(
                    f"{k.split('.')[-1]} {v:.1f} s" for k, v in spans.items())
                + f"; launches {got}; its float state of step "
                f"{EXAMPLE_CAPS_STEPS} kept in {EXAMPLES_DIR / ds} (for "
                f"tools/table2_witness.py)")
            out["runs"][f"torch_train_capsnet {ds}"] = dict(
                s=secs, spans_s=spans, launches=got,
                rows=[dataclasses.asdict(r) for r in rows])

        # (c) an LM in full, bf16 and W8A8
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        res, _, secs = run_example("torch_serve_quantized_lm",
                                   EXAMPLE_LM_ARGV, pending, checked)
        got = launched(before)
        peak = torch.cuda.max_memory_allocated() / 2**30
        cfg = get_config("stablelm_3b")
        want = (7 * cfg.num_layers + 1) * EXAMPLE_LM_GEN
        if got["w8a8_dense"] != want:
            raise AssertionError(f"stablelm_3b W8A8: {got['w8a8_dense']} "
                                 f"w8a8_dense launches, want {want}")
        gen = EXAMPLE_LM_GEN - 1
        log(f"[examples] {card} | torch_serve_quantized_lm "
            f"{' '.join(EXAMPLE_LM_ARGV)}: {secs:.1f} s; "
            f"{res['fp_bytes'] / 2**20:.1f} MiB bf16 -> "
            f"{res['q_bytes'] / 2**20:.1f} MiB W8A8; prefill "
            f"{res['prefill_s'][0] * 1e3:.2f} / "
            f"{res['prefill_s'][1] * 1e3:.2f}"
            f" ms, decode {res['decode_s'][0] * 1e3 / gen:.3f} / "
            f"{res['decode_s'][1] * 1e3 / gen:.3f} ms a step (float / "
            f"W8A8); agreement {res['agree']:.3f}; peak {peak:.2f} GiB; "
            f"w8a8_dense {got['w8a8_dense']}, each exact")
        out["runs"]["torch_serve_quantized_lm"] = dict(
            s=secs, launches=got, peak_gib=peak, fp_bytes=res["fp_bytes"],
            q_bytes=res["q_bytes"], prefill_ms=[t * 1e3 for t in
                                                res["prefill_s"]],
            decode_ms_step=[t * 1e3 / gen for t in res["decode_s"]],
            agree=res["agree"])
        del res
        gc.collect()
        torch.cuda.empty_cache()

        # (d) an LM trained, then resumed
        ck = EXAMPLES_DIR / "train_lm"
        for steps in EXAMPLE_TRAIN_LM_STEPS:
            before = counts()
            res, lines, secs = run_example("torch_train_lm", [
                "--ckpt-dir", ck, "--steps", steps], pending, checked)
            got = launched(before)
            rows = res["log"]
            losses = [r["loss"] for r in rows]
            ms = statistics.median(r["ms"] for r in rows[1:] or rows)
            resumed = steps != EXAMPLE_TRAIN_LM_STEPS[0]
            want_start = EXAMPLE_TRAIN_LM_STEPS[0] if resumed else 0
            if res["start"] != want_start or (resumed and (
                    f"[resume] step {want_start}" not in lines)) or \
                    any(got.values()) or \
                    not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"torch_train_lm --steps {steps}: start "
                                     f"{res['start']}, launches {got}, "
                                     f"losses {losses[:3]}...")
            if not resumed and not losses[-1] < losses[0]:
                raise AssertionError(f"torch_train_lm: loss {losses[0]} -> "
                                     f"{losses[-1]}")
            log(f"[examples] {card} | torch_train_lm --steps {steps}: "
                f"{secs:.1f} s; steps {res['start']}..{steps - 1}, loss "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}, median {ms:.2f} ms a "
                f"step (B 4 x S 256)")
            out["runs"][f"torch_train_lm {steps}"] = dict(
                s=secs, start=res["start"], first_loss=losses[0],
                last_loss=losses[-1], ms_step=ms)
            del res
        shutil.rmtree(ck, ignore_errors=True)
    finally:
        undo()
        pending.clear()
    out["launches"] = counts()
    out["max_abs_err"] = {k: max(v, default=0) for k, v in checked.items()}
    out["checked"] = {k: len(v) for k, v in checked.items()}
    for name, n in out["launches"].items():
        if out["checked"][name] != n or out["max_abs_err"][name] != 0:
            raise AssertionError(f"{name}: {n} launches, "
                                 f"{out['checked'][name]} held against the "
                                 f"plain version, max |kernel - plain| "
                                 f"{out['max_abs_err'][name]}")

    # (c) again with the recorder off, after the counted window (its
    # launches are not counted): the times a user of the example sees;
    # beside the recorded run's, the recorder's cost (its bf16 path
    # launches nothing recorded, so its change is the order's alone)
    gc.collect()
    torch.cuda.empty_cache()
    res, _, secs = run_example("torch_serve_quantized_lm", EXAMPLE_LM_ARGV)
    spied = out["runs"]["torch_serve_quantized_lm"]
    bare = dict(s=secs, prefill_ms=[t * 1e3 for t in res["prefill_s"]],
                decode_ms_step=[t * 1e3 / gen for t in res["decode_s"]],
                agree=res["agree"])
    out["runs"]["torch_serve_quantized_lm, recorder off"] = bare
    log(f"[examples] {card} | torch_serve_quantized_lm "
        f"{' '.join(EXAMPLE_LM_ARGV)} again, the recorder off (not "
        f"counted): {secs:.1f} s; prefill {bare['prefill_ms'][0]:.2f} / "
        f"{bare['prefill_ms'][1]:.2f} ms, decode "
        f"{bare['decode_ms_step'][0]:.3f} / {bare['decode_ms_step'][1]:.3f}"
        f" ms a step (float / W8A8) against {spied['decode_ms_step'][0]:.3f}"
        f" / {spied['decode_ms_step'][1]:.3f} with it on; agreement "
        f"{bare['agree']:.3f} ({spied['agree']:.3f} with it on)")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    log(f"[examples] {card} | phase 20 passed in {out['s']:.1f} s; launches "
        f"{out['launches']}, each held against its plain version")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--device-times"], ["--forward-worker"],
                    ["--train-lm"], ["--train-times"], ["--multi"],
                    ["--tp"], ["--tp-count"], ["--examples"]) and (
            len(argv) != 2 or argv[0] != "--forward-pairs"):
        print("usage: chip_smoke.py [--device-times | --train-lm | "
              "--train-times | --multi | --tp | --tp-count | --examples | "
              "--forward-pairs PARENT_TREE]",
              file=sys.stderr)
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
    global HBM_BYTES_PER_S, INT8_OPS_PER_S, BF16_OPS_PER_S
    try:
        from repro_torch.launch import roofline
        HBM_BYTES_PER_S, INT8_OPS_PER_S, BF16_OPS_PER_S = \
            roofline.HBM_BW, roofline.PEAK_INT8, roofline.PEAK_BF16
    except ImportError:  # a tree older than the module (--device-times)
        HBM_BYTES_PER_S, INT8_OPS_PER_S, BF16_OPS_PER_S = \
            3.35e12, 1.979e15, 989e12
    if argv[:1] == ["--forward-pairs"]:
        card = card_line()
        forward_pairs(Path(argv[1]).resolve(), card)
        log(card)
        return 0
    if argv == ["--train-times"]:
        card = card_line()
        *_, times = mnist_train_times(torch.device("cuda"), card)
        log(card)
        log(json.dumps({"train_times": times}))
        return 0
    if argv == ["--tp-count"]:
        print(json.dumps({"tp_count": tp_count()}))
        return 0
    if argv == ["--train-lm"]:
        card = card_line()
        if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8":
            print("chip_smoke --train-lm: run with CUBLAS_WORKSPACE_CONFIG="
                  ":4096:8 (deterministic cuBLAS)", file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        res = train_lm_child(torch.device("cuda"), card)
        log(f"[train-lm] phase 16 passed in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"train_lm": res}))
        return 0
    from repro_torch.kernels import build
    from repro_torch.kernels import conv as kc
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
    repolint_port()
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
        dt.update(w8a8_device_times(dev, card))
        dt["conv_q7"] = conv_rows(dev, card)
        log(card)
        log(json.dumps({"device_times": dt}))
        return 0
    if argv == ["--forward-worker"]:
        forward_worker(dev)
        return 0
    if argv == ["--multi"]:
        multi = multi_phase(dev, card)
        log(card)
        log(json.dumps({"multi": multi}))
        return 0
    if argv == ["--tp"]:
        tp = tp_phase(dev, card)
        log(card)
        log(json.dumps({"tp": tp}))
        return 0
    if argv == ["--examples"]:
        examples = examples_phase(dev, card)
        log(card)
        log(json.dumps({"examples": examples}))
        return 0

    for name in ("q7_matmul", "w8a8_matmul", "w8a8_dense"):
        sass = sass_counts(libs[name])
        log(f"[build] {name}: SASS holds {sass['IGMMA']} IGMMA (wgmma) and "
            f"{sass['IMMA']} IMMA (mma.sync) instructions")
        if min(sass.values()) == 0:
            raise AssertionError(f"{name}: a main loop lost its tensor-core "
                                 f"instruction: {sass}")

    # phase 2
    errs = check_kernels(dev)

    phase_done(2, t0)

    # phase 3: counts from 0 just before the main path, read just after
    ks.squash_q7.launches = 0
    kr.routing_q7.launches = 0
    kc.conv2d_q7.launches = kc.conv2d_q7_per_channel.launches = 0
    run = serve_main_path(dev)
    launches = {"squash_q7": ks.squash_q7.launches,
                "routing_q7": kr.routing_q7.launches,
                "conv2d_q7": conv_launches(kc)}
    log(f"[main] mnist@cuda lazy PTQ on the card {run['ptq_s']:.2f} s; "
        f"launches over the main path: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    check_conv_launches("main path", launches, 2)
    plan_card = check_calibration(run["spec"], dev)
    log(f"[main] registry plan equals the card calibration's plan: "
        f"{plan_card == run['qnet'].plan}")
    check_completions(run)

    # the command a user runs, counted on its own
    from repro_torch.launch import serve_caps
    ks.squash_q7.launches = 0
    kr.routing_q7.launches = 0
    kc.conv2d_q7.launches = kc.conv2d_q7_per_channel.launches = 0
    rc = serve_caps.main(["--model", "mnist@cuda",
                          "--requests", str(N_REQUESTS)])
    cli = {"squash_q7": ks.squash_q7.launches,
           "routing_q7": kr.routing_q7.launches,
           "conv2d_q7": conv_launches(kc)}
    if rc != 0 or min(cli.values()) == 0:
        raise AssertionError(f"serve_caps --model mnist@cuda: exit {rc}, "
                             f"launches {cli}")
    check_conv_launches("serve_caps --model mnist@cuda", cli, 2)
    log(f"[main] serve_caps --model mnist@cuda --requests {N_REQUESTS}: "
        f"launches {cli}")
    fallbacks = get_backend("cuda").fallbacks
    if sum(fallbacks.values()) != 0:
        raise AssertionError(f"default-variant mnist@cuda fell back: "
                             f"{dict(fallbacks)}")

    phase_done(3, t0)

    # phase 4: the artifact path, counted on its own
    artifact = serve_artifact(run, dev)

    phase_done(4, t0)

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

    phase_done(5, t0)

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

    phase_done(6, t0)

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

    phase_done(7, t0)

    # phase 10: training; its int8 path's counts from 0 inside, read after
    train = train_phase(dev, card)

    phase_done(10, t0)

    # phase 11: the search; its counts from 0 inside, read after
    search = search_phase(dev, card)

    phase_done(11, t0)

    # phase 12: the LM serving path and the host mesh; w8a8_dense's count
    # from 0 just before the qwen3_14b W8A8 run, read just after
    lm = lm_phase(dev, card, run)
    times["w8a8_dense"] = time_dense(dev, card)

    phase_done(12, t0)

    # phase 13: the MoE FFN; w8a8_bmm's and w8a8_dense's counts from 0
    # just before each W8A8 run, read just after
    moe = moe_phase(dev, card)
    times["w8a8_bmm"] = time_bmm(dev, card)

    phase_done(13, t0)

    # phase 14: the SSM and hybrid LMs, phase 15: the encoder-decoder;
    # w8a8_dense's and w8a8_bmm's counts from 0 just before each W8A8 run,
    # read just after
    ssm = ssm_phase(dev, card)
    phase_done(14, t0)
    encdec = encdec_phase(dev, card)
    phase_done(15, t0)

    # phase 9, before phase 8: a torch.profiler session leaves the later
    # launches of the process slower, and phase 9 times the host's path
    traced_serving(run, card)
    obs_clis(run, dev, card)
    serve_widened_geometries(dev, card)
    probes_off_times(run, dev, card)

    phase_done(9, t0)

    # phase 8: device times from the profiler, and each cluster size
    dt = device_times(dev)
    log_device_times(card, dt)
    times["conv_q7"] = dict(shapes=conv_rows(dev, card))
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
    dense_device_times(dev, card, times["w8a8_dense"]["shapes"])
    times["w8a8_dense"]["device_ms"] = \
        times["w8a8_dense"]["shapes"][0]["device_ms"]
    bmm_device_times(dev, card, times["w8a8_bmm"]["shapes"])
    times["w8a8_bmm"]["device_ms"] = \
        times["w8a8_bmm"]["shapes"][0]["device_ms"]
    recurrent = recurrent_device_counts(dev, card)
    for name in ("q7_matmul", "w8a8_matmul"):
        times[name]["device_ms"] = dt[name][shape_key(HEADLINE_GEMM)]
        for row in times[name]["shapes"]:
            row["device_ms"] = dt[name][shape_key(row["shape"])]
            row["int_mm_device_ms"] = dt["int_mm"].get(
                shape_key(row["shape"]))

    phase_done(8, t0)

    # phase 16: LM training in a process of its own; it launches none of
    # the kernels, and no profiler session follows it
    train_lm = train_lm_phase(card)
    phase_done(16, t0)

    # phase 17: the dry run on the host's CPU (one card and 512), its
    # bounds held against the steps phases 12 and 16 measured (no
    # launch, no timing of its own)
    dryrun = dryrun_phase(card, lm, train_lm)
    phase_done(17, t0)

    # phase 18: data-parallel meshes across processes; each rank's counts
    # from 0 just before its wave, read just after
    multi = multi_phase(dev, card)
    phase_done(18, t0)

    # phase 19: tensor parallelism; each rank's w8a8_dense count from 0
    # just before its meshed run, its routing/squash counts before each
    # wave, read just after
    tp = tp_phase(dev, card)
    phase_done(19, t0)

    # phase 20, last: the repository's examples; the kernels' counts from
    # 0 just before its first example, read after its last
    examples = examples_phase(dev, card)
    for name in ("routing_q7", "squash_q7"):
        errs[name] = max(errs[name], examples["max_abs_err"][name])
    phase_done(20, t0)

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
                 "replaces": replaces,
                 "launches": launches[name]
                 + examples["launches"].get(name, 0),
                 "max_abs_err": errs[name], "ms": t["ms"],
                 "device_ms": t["device_ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"],
                 "library_ms": t.get("int_mm_ms"),
                 "library_note": "torch._int_mm, cuBLASLt's int8 x int8 -> "
                 "int32 product alone (no shift epilogue), at the headline "
                 "shape; the port never calls it"
                 if t.get("int_mm_ms") is not None else "no single PyTorch "
                 "call computes this function", "shape": t["shape"]}
        if name in artifact["launches"]:
            entry["launches_by_path"] = {
                "main": launches[name],
                "artifact": artifact["launches"][name],
                "train": train["launches"][name],
                "search": search["launches"][name],
                "multi": multi["launches"][name],
                "multi_nccl": multi["nccl_launches"][name],
                "tp": tp["launches"][name],
                "examples": examples["launches"][name]}
        else:
            entry["launches_by_path"] = {"multi": 0, "tp": 0, "examples": 0}
        if "shapes" in t:
            entry["shapes"] = t["shapes"]
            entry["yardstick"] = (
                "int_mm_ms: torch._int_mm, cuBLASLt's int8 x int8 -> int32 "
                "product alone (no shift epilogue), where it takes the "
                "shape; the port never calls it")
        record["kernels"].append(entry)
    t = times["w8a8_dense"]
    record["kernels"].append({
        "name": "w8a8_dense", "route": "cuda", "source": csrc
        + "w8a8_dense.cu", "replaces": None,
        "replaces_note": "no TPU kernel: the reference computes this "
        "product with XLA's int8 dot_general and an elementwise pow2 "
        "dequantization, src/repro/quant/lm_quant.py:76 (q_dense)",
        "launches": lm["launches"] + examples["launches"]["w8a8_dense"],
        "launches_by_path": {**lm["launches_by_path"],
                             **moe["dense_launches_by_path"],
                             **ssm["dense"], **encdec["dense"],
                             "multi": 0, "tp": tp["launches"]["w8a8_dense"],
                             "examples": examples["launches"]["w8a8_dense"]},
        "max_abs_err": max(lm["max_abs_err"], ssm["max_abs_err"],
                           encdec["max_abs_err"],
                           examples["max_abs_err"]["w8a8_dense"]),
        "ms": t["ms"],
        "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["int_mm_ms"],
        "library_note": "torch._int_mm (cuBLASLt's int8 x int8 -> int32 "
        "product alone, no dequantization) where it takes the shape (M > "
        "16): it refuses the headline decode shape, and the prefill row "
        "of `shapes` holds it; the port never calls it",
        "shape": t["shape"], "shapes": t["shapes"],
        "lm": {k: lm[k] for k in ("qwen_float", "qwen_w8a8", "gemma_float",
                                  "gemma_w8a8", "paligemma_float",
                                  "qwen2_72b_w8a8", "token_agreement")},
        "ssm": ssm["runs"], "encdec": encdec["runs"],
        "recurrent_device_launches": recurrent})
    for v in record["kernels"][-1]["lm"].values():
        if isinstance(v, dict):
            v.pop("tokens", None)
    t = times["w8a8_bmm"]
    record["kernels"].append({
        "name": "w8a8_bmm", "route": "cuda", "source": csrc
        + "w8a8_dense.cu", "replaces": None,
        "replaces_note": "no TPU kernel: the reference computes the MoE "
        "expert products with XLA's int8 einsum and an elementwise pow2 "
        "dequantization, src/repro/quant/lm_quant.py:86 (q_einsum); the "
        "batched face of w8a8_dense.cu's kernel, one expert a batch entry",
        "launches": moe["launches"],
        "launches_by_path": {**moe["launches_by_path"], **ssm["bmm"],
                             "multi": 0, "tp": 0, "examples": 0},
        "max_abs_err": max(moe["max_abs_err"], ssm["max_abs_err"]),
        "ms": t["ms"],
        "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["int_mm_ms"],
        "library_note": "E calls of torch._int_mm (cuBLASLt's int8 x int8 "
        "-> int32 product alone, no dequantization) where it takes the "
        "shape (M > 16): it refuses the headline decode shape, and the "
        "prefill row of `shapes` holds it; the port never calls it",
        "shape": t["shape"], "shapes": t["shapes"], "moe": moe["runs"]})
    log("kernels: " + ", ".join(f"{k['name']} x{k['launches']}"
                                for k in record["kernels"]))
    log(f"[train-lm] summary {json.dumps(train_lm)}")
    log(f"[dryrun] summary {json.dumps(dryrun)}")
    log(f"[multi] summary {json.dumps(multi)}")
    log(f"[tp] summary {json.dumps(tp)}")
    log(f"[examples] summary {json.dumps(examples)}")
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
