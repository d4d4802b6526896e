"""One run of a language-model cell (`"family": "lm"`): set-up, the
measured window of whole waves, a traced run's profiled stretch, the
comparison with the plain reference, and the result.

Set-up (what `setup_s` measures, from the process's start): the W8A8
kernel library loaded through `repro_torch.kernels.build` (built on the
first run in a checkout), the model built with `build_model` from the
port's configuration of `arch` with the file's keys laid over it, the
float weights drawn leaf by leaf from the seed (`lm_data`) and each put
at once through the port's W8A8 quantization (`quantize_lm_params`,
each call an `lm.ptq` span, the card synchronised around it), the prompt
pool drawn on the device, and one prefill and `WARM_STEPS` decode steps
of a wave: every shape of the window (the ring cache's slots are fixed
at `decode_alloc`, so every decode step has the same shapes).

A wave (`WaveRunner.wave`): `batch` prompts of the pool, `LM.prefill` at
`decode_alloc(prompt_len + gen)` slots, then `gen - 1` greedy
`LM.decode_step`s; the argmax runs on the card, as `launch/serve.py`
takes it, and the wave ends with its tokens' copy to the host.  The
window starts a new wave while less than `seconds` have passed and ends
when the last one has completed: it is whole waves.  The harness opens a
span around each call into the program: `lm.prefill`, `lm.decode_step`
and `lm.sample` (the argmax and the token and logits kept); a traced run
(`--trace 1`) keeps each span's start and end over the window, then runs
the prefill and the first `PROFILED_STEPS` decode steps of one more
wave, outside the window, under `torch.profiler`, with the spans as
`record_function` ranges (a whole wave's trace takes minutes to reduce;
every decode step launches the same work, so `lm_yardstick` counts the
profiled steps for all of a wave's).  The profiled stretch runs the kept
wave's prompts again and records, from every call, the port's MoE
routes and its activations' exponents (`recorded`: the program's own
tensors, kept, so nothing is added to the card's work): the experts each
MoE call reached, which `lm_yardstick`'s roofline counts, and, against
the reference's over the same tokens, `route_mismatch` and
`exponent_flips` in the detail line.

One wave of the window, drawn from the seed, keeps its tokens and its
logits on the card.  After the window (the memory peak read, the
program's state freed) the reference recomputes that wave and `lm_judge`
compares.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import random
import tempfile
import time
from pathlib import Path

from portbench import lm_data, lm_judge, lm_reference, lm_yardstick, spec
from portbench.harness import _Parts, forbidden_modules
from portbench.profiling import Profile

NULL = contextlib.nullcontext()
PRECISION = "w8a8"        # the port's `quantize_lm_params` tree
WARM_STEPS = 2            # decode steps of set-up's wave
PROFILED_STEPS = 8        # decode steps of a traced run's profiled stretch


class Spans:
    """The harness's spans by name, each (start, end) on the host clock;
    under `torch.profiler` each also a `record_function` range."""

    def __init__(self, ranges: bool = False):
        self.times = collections.defaultdict(list)
        self.ranges = ranges

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.ranges:
            import torch
            with torch.profiler.record_function(name):
                yield
            return
        t0 = time.perf_counter()
        yield
        self.times[name].append((t0, time.perf_counter()))


@dataclasses.dataclass
class LMRunRecord:
    """What the LM metric readers read (`metrics/<name>.py`)."""
    cell: spec.Cell
    setup_s: float
    window_s: float                # the whole waves of the window, host clock
    waves: int                     # waves run in the window
    batch: int
    prompt_len: int
    gen: int
    wave_s: list                   # each window wave's wall seconds
    wave_ops: float                # useful int8 operations a wave
    ptq_s: float = 0.0             # Σ the `lm.ptq` spans of set-up
    spans: dict | None = None      # traced: {name: [(start, end)]}, window
    profile: Profile | None = None  # traced: the profiled stretch
    profiled_steps: int = 0        # its decode steps
    experts_hit: list | None = None  # traced: experts reached, a MoE call

    @property
    def tokens(self) -> int:
        """Tokens generated in the window: batch x gen a wave."""
        return self.waves * self.batch * self.gen


def program_config(cfg: dict):
    """The port's `ModelConfig` of `cfg["arch"]` with every key of the
    file that names one of its fields laid over it; each such key then
    holds the file's value."""
    from repro_torch.configs.base import ModelConfig, get_config
    base = get_config(cfg["arch"])
    fields = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"name", "source"}
    over = {k: tuple(map(tuple, cfg[k])) if k == "blocks" else cfg[k]
            for k in fields & set(cfg)}
    return dataclasses.replace(base, **over)


def _paths(tree, pre=""):
    """(path, leaf) of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}{i}/")
    else:
        yield pre[:-1], tree


def _nest(flat: dict) -> dict:
    out = {}
    for path, v in flat.items():
        *up, last = path.split("/")
        d = out
        for k in up:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (tuple, list)) else tree[k]
    return tree


def program_tree(model, cfg: dict, seed: int, device, spans: Spans):
    """The program's W8A8 tree of the weights the benchmark draws: the
    float leaves (`lm_reference.leaves`, which must be exactly the
    leaves of the port's float tree, cycles apart), each top-level part
    and each cycle's block put through the port's `quantize_lm_params`
    as soon as it is drawn, the blocks copied into the port's stacked
    layout (taken from its tree on the meta device).  Each quantization
    of drawn leaves is an `lm.ptq` span of `spans`, the card synchronised
    before and after it."""
    import torch
    from repro_torch.quant.lm_quant import quantize_lm_params
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)

    def ptq(tree):
        sync()
        with spans("lm.ptq"):
            out = quantize_lm_params(tree, consume=True)
            sync()
        return out
    meta = model.init(torch.Generator(), "meta")
    want = lm_reference.leaves(cfg)
    have = {}
    for path, leaf in _paths(meta):
        shape = tuple(leaf.shape[1:] if path.startswith("blocks/")
                      else leaf.shape)
        have[path] = (shape, leaf.dtype)
    want_s = {p: (tuple(s), d) for p, (s, d) in want.items()}
    if have != want_s:
        raise ValueError(f"the port's float tree is not the benchmark's: "
                         f"{sorted(set(have.items()) ^ set(want_s.items()))}")
    sizes = lm_reference.sizes_of(cfg)

    def draw(paths, cycle):
        return _nest({p: lm_data.draw_leaf(seed, p, cycle, *want[p], sizes,
                                           device) for p in paths})

    top = [p for p in want if not p.startswith("blocks/")]
    params = ptq(draw(top, 0))
    struct = quantize_lm_params(meta["blocks"])
    blocks = tuple(_nest({p: torch.empty(t.shape, dtype=t.dtype,
                                         device=device)
                          for p, t in _paths(part)}) for part in struct)
    cycles = cfg["num_layers"] // len(cfg["blocks"])
    for ci in range(cycles):
        for i in range(len(blocks)):
            pre = f"blocks/{i}/"
            one = ptq(draw([p for p in want if p.startswith(pre)],
                           ci))["blocks"][str(i)]
            for path, leaf in _paths(one):
                _get(blocks[i], path)[ci].copy_(leaf)
            del one
    params["blocks"] = blocks
    return params


class WaveRunner:
    """Runs whole waves through the port's LM serving path."""

    def __init__(self, model, params, traffic: lm_data.Waves, pool, alloc):
        self.model, self.params, self.t = model, params, traffic
        self.pool, self.alloc = pool, alloc
        self.spans = None

    def span(self, name):
        return NULL if self.spans is None else self.spans(name)

    def wave(self, rows, steps: int | None = None):
        """One wave of the pool's `rows` -> (tokens int64 [B, gen] on the
        host, logits bf16 [gen, B, V] on the card); with `steps`, only the
        prefill and that many decode steps (set-up's warm-up)."""
        import torch
        t, model, params = self.t, self.model, self.params
        dev = self.pool.device
        prompts = self.pool[torch.as_tensor(rows, device=dev)]
        out = torch.empty((t.batch, t.gen), dtype=torch.int64, device=dev)
        kept = None
        with self.span("lm.prefill"):
            logits, cache = model.prefill(params, {"inputs": prompts},
                                          alloc=self.alloc)
        for i in range(t.gen if steps is None else steps + 1):
            if i:
                with self.span("lm.decode_step"):
                    logits, cache = model.decode_step(
                        params, cache, tok, t.prompt_len + i - 1)
            with self.span("lm.sample"):
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                out[:, i] = tok[:, 0]
                if kept is None:
                    kept = logits.new_empty((t.gen,) + tuple(logits.shape))
                kept[i].copy_(logits)
        del cache
        return out.cpu(), kept


@contextlib.contextmanager
def recorded(out: dict):
    """Inside the block, in call order, every call of the port's MoE
    router appends its expert indices (`Routing.eidx`, [G, T, k]) to
    out["routes"], and every activation quantization its exponent (a 0-d
    float32 tensor) to out["exponents"], once for products that share
    one input tensor (q, k and v; w_gate and w_up).  Both are the
    program's own tensors, not copies."""
    import weakref

    from repro_torch.models import moe
    from repro_torch.quant import lm_quant
    real_route, real_quant = moe.route, lm_quant.quantize_activation
    out.setdefault("routes", [])
    out.setdefault("exponents", [])
    last = [None]

    def route(params, xg, cfg):
        r = real_route(params, xg, cfg)
        out["routes"].append(r.eidx)
        return r

    def quantize_activation(x):
        q, e = real_quant(x)
        if last[0] is None or last[0]() is not x:
            out["exponents"].append(e)
            last[0] = weakref.ref(x)
        return q, e

    moe.route, lm_quant.quantize_activation = route, quantize_activation
    try:
        yield
    finally:
        moe.route, lm_quant.quantize_activation = real_route, real_quant


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None) -> tuple:
    """Run one LM cell.  Returns (result dict, detail dict)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from repro_torch.models.transformer import build_model, decode_alloc

    parts = _Parts(t_start)
    parts.mark("imports")
    cuda = device == "cuda"
    cfg = cell.config
    if cfg["precision"] != PRECISION:
        raise ValueError(f"{cell.name}: the LM harness runs {PRECISION!r}, "
                         f"not {cfg['precision']!r}")
    traffic = lm_data.Waves.of(cell.traffic)
    with torch.inference_mode():
        if cuda:
            torch.empty(1, device=device)
            torch.cuda.synchronize()
        parts.mark("device_init")
        if cuda:
            from repro_torch.kernels import build
            build.load("w8a8_dense")
        parts.mark("kernels_load")
        model = build_model(program_config(cfg))
        setup_spans = Spans()
        params = program_tree(model, cfg, seed, device, setup_spans)
        pool = lm_data.prompts(seed, traffic, cfg["vocab_size"], device)
        if cuda:
            torch.cuda.synchronize()
        parts.mark("draw_quantize")
        runner = WaveRunner(model, params, traffic, pool,
                            decode_alloc(traffic.prompt_len + traffic.gen))
        runner.wave(traffic.rows(seed, 0), steps=WARM_STEPS)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        parts.mark("warmup")
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start

        # -- the window: whole waves ----------------------------------------
        spans = Spans() if trace else None
        runner.spans = spans
        # the kept wave: one of the window's, uniform and drawn from the
        # seed, by replacing it with wave w at odds 1 / (w + 1)
        pick = random.Random(seed)
        kept, wave_s = None, []
        t0 = time.perf_counter()
        while not wave_s or time.perf_counter() - t0 < seconds:
            w = len(wave_s)
            ts = time.perf_counter()
            out = program_wave(runner, traffic.rows(seed, w))
            wave_s.append(time.perf_counter() - ts)
            if pick.randrange(w + 1) == 0:
                kept = (w, *out)
            del out
        window_s = time.perf_counter() - t0
        n_waves = len(wave_s)

        if cuda:
            torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        profile = hit = None
        rec = {}
        profile_s, same_tokens = 0.0, False
        if trace and cuda:
            t = time.perf_counter()
            with recorded(rec):
                profile, prof_tokens = _profiled_wave(runner, traffic,
                                                      kept[1])
            hit = experts_hit(rec["routes"], cfg.get("num_experts", 0))
            # the routes stand against the reference's where the profiled
            # wave served the kept wave's tokens again
            n = PROFILED_STEPS + 1
            same_tokens = torch.equal(prof_tokens[:, :n], kept[2][:, :n])
            profile_s = time.perf_counter() - t
        runner.spans = None

        record = LMRunRecord(
            cell=cell, setup_s=setup_s, window_s=window_s, waves=n_waves,
            batch=traffic.batch, prompt_len=traffic.prompt_len,
            gen=traffic.gen, wave_s=wave_s,
            wave_ops=lm_yardstick.wave_ops(cfg, traffic.batch,
                                           traffic.prompt_len, traffic.gen),
            ptq_s=sum(b - a for a, b in setup_spans.times["lm.ptq"]),
            spans=None if spans is None else dict(spans.times),
            profile=profile, experts_hit=hit,
            profiled_steps=PROFILED_STEPS if profile is not None else 0)

        # -- the program's state freed, then the reference --------------------
        k, rows, tokens, logits = kept
        prompts = pool[torch.as_tensor(rows, device=pool.device)]
        del kept, runner, params, model, pool
        gc.unfreeze()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        forbidden = forbidden_modules()
        if forbidden:
            raise SystemExit(f"loaded modules of JAX or the JAX package: "
                             f"{forbidden}")
        t = time.perf_counter()
        checks, notes = judge_wave(cfg, seed, device, prompts, tokens,
                                   logits, unanswered=0)
        ref_s = time.perf_counter() - t
        mismatch = flips = None
        if same_tokens:
            mismatch = route_mismatch(rec["routes"], notes.get("routes"),
                                      traffic.prompt_len)
            flips = exponent_flips(rec["exponents"],
                                   notes.get("act_exponents"))
        del rec

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = record.waves * traffic.batch
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name() if cuda else device,
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": lm_judge.passed(checks), "attempted": attempted,
              "failed": 0, "metrics": metrics, "device": dev}
    if profile is not None:
        dev["busy_s"] = profile.busy_s()
        dev["window_s"] = profile.wall_s
        result["breakdown"] = {"device_ops": profile.top_ops(),
                               "idle_gaps": profile.idle_by_host()}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    detail = {"cell": cell.name, "seed": seed, "seconds": seconds,
              "trace": int(trace), "waves": record.waves,
              "wave_s": wave_s, "window_s": window_s, "setup_s": setup_s,
              "setup_parts_s": parts.s, "ptq_s": record.ptq_s,
              "profile_s": profile_s, "reference_s": ref_s,
              "profiled_steps": record.profiled_steps,
              "route_mismatch": mismatch, "exponent_flips": flips,
              "experts_hit_per_moe_call": None if not hit else
              collections.Counter(hit),
              "kept_wave": k, "compared": notes["compared"],
              "batch": traffic.batch, "prompt_len": traffic.prompt_len,
              "gen": traffic.gen}
    return result, detail


def program_wave(runner: WaveRunner, rows) -> tuple:
    """(rows, tokens, logits) of one wave of the timed path: what the
    comparison judges.  The control and the faults (`lm_faults`) stand in
    here or underneath."""
    tokens, logits = runner.wave(rows)
    return rows, tokens, logits


def judge_wave(cfg, seed, device, prompts, tokens, logits, unanswered,
               served=None):
    """The reference over one wave's prompts and served tokens (int64 [B,
    gen] on the host), and the comparison of `logits` [gen, B, V] and
    `served` (default: the tokens) with it.  Returns (checks, notes)."""
    import torch
    seq = torch.cat([prompts.cpu(), tokens[:, :-1]], dim=1)
    ref = lm_reference.Reference(cfg, seed, device)
    ref_logits, notes = ref.logits(seq.to(device), prompts.shape[1])
    return lm_judge.compare(logits, tokens if served is None else served,
                            ref_logits, notes, unanswered)


def experts_hit(routes: list, E: int) -> list:
    """The number of experts with at least one assignment, a MoE call."""
    import torch
    if not routes:
        return []
    hit = torch.stack([torch.bincount(r.reshape(-1), minlength=E)[:E] > 0
                       for r in routes])
    return hit.sum(1).tolist()


def route_mismatch(routes: list, ref: list | None, prompt_len: int):
    """The program's top-k sets against the reference's over the same
    tokens: `routes` the profiled stretch's calls in order (the prefill's
    [B, P, k] a MoE layer, then each decode step's [1, B, k] a layer),
    `ref` the reference's [B, T, k] a MoE layer, of which the stretch's
    first positions are compared.  Returns {"route_mismatch":
    the share of (layer, token) sets that differ, "tokens": the share of
    tokens whose set differs in some layer, "prefill" / "decode": the
    share of (layer, token) sets that differ there}, or None."""
    import torch
    if not ref or not routes or len(routes) % len(ref):
        return None
    L = len(ref)
    prog = [torch.cat([routes[l]] + [r.transpose(0, 1) for r in
                                     routes[L + l::L]], dim=1)
            for l in range(L)]
    T = prog[0].shape[1]
    ref = [r[:, :T] for r in ref]
    if any(p.shape != r.shape for p, r in zip(prog, ref)):
        return None
    differ = torch.stack([
        (p.sort(-1).values != r.to(p.device).sort(-1).values).any(-1)
        for p, r in zip(prog, ref)])                       # [L, B, T]
    return {"route_mismatch": float(differ.double().mean()),
            "tokens": float(differ.any(0).double().mean()),
            "prefill": float(differ[..., :prompt_len].double().mean()),
            "decode": float(differ[..., prompt_len:].double().mean()),
            "layers": [round(float(d), 4) for d in
                       differ.double().mean(dim=(1, 2))]}


def exponent_flips(prog: list, ref: list | None):
    """The program's activation exponents against the reference's over
    the same tokens: `prog` the profiled stretch's, one a quantized input
    in call order (the prefill's inputs, then each decode step's), `ref`
    the reference's, one [groups] vector an input (group 0 the prompts,
    group s decode step s), of which the stretch's steps are compared.
    Returns {"exponent_flips": the share of (input, step) exponents that
    differ, "inputs": how many were compared, "most": the largest
    difference}, or None where the counts do not match."""
    import torch
    n = len(ref or ())
    if not n or not prog or len(prog) % n \
            or len(prog) // n > ref[0].numel():
        return None
    steps = len(prog) // n
    p = torch.stack(prog).float().view(steps, n).t()
    r = torch.stack([e[:steps].float() for e in ref]).to(p.device)
    d = (p - r).abs()
    return {"exponent_flips": float((d > 0).double().mean()),
            "inputs": int(d.numel()), "most": float(d.max())}


def _profiled_wave(runner, traffic, rows):
    """The prefill and `PROFILED_STEPS` decode steps of one more wave of
    `rows` under `torch.profiler`, its spans as ranges, reduced to a
    `Profile` (its wall: the stretch's host clock).  Returns (the
    profile, the stretch's tokens, [B, gen] of which the first
    PROFILED_STEPS + 1 columns are served)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    runner.spans = Spans(ranges=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tokens, _ = runner.wave(rows, steps=PROFILED_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        return Profile.load(path, wall_s=wall,
                            waves=[(traffic.batch, traffic.batch)]), tokens

