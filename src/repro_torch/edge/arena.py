"""Static arena planner + the Table-2-style memory report (NumPy-free,
the port's copy of the reference's `repro.edge.arena`, same offsets).

MCU deployments have no allocator: every activation tensor gets a fixed
offset in ONE static buffer, assigned at export time from liveness.  The
planner is the standard greedy-by-size scheme (as used by TFLite-Micro's
arena planner): place tensors largest-first at the lowest offset that
does not overlap any already-placed tensor whose live range intersects.
Peak arena is therefore <= the naive sum of all activation sizes, and
usually close to the two largest concurrently-live tensors.

Per-op scratch (the CMSIS-NN `bufferA` im2col buffer, routing's resident
u_hat) is transient within one op, so it overlays a single shared
region sized by the worst op rather than joining the liveness problem.
"""
from __future__ import annotations

import dataclasses

from repro_torch.edge.program import EdgeProgram


@dataclasses.dataclass(frozen=True)
class ArenaPlan:
    offsets: dict                   # tensor id -> byte offset
    lifetimes: dict                 # tensor id -> (first_step, last_step)
    arena_bytes: int                # peak of the activation arena
    scratch_bytes: int              # shared transient region (worst op)
    naive_bytes: int                # sum of all activation sizes

    @property
    def ram_bytes(self) -> int:
        return self.arena_bytes + self.scratch_bytes


def lifetimes(program: EdgeProgram) -> dict:
    """Live range of each tensor in schedule steps: a tensor defined by
    op i is live [i, last consuming op]; the input is live from step 0;
    the final output survives past the last op (the caller reads it)."""
    n = len(program.ops)
    life = {0: [0, 0]}
    for i, op in enumerate(program.ops):
        life[op.output] = [i, i]
        for tid in op.inputs:
            life[tid][1] = max(life[tid][1], i)
    life[program.ops[-1].output][1] = n
    return {tid: tuple(v) for tid, v in life.items()}


def assign_offsets(blocks) -> dict:
    """Greedy-by-size offset assignment.

    blocks: iterable of (key, size_bytes, (start, end)) with inclusive
    live ranges.  Returns key -> offset such that blocks with
    intersecting ranges never overlap in [offset, offset+size)."""
    order = sorted(blocks, key=lambda b: (-b[1], b[0]))
    placed = []                     # (offset, size, start, end)
    offsets = {}
    for key, size, (start, end) in order:
        conflicts = sorted((off, sz) for off, sz, s, e in placed
                           if not (e < start or end < s))
        offset = 0
        for off, sz in conflicts:
            if offset + size <= off:
                break
            offset = max(offset, off + sz)
        offsets[key] = offset
        placed.append((offset, size, start, end))
    return offsets


def op_scratch_bytes(op) -> int:
    """Transient working memory of one kernel call, in bytes.

    conv / primary caps: the CMSIS-NN im2col `bufferA` — a double buffer
    of q15 columns, 2 * (k*k*in_ch) * sizeof(q15).  Routing: u_hat stays
    resident across iterations (J*I*O int8) plus the logit/coupling
    planes (2 * J*I) and the pre-squash capsule s (J*O)."""
    a = op.attrs
    if op.kind in ("CONV_Q7", "PRIMARY_CAPS_Q7"):
        return 2 * 2 * a["kernel"] * a["kernel"] * a["in_ch"]
    if op.kind == "CAPS_ROUTING_Q7":
        j, i, o = a["num_out"], a["num_in"], a["out_dim"]
        return j * i * o + 2 * j * i + j * o
    raise ValueError(op.kind)


def plan_arena(program: EdgeProgram) -> ArenaPlan:
    """The input tensor (tid 0) is the CALLER's buffer — the emitted C
    reads it through the `input` pointer — so it joins neither the
    arena nor the naive-allocator comparison."""
    life = lifetimes(program)
    sizes = {tid: program.tensor(tid).nbytes for tid in life}
    arena_tids = [tid for tid in sorted(life) if tid != 0]
    offsets = assign_offsets(
        [(tid, sizes[tid], life[tid]) for tid in arena_tids])
    peak = max(offsets[tid] + sizes[tid] for tid in offsets)
    scratch = max(op_scratch_bytes(op) for op in program.ops)
    scratch += scratch % 2          # q15 scratch region: keep 2-byte
    #                                 aligned (emit_c declares q15_t[])
    return ArenaPlan(offsets=offsets, lifetimes=life, arena_bytes=peak,
                     scratch_bytes=scratch,
                     naive_bytes=sum(sizes[t] for t in arena_tids))


# ---------------------------------------------------------------------------
# memory report (paper Table 2: flash = weights, RAM = activations)
# ---------------------------------------------------------------------------
def memory_report(program: EdgeProgram, plan: ArenaPlan | None = None,
                  profile=None) -> dict:
    """Per-layer flash/RAM breakdown; with `profile` (an MCU profile
    name or `costmodel.McuProfile`) every row additionally carries the
    static cycle/latency estimate for that part, and the report gains
    `est_total_{cycles,ms}` — the paper's Table-2 footprint and its
    latency tables in one view."""
    plan = plan or plan_arena(program)
    est = None
    if profile is not None:
        from repro_torch.edge import costmodel
        est = costmodel.estimate_program(program, profile)
    rows = []
    for i, op in enumerate(program.ops):
        out = program.tensor(op.output)
        rows.append({
            "name": op.name, "kind": op.kind,
            "weight_bytes": op.weight_bytes,
            "act_bytes": out.nbytes,
            "act_offset": plan.offsets[op.output],
            "scratch_bytes": op_scratch_bytes(op),
        })
        if est is not None:
            rows[-1]["est_cycles"] = est["rows"][i]["cycles"]
            rows[-1]["est_ms"] = est["rows"][i]["ms"]
    weight_elems = sum(int(w.size) for op in program.ops
                       for w in op.weights.values())
    arena_elems = plan.arena_bytes          # int8: 1 byte per element
    int8_total = program.flash_bytes + plan.arena_bytes
    fp32_total = 4 * weight_elems + 4 * arena_elems
    extra = {} if est is None else {
        "profile": est["profile"],
        "est_total_cycles": est["total_cycles"],
        "est_total_ms": est["total_ms"],
    }
    return {
        "name": program.name,
        "rows": rows,
        **extra,
        "input_bytes": program.input_tensor.nbytes,   # caller's buffer
        "flash_bytes": program.flash_bytes,
        "weight_bytes": program.weight_bytes,
        "arena_bytes": plan.arena_bytes,
        "scratch_bytes": plan.scratch_bytes,
        "ram_bytes": plan.ram_bytes,
        "naive_act_bytes": plan.naive_bytes,
        "fp32_total_bytes": fp32_total,
        "int8_total_bytes": int8_total,
        "saving_pct": 100.0 * (1.0 - int8_total / fp32_total),
    }


def format_report(report: dict) -> str:
    lines = [f"[{report['name']}] per-layer memory plan:"]
    for r in report["rows"]:
        lines.append(
            f"  {r['name']:<6} {r['kind']:<16} "
            f"flash={r['weight_bytes']:>8d}B  "
            f"act={r['act_bytes']:>7d}B@+{r['act_offset']:<7d} "
            f"scratch={r['scratch_bytes']}B"
            + (f"  est={r['est_ms']:.2f}ms" if "est_ms" in r else ""))
    lines.append(
        f"  flash {report['flash_bytes'] / 1000:.1f} KB "
        f"(weights {report['weight_bytes'] / 1000:.1f} KB + tables) | "
        f"RAM {report['ram_bytes'] / 1000:.1f} KB "
        f"(arena {report['arena_bytes']}B of naive "
        f"{report['naive_act_bytes']}B + scratch "
        f"{report['scratch_bytes']}B; caller input buffer "
        f"{report['input_bytes']}B)")
    lines.append(
        f"  total int8 {report['int8_total_bytes'] / 1000:.2f} KB vs fp32 "
        f"{report['fp32_total_bytes'] / 1000:.2f} KB -> "
        f"{report['saving_pct']:.1f}% smaller")
    if "est_total_ms" in report:
        lines.append(
            f"  est. latency on {report['profile']}: "
            f"{report['est_total_cycles']:,.0f} cycles = "
            f"{report['est_total_ms']:.2f} ms/inference")
    return "\n".join(lines)
