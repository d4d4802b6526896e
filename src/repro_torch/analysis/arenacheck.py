"""Independent verification of an ArenaPlan against its program.

`edge.arena.plan_arena` is the producer; this module re-derives tensor
liveness straight from the op schedule (its own walk, not
`arena.lifetimes`) and proves the plan's offsets are safe:

  * no two tensors whose live ranges intersect overlap in
    [offset, offset + size);
  * tid 0 (the caller's input buffer) is never given an arena slot,
    and every other tensor has exactly one;
  * every placement fits inside `arena_bytes`;
  * the shared scratch region covers the worst op's transient needs
    (im2col double buffer / resident u_hat — formulas restated here,
    not imported) and its byte count is 2-byte aligned, since the
    emitted C declares it as a q15 array.

A clean result is a proof about the PLAN, independent of the greedy
placement heuristic that produced it — a future planner swap is
covered by construction.
"""
from __future__ import annotations

from repro_torch.analysis.diagnostics import Diagnostic


def derive_lifetimes(program) -> dict:
    """tid -> (first_step, last_step), re-derived from the schedule: a
    tensor is live from the step defining it (step 0 for the program
    input) through its last consumer; the final output outlives the
    schedule (the caller reads it)."""
    life = {0: [0, 0]}
    for i, op in enumerate(program.ops):
        life[op.output] = [i, i]
        for tid in op.inputs:
            life[tid][1] = max(life[tid][1], i)
    life[program.ops[-1].output][1] = len(program.ops)
    return {tid: tuple(v) for tid, v in life.items()}


def _scratch_needed(op) -> int:
    """Worst-case transient bytes of one kernel call — the same model
    the C runtime's shared scratch must satisfy, restated independently
    of edge.arena: conv/primary-caps use a q15 im2col double buffer
    (2 * 2 * k * k * in_ch); routing keeps u_hat resident (J*I*O int8)
    plus logit/coupling planes (2 * J*I) and the pre-squash s (J*O)."""
    a = op.attrs
    if op.kind in ("CONV_Q7", "PRIMARY_CAPS_Q7"):
        return 2 * 2 * a["kernel"] * a["kernel"] * a["in_ch"]
    if op.kind == "CAPS_ROUTING_Q7":
        j, i, o = a["num_out"], a["num_in"], a["out_dim"]
        return j * i * o + 2 * j * i + j * o
    return 0


def check_arena(program, plan) -> list:
    """All aliasing/coverage diagnostics for one (program, ArenaPlan)
    pair.  `plan` needs `offsets`, `lifetimes`, `arena_bytes` and
    `scratch_bytes` — the edge.arena.ArenaPlan shape."""
    diags: list = []
    life = derive_lifetimes(program)
    sizes = {tid: program.tensor(tid).nbytes for tid in life}

    if plan.lifetimes != life:
        diags.append(Diagnostic.of(
            "arena.lifetime-mismatch",
            f"plan lifetimes {plan.lifetimes} != liveness re-derived "
            f"from the schedule {life}"))
    if 0 in plan.offsets:
        diags.append(Diagnostic.of(
            "arena.input-allocated",
            "tid 0 is the caller's input buffer and must never get an "
            "arena offset", tensor=0))
    for tid in sorted(life):
        if tid != 0 and tid not in plan.offsets:
            diags.append(Diagnostic.of(
                "arena.missing-offset",
                "live tensor has no arena placement", tensor=tid))

    placed = sorted((tid, off) for tid, off in plan.offsets.items()
                    if tid in life and tid != 0)
    for tid, off in placed:
        if off < 0 or off + sizes[tid] > plan.arena_bytes:
            diags.append(Diagnostic.of(
                "arena.out-of-bounds",
                f"placement [{off}, {off + sizes[tid]}) outside the "
                f"{plan.arena_bytes}-byte arena", tensor=tid,
                offset=off, size=sizes[tid]))
    for i, (ta, off_a) in enumerate(placed):
        for tb, off_b in placed[i + 1:]:
            (sa, ea), (sb, eb) = life[ta], life[tb]
            if ea < sb or eb < sa:                  # never live together
                continue
            if off_a + sizes[ta] <= off_b or off_b + sizes[tb] <= off_a:
                continue                            # disjoint placements
            diags.append(Diagnostic.of(
                "arena.overlap",
                f"tensors {ta} and {tb} are live together (steps "
                f"{max(sa, sb)}..{min(ea, eb)}) but overlap in the "
                f"arena ([{off_a}, {off_a + sizes[ta]}) vs "
                f"[{off_b}, {off_b + sizes[tb]}))",
                tensor=ta, other=tb))

    need = max((_scratch_needed(op) for op in program.ops), default=0)
    if plan.scratch_bytes < need:
        worst = max(range(len(program.ops)),
                    key=lambda i: _scratch_needed(program.ops[i]))
        diags.append(Diagnostic.of(
            "arena.scratch-undersized",
            f"shared scratch {plan.scratch_bytes}B < the worst op's "
            f"{need}B transient need", op_index=worst,
            op_name=program.ops[worst].name, needed=need,
            scratch=plan.scratch_bytes))
    if plan.scratch_bytes % 2:
        diags.append(Diagnostic.of(
            "arena.scratch-unaligned",
            f"scratch region is {plan.scratch_bytes}B — must be 2-byte "
            f"aligned (the C artifact declares it as a q15 array)",
            scratch=plan.scratch_bytes))
    return diags
