"""Stand-ins for the LM timed path that the comparison has to fail, each
for the duration of a `with` block; `lm_control.py` and the tests drive
whole runs under them.  The benchmark's runs never do.

  * `control()`: the plain reference one step of precision lower (its
    activations int4) in the program's place: its logits at every
    position of the same prompts and served tokens, and the token it puts
    first there.
  * `fault(kind)`, the serving path broken underneath (`LM.decode_step`,
    or the MoE's expert product): "alter", an answer altered where it is
    produced (the first row's logits shifted by one id at every decode
    step, so each of its tokens is the neighbour of the program's best);
    "stale", a step that returns its state unchanged (every
    decode step's K/V write undone); "half", half of the batch left out
    (the second half of the rows answered with the first half's logits
    at every decode step); "kv_zero", one decode step's K/V slot zeroed
    in every layer after the step; "expert_drop", one expert's output
    dropped for one token (the first row's first-choice expert, in the
    last MoE layer, at one decode step a wave: its slot found from that
    call's routing, so it always holds the token).
"""
from __future__ import annotations

import contextlib

import torch

from portbench import lm_harness, lm_reference

KINDS = ("alter", "stale", "half", "kv_zero", "expert_drop")
CAUGHT = ("alter", "stale", "half")   # the faults `lm_judge` has to fail
AT_STEP = 5           # the decode step (of each wave) a one-step fault hits


@contextlib.contextmanager
def control(act_bits: int = 4):
    real = lm_harness.judge_wave

    def judge_wave(cfg, seed, device, prompts, tokens, logits, unanswered,
                   served=None):
        seq = torch.cat([prompts.cpu(), tokens[:, :-1]], dim=1)
        ref = lm_reference.Reference(cfg, seed, device, act_bits=act_bits)
        low, _ = ref.logits(seq.to(device), prompts.shape[1])
        del ref
        return real(cfg, seed, device, prompts, tokens,
                    low.transpose(0, 1), unanswered,
                    served=low.argmax(-1).cpu())

    lm_harness.judge_wave = judge_wave
    try:
        yield
    finally:
        lm_harness.judge_wave = real


def _slots(caches, pos):
    for cyc in caches:
        for c in cyc:
            if "k" in c:
                yield c, pos % c["k"].shape[1]


@contextlib.contextmanager
def fault(kind: str):
    if kind not in KINDS:
        raise ValueError(f"fault {kind!r}; have {KINDS}")
    from repro_torch.models import moe
    from repro_torch.models.transformer import LM
    real_step, real_mm, real_route = LM.decode_step, moe._expert_mm, \
        moe.route
    state = {"first_pos": None, "at_step": False, "moe_calls": 0}

    def step_of(pos):
        if state["first_pos"] is None or pos < state["first_pos"]:
            state["first_pos"] = pos
        return pos - state["first_pos"]

    def decode_step(self, params, caches, token, pos):
        i = step_of(pos)
        kept = [(c, s, c["k"][:, s].clone(), c["v"][:, s].clone())
                for c, s in _slots(caches, pos)] if kind == "stale" else ()
        state["at_step"], state["moe_calls"] = i == AT_STEP, 0
        logits, caches = real_step(self, params, caches, token, pos)
        state["at_step"] = False
        if kind == "alter":
            logits = logits.clone()
            logits[0] = torch.roll(logits[0], 1)
        elif kind == "half":
            logits = logits.clone()
            h = logits.shape[0] // 2
            logits[-h:] = logits[:h]
        elif kind == "kv_zero" and i == AT_STEP:
            for c, s in _slots(caches, pos):
                c["k"][:, s] = 0
                c["v"][:, s] = 0
        for c, s, k, v in kept:
            c["k"][:, s] = k
            c["v"][:, s] = v
        return logits, caches

    def route(params, xg, cfg):
        state["route"] = real_route(params, xg, cfg)
        return state["route"]

    def expert_mm(spec, x, w, n=None):
        y = real_mm(spec, x, w, n)
        if spec == "gecf,efd->gecd" and state["at_step"]:
            if state["moe_calls"] == state["layers"] - 1:
                r = state["route"]
                assert bool(r.keep[0, 0]), "the first row's route was dropped"
                y = y.clone()
                y.view(-1, y.shape[-1])[r.slot[0, 0]] = 0
            state["moe_calls"] += 1
        return y

    LM.decode_step = decode_step
    if kind == "expert_drop":
        moe._expert_mm, moe.route = expert_mm, route
    real_run = lm_harness.run_cell

    def run_cell(cell, *a, **kw):
        cfg = cell.config
        state["layers"] = sum(f == "moe" for _, f in cfg["blocks"]) \
            * (cfg["num_layers"] // len(cfg["blocks"]))
        return real_run(cell, *a, **kw)

    lm_harness.run_cell = run_cell
    try:
        yield
    finally:
        LM.decode_step, moe._expert_mm, moe.route = real_step, real_mm, \
            real_route
        lm_harness.run_cell = real_run
