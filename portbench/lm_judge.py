"""The comparison that decides `correct` for a language-model cell: one
wave's served tokens and logits (bf16, as the program returned them)
against the plain reference's float32 logits at the same positions, over
the same prompts and tokens (the prompt's last position and every
generated one but the last, all rows).

The gap of a served token is the reference's best logit at its position
less the reference's logit of that token (0 where the program served the
reference's best; greedy tokens).

  * `served_gap_row_max`: the largest, over the wave's requests, of the
    mean gap of a request's served tokens: an answer altered where it is
    produced, or answered from another request's logits, lifts its row.
  * `served_miss_late`: the share of the last quarter of every request's
    generated tokens served more than `MISS_GAP` logits below the
    reference's best: where a decode step that loses its state has lost
    the most.
  * `logit_err_median`: the median over the positions of the logits'
    relative error, ||program - reference|| / ||reference|| over the
    vocabulary: the numerics of the whole forward.
  * `unanswered`: waves started and never completed.

Each is held to its limit (value <= limit).  Neither the widest gap nor
the widest logit error is compared: the int4 control reads them at
under three times what sound runs read, so no limit separates the two
(`PERF.md` gives the readings each limit was set from, and these).
"""
from __future__ import annotations

import torch

LIMITS = {
    "served_gap_row_max": 1.2,
    "served_miss_late": 0.32,
    "logit_err_median": 0.75,
    "unanswered": 0,
}
LATE = 4          # the last 1/LATE of the generated tokens
MISS_GAP = 1.0    # logits below the reference's best


@torch.no_grad()
def compare(logits, served, ref_logits, notes: dict, unanswered: int):
    """logits [G, B, V] (the program's, any float type), served int64 [B,
    G], ref_logits float32 [B, G, V].  Returns ({name: (value, limit)},
    notes with `compared` and the per-position readings)."""
    dev = ref_logits.device
    prog = logits.to(dev).float().transpose(0, 1)           # [B, G, V]
    served = torch.as_tensor(served, device=dev)
    top2 = ref_logits.topk(2, dim=-1).values
    gap = top2[..., 0] - ref_logits.gather(-1, served[..., None])[..., 0]
    err = (prog - ref_logits).norm(dim=-1) / ref_logits.norm(dim=-1)
    del prog
    G = ref_logits.shape[1]
    late = gap[:, G - max(1, G // LATE):]
    values = {
        "served_gap_row_max": float(gap.double().mean(dim=1).max()),
        "served_miss_late": float((late > MISS_GAP).double().mean()),
        "logit_err_median": float(err.double().median()),
        "unanswered": int(unanswered),
    }
    margin = notes.get("route_margin")
    out = {"compared": int(gap.numel()), "gap": gap.cpu(), "err": err.cpu(),
           "ref_margin": (top2[..., 0] - top2[..., 1]).cpu(),
           "margin": None if margin is None else margin[:, -G:].cpu(),
           "routes": notes.get("routes"),
           "act_exponents": notes.get("act_exponents")}
    return {k: (values[k], LIMITS[k]) for k in LIMITS}, out


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
