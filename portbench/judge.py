"""The comparison that decides `correct`: every kept completion's answers
(v_q, lengths, pred) against the plain reference's answers for the same
pool image, and every request answered.

Each number is held to its limit (a run passes where value <= limit for
all of them).  The int8 graph is exact, so v_q and pred are compared
exactly, and so are the lengths, which both sides compute from the same
integers in float32 (PERF.md gives the readings these limits were set
from).
"""
from __future__ import annotations

import numpy as np

LIMITS = {
    "vq_mismatch": 0,             # v_q elements that differ
    "pred_mismatch": 0,           # predicted classes that differ
    "lengths_max_abs_err": 0.0,   # largest |lengths - reference|
    "unanswered": 0,              # requests never completed
}


def compare(completions, pool_index, answers, unanswered: int) -> dict:
    """`completions`: objects with rid, v_q, lengths, pred; `pool_index`:
    rid -> the pool image it carried; `answers`: pool image -> (v_q,
    lengths, pred) of the reference.  Returns {name: (value, limit)}."""
    if not completions:
        raise ValueError("no completion to compare")
    idx = np.array([pool_index(c.rid) for c in completions])
    v = np.stack([np.asarray(c.v_q) for c in completions])
    ln = np.stack([np.asarray(c.lengths) for c in completions])
    pred = np.array([int(c.pred) for c in completions])
    rv, rl, rp = answers(idx)
    values = {
        "vq_mismatch": int((v != rv).sum()),
        "pred_mismatch": int((pred != rp).sum()),
        "lengths_max_abs_err": float(np.abs(ln.astype(np.float64)
                                            - rl.astype(np.float64)).max()),
        "unanswered": int(unanswered),
    }
    return {k: (values[k], LIMITS[k]) for k in LIMITS}


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
