"""Search strategies: deterministic walks over the candidate space (the
port of the reference's `repro.search.strategies`).

A strategy's ONLY job is to decide which specs to evaluate; every
verdict comes from the `Objective` (which caches by spec identity, so
revisits are free — `budget` counts unique evaluations).  The frontier
is computed afterwards over *everything* the strategy evaluated, so a
strategy does not need to track non-dominated sets itself — it just has
to explore well.

Both strategies are bit-reproducible: `coordinate` draws nothing from
the rng at all, and `random` consumes it in a fixed call order, so the
same seed always yields the same evaluation sequence (and therefore the
same frontier doc — the reproducibility pin in
tests/test_torch_search_run.py).

Adding a strategy = one function `(space, objective, budget, rng,
acc_tol) -> None` registered in `STRATEGIES` (see search/README.md).
"""
from __future__ import annotations

from repro_torch.search.objective import Objective
from repro_torch.search.space import (MAX_REDUCTION, CandidateSpec,
                                      SearchSpace)


def _acceptable(cand, base_acc: float, acc_tol: float) -> bool:
    return cand.ok and base_acc - cand.metrics["acc"] <= acc_tol


def coordinate(space: SearchSpace, objective: Objective, budget: int,
               rng, acc_tol: float = 0.005) -> None:
    """Q-CapsNets-style greedy coordinate descent: walk the axes in
    their deterministic order; on each frac axis push the reduction
    deeper (-1, -2, -3) while the candidate stays verified and within
    `acc_tol` of the baseline accuracy; try each non-default operator
    variant and keep it only when it is strictly cheaper (est m7
    latency) at acceptable accuracy; flip the per-channel flags and
    keep them only when accuracy strictly improves.  Draws nothing from
    `rng` — the walk is fully determined by the space."""
    best = objective.evaluate(CandidateSpec())
    base_acc = best.metrics.get("acc", 0.0)

    def exhausted() -> bool:
        return objective.evaluations >= budget

    for kind, name in space.axes():
        if exhausted():
            return
        if kind in ("w_frac", "out_frac"):
            field = f"{kind}_deltas"
            for delta in range(-1, -MAX_REDUCTION - 1, -1):
                if exhausted():
                    return
                cand = objective.evaluate(
                    best.spec.with_delta(field, name, delta))
                if not _acceptable(cand, base_acc, acc_tol):
                    break               # deeper cuts only get worse
                best = cand
        elif kind == "variant":
            for vname in space.variant_names(name):
                if exhausted():
                    return
                trial = best.spec.with_variant(name, vname)
                if trial.key == best.spec.key:
                    continue
                cand = objective.evaluate(trial)
                if _acceptable(cand, base_acc, acc_tol) and \
                        cand.metrics["est_ms_m7"] < \
                        best.metrics["est_ms_m7"]:
                    best = cand
        elif kind == "flag":
            if exhausted():
                return
            cand = objective.evaluate(
                best.spec.with_flag(name, not getattr(best.spec, name)))
            if cand.ok and cand.metrics["acc"] > best.metrics["acc"]:
                best = cand


def random_search(space: SearchSpace, objective: Objective, budget: int,
                  rng, acc_tol: float = 0.005) -> None:
    """Seeded random/evolutionary baseline: mutate one axis of a parent
    drawn from the acceptable pool (falling back to the default spec)
    until the budget is spent.  All randomness flows through `rng` in a
    fixed call order, so identical seeds replay identically."""
    base = objective.evaluate(CandidateSpec())
    base_acc = base.metrics.get("acc", 0.0)
    pool = [base]
    axes = space.axes()
    attempts = 0
    while objective.evaluations < budget and attempts < budget * 20:
        attempts += 1
        parent = pool[int(rng.integers(len(pool)))].spec
        kind, name = axes[int(rng.integers(len(axes)))]
        if kind in ("w_frac", "out_frac"):
            delta = -int(rng.integers(0, MAX_REDUCTION + 1))
            spec = parent.with_delta(f"{kind}_deltas", name, delta)
        elif kind == "variant":
            names = space.variant_names(name)
            spec = parent.with_variant(
                name, names[int(rng.integers(len(names)))])
        else:
            spec = parent.with_flag(name, bool(rng.integers(2)))
        if spec.key == parent.key:
            continue
        cand = objective.evaluate(spec)
        if _acceptable(cand, base_acc, acc_tol):
            pool.append(cand)


STRATEGIES = {
    "coordinate": coordinate,
    "random": random_search,
}
