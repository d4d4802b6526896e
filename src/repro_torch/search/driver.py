"""End-to-end search runs: config -> trained net -> frontier doc (the
port of the reference's `repro.search.driver`).

`run_search` owns the determinism contract.  ONE `np.random.Generator`
seeded from `SearchConfig.seed` is threaded through everything that
draws randomness — the trainer's calibration subsampling (the
`CapsTrainer(rng=...)` contract) and the search strategy — in a fixed
call order, so two runs with the same config on the same device produce
byte-identical `repro.search/v1` docs, and `frontier.rebuild_point` can
replay the setup to re-derive any frontier point bit-for-bit.

The device is not part of the config (a doc's `config` block is the
reference's): `setup_space`, `run_search` and `rebuild_point` take
`device=` and resolve it with `repro_torch.device.resolve_device` (the
card, or a RuntimeError without one unless `device="cpu"`).  Training,
calibration and `eval_q7` run there; the numerics probe and the export
re-verify run the EdgeVM on the host.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch import obs
from repro_torch.captrain.evalq import eval_float, eval_q7
from repro_torch.captrain.trainer import CapsTrainer, TrainConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.nn.plans import plan_to_json
from repro_torch.search import frontier as F
from repro_torch.search.objective import SAT_THRESHOLD, Objective
from repro_torch.search.space import CandidateSpec, SearchSpace
from repro_torch.search.strategies import STRATEGIES


def model_config(name: str):
    """Resolve a search model name ("edge_tiny" or a dataset with a
    capsnet_<dataset> config) to its CapsNetConfig."""
    from repro_torch.nn.config import CAPSNET_CONFIGS, EDGE_TINY
    if name == "edge_tiny":
        return EDGE_TINY
    others = {k: c for k, c in CAPSNET_CONFIGS.items() if c is not EDGE_TINY}
    try:
        return others[f"capsnet_{name}"]
    except KeyError:
        raise ValueError(
            f"unknown search model {name!r}; have edge_tiny, "
            f"{', '.join(k[len('capsnet_'):] for k in others)}")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """One search run, fully specified (the doc's `config` block —
    `rebuild_point` reconstructs everything from it + the seed)."""
    model: str = "edge_tiny"
    strategy: str = "coordinate"
    budget: int = 24                # unique candidate evaluations
    seed: int = 0
    float_steps: int = 60
    qat_steps: int = 0              # >0: QAT-refine accuracy per candidate
    eval_n: int = 256
    eval_seed: int = 999_999
    rounding: str = "floor"
    sat_threshold: float = SAT_THRESHOLD
    acc_tol: float = 0.005          # paper band: <=0.5 % accuracy loss
    calib_n: int = 64
    batch: int = 64
    numerics_n: int = 64
    verify_n: int = 8               # frontier-point bit-verify images

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; have "
                             f"{sorted(STRATEGIES)}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "SearchConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class SearchSetup:
    """The deterministic state a run (or a point rebuild) derives from a
    SearchConfig: trained float net + space + eval data + the rng, left
    exactly where the strategy should start consuming it."""
    cfg: SearchConfig
    model_cfg: object
    trainer: CapsTrainer
    state: dict
    space: SearchSpace
    images: np.ndarray
    labels: np.ndarray
    rng: np.random.Generator
    float_acc: float


def setup_space(cfg: SearchConfig, *, log=None, device=None) -> SearchSetup:
    """Seed -> trained float net -> SearchSpace, on `device`.  The rng
    draw order is fixed: the float fit draws nothing, then
    `calib_images()` draws once — so the returned rng's state is a pure
    function of the config, whatever the strategy does with it
    afterwards."""
    mc = model_config(cfg.model)
    device = resolve_device(device)
    tcfg = TrainConfig(dataset=cfg.model, batch=cfg.batch,
                       calib_n=cfg.calib_n, seed=cfg.seed,
                       rounding=cfg.rounding)
    rng = np.random.default_rng(cfg.seed)
    trainer = CapsTrainer(mc, tcfg, rng=rng, device=device)
    state = trainer.init_state()
    with obs.span("search.setup", model=cfg.model, steps=cfg.float_steps):
        state, _, _ = trainer.fit(state, cfg.float_steps,
                                  log_every=50 if log else 0,
                                  log=log or print)
        calib = trainer.calib_images()          # rng draw #1
    space = SearchSpace(mc, state["params"]["caps"], calib)
    images, labels = make_image_dataset(cfg.model, cfg.eval_n,
                                        seed=cfg.eval_seed)
    float_acc = eval_float(trainer.pipeline, state["params"]["caps"],
                           images, labels)
    return SearchSetup(cfg=cfg, model_cfg=mc, trainer=trainer, state=state,
                       space=space, images=images, labels=labels, rng=rng,
                       float_acc=float_acc)


def _qat_eval(st: SearchSetup):
    """Per-candidate QAT refinement: fork the float weights, fine-tune
    fake-quant against the candidate's FIXED plan (recalib off, so no
    rng draws), and re-score int8 accuracy on the same grid."""
    cfg = st.cfg

    def refine(spec: CandidateSpec) -> float:
        plan = st.space.build_plan(spec)
        rtc = dataclasses.replace(st.trainer.tcfg, recalib_every=0,
                                  ckpt_every=0)
        qtr = CapsTrainer(st.model_cfg, rtc, device=st.trainer.device)
        qstate, _, _ = qtr.fit(st.state, cfg.qat_steps, qat=True, plan=plan)
        qnet = st.space.build_qnet(spec, rounding=cfg.rounding,
                                   params=qstate["params"]["caps"])
        return eval_q7(qnet, st.images, st.labels)

    return refine


def run_search(cfg: SearchConfig, *, log=None, device=None) -> dict:
    """Full pipeline: setup -> strategy -> Pareto frontier -> per-point
    export/check/bit-verify -> `repro.search/v1` doc."""
    say = log or (lambda *_: None)
    st = setup_space(cfg, log=log, device=device)
    say(f"[search] {cfg.model}: float acc {st.float_acc:.4f}, "
        f"strategy={cfg.strategy} budget={cfg.budget} seed={cfg.seed}")

    objective = Objective(
        st.space, st.images, st.labels, rounding=cfg.rounding,
        numerics_n=cfg.numerics_n, sat_threshold=cfg.sat_threshold,
        qat_eval=_qat_eval(st) if cfg.qat_steps > 0 else None)
    baseline = objective.evaluate(CandidateSpec())
    STRATEGIES[cfg.strategy](st.space, objective, cfg.budget, st.rng,
                             cfg.acc_tol)
    candidates = list(objective.cache.values())
    say(f"[search] evaluated {objective.evaluations} candidates "
        f"({sum(not c.ok for c in candidates)} rejected)")

    with obs.span("search.frontier", candidates=len(candidates)):
        front = F.pareto(candidates)
        verification = {}
        for i, c in enumerate(front):
            report = F.verify_point(st.space, c, rounding=cfg.rounding,
                                    verify_images=st.images[:cfg.verify_n])
            verification[i] = {
                "verified": bool(report.get("verified")),
                "checked": bool(report.get("checked")),
                "plan": plan_to_json(st.space.build_plan(c.spec)),
            }
    say(f"[search] frontier: {len(front)} verified points")

    doc = F.build_doc(cfg.to_json(), baseline, candidates, front,
                      verification=verification)
    doc["float_acc"] = st.float_acc
    return doc


def save_doc(doc: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
