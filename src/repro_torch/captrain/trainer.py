"""CapsTrainer: float and fake-quant (QAT) training of `CapsPipeline`s.

One trainer owns the typed pipeline, the reconstruction-decoder
regularizer, a `repro_torch.optim.AdamW`, the train step
(`captrain.steps`) and checkpoint/resume through `repro_torch.ckpt`.

QAT adds no second quantization path: the plan a QAT step trains
against comes from `CapsPipeline.calibrate` + `.plan`, the machinery PTQ
uses (Alg. 6/7), re-derived every `recalib_every` steps from the current
weights; the finished model goes through the ordinary
`pipeline.quantize`, so it lowers with `repro_torch.edge.lower` and
serves through `serving.ModelRegistry` as any PTQ model does.

Under a `mesh` over a `torch.distributed` world (`dist.world`), every
rank holds the whole replicated state on its own device and draws the
same batches; `train_step` and `fit` split each step's microbatches
over the BATCH lines (`captrain.steps`; the ranks of a model line
compute the same microbatches, as the reference replicates the step
over `model`), and the losses
and the state equal the one-rank run's bit for bit.  Calibration and
`derive_plan` run replicated; `save` writes from rank 0 alone, then
waits for every rank, and `resume_or_init` reads the same bits on every
rank.

Determinism:
  * batches are pure functions of the optimizer step index
    (`data.synthetic.ImageTask`), so restoring a checkpoint resumes the
    exact sample stream: same step counter => same loss, bit for bit;
  * the QAT plan is part of the checkpoint (a JSON side-car via
    `nn.plans.plan_to_json`), so a resume between recalibrations trains
    against the grids the original run did;
  * random state is explicit: the pipeline's params come from a
    `torch.Generator` seeded with `TrainConfig.seed`, the decoder's from
    a second one seeded with `seed + 1`, and calibration subsampling
    (when asked for) from the caller's `np.random.Generator`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import numpy as np
import torch

from repro_torch import ckpt, obs
from repro_torch.captrain.decoder import ReconDecoder
from repro_torch.captrain.steps import make_train_step
from repro_torch.data.synthetic import ImageTask
from repro_torch.device import resolve_device
from repro_torch.dist import api
from repro_torch.nn.config import CapsNetConfig
from repro_torch.nn.pipeline import CapsPipeline, QuantCapsNet
from repro_torch.nn.plans import PipelinePlan, plan_from_json, plan_to_json
from repro_torch.nn.variants import VariantSet
from repro_torch.optim.adam import AdamW


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Everything about HOW to train (the CapsNetConfig says WHAT)."""
    dataset: str = "mnist"          # data.synthetic kind
    batch: int = 64
    microbatches: int = 8           # gradient-tree leaves (power of two)
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: float = 0.0
    recon_weight: float = 0.0005    # paper's decoder regularizer scale
    decoder_hidden: tuple = (64, 128)
    rounding: str = "floor"         # QAT trains against this rounding
    recalib_every: int = 50         # re-derive the QAT plan every N steps
    calib_n: int = 64
    calib_seed: int = 555_555
    per_channel: bool = False
    softmax_impl: str | None = None  # operator-variant references
    squash_impl: str | None = None   # (None -> registry defaults)
    seed: int = 0
    ckpt_every: int = 0             # 0 = checkpointing off
    ckpt_dir: str | None = None
    ckpt_keep: int = 3


class CapsTrainer:
    def __init__(self, cfg: CapsNetConfig, tcfg: TrainConfig = TrainConfig(),
                 mesh=None, metrics=None, rng=None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        # under a mesh over a world, the state lives on this rank's device
        self.device = resolve_device(api.rank_device(mesh, device))
        # optional explicit calibration rng (np.random.Generator): when
        # set, every calibration subsamples its calib_n images from a 4x
        # pool through it, so a caller that seeds it owns the complete
        # random state; None keeps the fixed calibration set
        self.rng = rng
        # the run's metrics registry: the QAT clipping-rate series land
        # here (pass a serving/run registry to fold them into its snapshot)
        self.metrics = metrics if metrics is not None \
            else obs.MetricsRegistry("captrain")
        variants = VariantSet(**{k: v for k, v in (
            ("softmax", tcfg.softmax_impl), ("squash", tcfg.squash_impl))
            if v is not None})
        self.pipeline = CapsPipeline.from_config(
            cfg, variants=variants, per_channel=tcfg.per_channel)
        self.decoder = ReconDecoder(
            cfg.num_classes, cfg.caps_dim, tuple(cfg.input_shape),
            hidden=tuple(tcfg.decoder_hidden)) \
            if tcfg.recon_weight > 0 else None
        self.opt = AdamW(lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                         clip_norm=tcfg.clip_norm)
        self.task = ImageTask(tcfg.dataset, seed=tcfg.seed)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self) -> dict:
        seed = self.tcfg.seed
        params = {
            "caps": self.pipeline.init(torch.Generator().manual_seed(seed),
                                       device=self.device),
            "dec": self.decoder.init(
                torch.Generator().manual_seed(seed + 1), device=self.device)
            if self.decoder else {}}
        return {"params": params, "opt": self.opt.init(params)}

    @staticmethod
    def step_index(state) -> int:
        return int(state["opt"]["step"])

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------
    def train_step(self, state, x, y, plan: PipelinePlan | None = None):
        """One optimizer step on a batch (NumPy arrays or tensors), split
        over the trainer's mesh if it has one."""
        step = make_train_step(
            self.pipeline, self.decoder, self.opt,
            num_classes=self.cfg.num_classes,
            microbatches=self.tcfg.microbatches,
            recon_weight=self.tcfg.recon_weight, plan=plan,
            rounding=self.tcfg.rounding, mesh=self.mesh)
        return step(state, self._on_device(x, torch.float32),
                    self._on_device(y, torch.int64))

    def _on_device(self, a, dtype):
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------------
    # QAT plan derivation: the PTQ machinery, reused as it is
    # ------------------------------------------------------------------
    def calib_images(self):
        """The fixed calibration set, disjoint from the train stream (its
        own seed), on the trainer's device.  With an explicit trainer
        rng, each call draws calib_n images from a 4x pool through it
        instead (order-stable via sorted indices)."""
        tc = self.tcfg
        n = tc.calib_n if self.rng is None else 4 * tc.calib_n
        imgs, _ = ImageTask(tc.dataset, seed=tc.calib_seed).batch(0, n)
        if self.rng is not None:
            idx = self.rng.choice(n, size=tc.calib_n, replace=False)
            imgs = imgs[np.sort(idx)]
        return torch.as_tensor(imgs, device=self.device)

    def derive_plan(self, state) -> PipelinePlan:
        """calibrate + plan on the current weights: what
        `pipeline.quantize` would derive for them."""
        params = state["params"]["caps"]
        stats = self.pipeline.calibrate(params, self.calib_images())
        return self.pipeline.plan(params, stats)

    @torch.no_grad()
    def qat_clip_rates(self, state, plan: PipelinePlan,
                       batch: int = 16) -> dict:
        """Per-layer STE-clipped fraction of one fake-quant pass over the
        calibration set: how often the plan's Qm.n grids clamp what
        training produces."""
        from repro_torch.obs import numerics as health
        n = max(1, min(batch, self.tcfg.calib_n))
        probe = health.NumericsProbe()
        with health.probing(probe):
            self.pipeline.forward_fq(state["params"]["caps"],
                                     self.calib_images()[:n], plan,
                                     rounding=self.tcfg.rounding)
        return probe.fq_clip_rates()

    def _record_clip_rates(self, state, plan: PipelinePlan,
                           step: int) -> None:
        """One `qat.clip_rate` gauge point per layer into the run's
        metrics registry: the per-recalibration clipping-rate series."""
        gauge = self.metrics.gauge(
            "qat.clip_rate",
            help="STE-clipped activation fraction per layer at each "
            "QAT plan recalibration")
        for layer, rate in sorted(self.qat_clip_rates(state, plan).items()):
            gauge.set(rate, layer=layer, step=str(step))

    def quantize(self, state, *, rounding: str | None = None,
                 backend: str = "torch") -> QuantCapsNet:
        """Trained params -> int8 model via the ordinary PTQ entry point
        (the calibration set the QAT plans were derived from)."""
        return self.pipeline.quantize(
            state["params"]["caps"], self.calib_images(),
            rounding=rounding or self.tcfg.rounding, backend=backend)

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------
    def save(self, state, plan: PipelinePlan | None = None) -> str:
        """Write the checkpoint (rank 0 alone under a mesh over a world,
        the others waiting for it) and return its path."""
        if not self.tcfg.ckpt_dir:
            raise ValueError("TrainConfig.ckpt_dir is not set")
        if api.world_rank(self.mesh) == 0:
            path = self._save(state, plan)
        else:
            path = str(pathlib.Path(self.tcfg.ckpt_dir)
                       / f"step_{self.step_index(state):08d}.npz")
        api.barrier(self.mesh)
        return path

    def _save(self, state, plan: PipelinePlan | None) -> str:
        step = self.step_index(state)
        d = pathlib.Path(self.tcfg.ckpt_dir)
        d.mkdir(parents=True, exist_ok=True)
        # the plan side-car lands (atomically) BEFORE ckpt.save publishes
        # LATEST: a crash in between leaves an unreferenced side-car,
        # never a resumable QAT snapshot without its grids
        side = d / f"plan_{step:08d}.json"
        if plan is not None:
            tmp = side.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(plan_to_json(plan), sort_keys=True))
            os.replace(tmp, side)
        elif side.exists():
            side.unlink()
        path = ckpt.save(self.tcfg.ckpt_dir, step, state)
        ckpt.gc_keep_n(self.tcfg.ckpt_dir, keep=self.tcfg.ckpt_keep)
        for orphan in d.glob("plan_*.json"):     # side-cars of GC'd snaps
            if not (d / f"step_{orphan.stem[5:]}.npz").exists():
                orphan.unlink(missing_ok=True)
        return path

    def resume_or_init(self):
        """(state, plan) from the newest checkpoint, or a fresh init."""
        example = self.init_state()
        if not self.tcfg.ckpt_dir:
            return example, None
        step, restored = ckpt.restore_latest(self.tcfg.ckpt_dir, example)
        if step is None:
            return example, None
        side = pathlib.Path(self.tcfg.ckpt_dir) / f"plan_{step:08d}.json"
        plan = plan_from_json(json.loads(side.read_text())) \
            if side.exists() else None
        return restored, plan

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------
    def fit(self, state, num_steps: int, *, qat: bool = False,
            plan: PipelinePlan | None = None, log_every: int = 0,
            log=print):
        """Run `num_steps` optimizer steps from wherever `state` is.

        qat=False trains the float pipeline (plan ignored).  qat=True
        trains fake-quant: the plan is (re)derived from the live weights
        whenever the step counter crosses a `recalib_every` boundary, and
        on entry when no plan was carried in.  Returns (state, plan,
        history) with history rows {"step", "loss", "accuracy",
        "grad_norm"}.
        """
        tc = self.tcfg
        history = []
        for _ in range(num_steps):
            i = self.step_index(state)           # batch index == step
            if qat and (plan is None or
                        (tc.recalib_every > 0 and i > 0
                         and i % tc.recalib_every == 0)):
                with obs.span("train.recalibrate", step=i):
                    plan = self.derive_plan(state)
                    self._record_clip_rates(state, plan, i)
            x, y = self.task.batch(i, tc.batch)
            with obs.span("train.step", step=i, qat=qat):
                state, metrics = self.train_step(state, x, y,
                                                 plan if qat else None)
            row = {"step": int(metrics["step"]),
                   "loss": float(metrics["loss"]),
                   "accuracy": float(metrics["accuracy"]),
                   "grad_norm": float(metrics["grad_norm"])}
            history.append(row)
            done = self.step_index(state)
            if log_every and (done % log_every == 0 or done == 1):
                log(f"  step {row['step']:5d}: loss={row['loss']:.4f} "
                    f"acc={row['accuracy']:.3f}"
                    + (" [qat]" if qat else ""))
            if tc.ckpt_every and tc.ckpt_dir and done % tc.ckpt_every == 0:
                with obs.span("train.ckpt", step=done):
                    self.save(state, plan if qat else None)
        return state, plan, history
