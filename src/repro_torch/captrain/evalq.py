"""Table-2 accuracy harness: train -> PTQ -> QAT -> float-vs-int8 delta.

The paper's headline claim is that Qm.n power-of-two quantization costs
only 0.07-0.18 % accuracy next to its 75 % memory cut (Table 2):

    rows = table2_rows(EDGE_TINY, TrainConfig(dataset="edge_tiny"),
                       float_steps=300, qat_steps=60)
    print(format_rows(rows))

For each rounding mode it reports float accuracy, int8 accuracy after
plain PTQ, int8 accuracy after QAT fine-tuning (same seed, same
calibration set), the two deltas, and the Table-2 footprint saving.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.captrain.losses import accuracy_count
from repro_torch.captrain.trainer import CapsTrainer, TrainConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.dist import api
from repro_torch.nn.config import CapsNetConfig
from repro_torch.nn.pipeline import CapsPipeline, QuantCapsNet
from repro_torch.nn.variants import VariantSet


def _params_device(params) -> torch.device:
    return next(iter(next(iter(params.values())).values())).device


@torch.no_grad()
def eval_float(pipeline: CapsPipeline, params, images, labels,
               batch: int = 256) -> float:
    """Float-pipeline top-1 accuracy (exact integer counting), on the
    params' device."""
    device = _params_device(params)
    correct, n = 0, images.shape[0]
    for i in range(0, n, batch):
        v = pipeline.forward(params, torch.as_tensor(
            images[i:i + batch], dtype=torch.float32, device=device))
        correct += int(accuracy_count(v, torch.as_tensor(
            labels[i:i + batch], device=device)))
    return correct / n


@torch.no_grad()
def eval_q7(qnet: QuantCapsNet, images, labels, batch: int = 256) -> float:
    """int8 top-1 accuracy (scored by the plan's class_lengths), on the
    model's device and backend."""
    correct, n = 0, images.shape[0]
    for i in range(0, n, batch):
        xq = qnet.quantize_input(torch.as_tensor(
            images[i:i + batch], dtype=torch.float32, device=qnet.device))
        lengths = qnet.class_lengths(qnet.forward(xq)).cpu().numpy()
        correct += int((lengths.argmax(-1) ==
                        np.asarray(labels[i:i + batch])).sum())
    return correct / n


@dataclasses.dataclass(frozen=True)
class Table2Row:
    """One (config, variants, rounding) line of the accuracy
    reproduction.  `variant` is the operator-variant tag the int8 model
    ran; `est_ms_m7` / `est_ms_gap8` are the static MCU latency
    estimates of the PTQ'd program (`edge.costmodel`); `sat_pct` /
    `snr_db` its numeric health from a probed pass (`obs.numerics`);
    `flash_bytes` / `ram_bytes` the lowered program's footprint
    (`edge.arena.memory_report`); `source` tags where the row came
    from."""
    name: str
    rounding: str
    acc_f32: float
    acc_ptq: float
    acc_qat: float
    saving_pct: float
    variant: str = VariantSet().tag
    est_ms_m7: float = float("nan")
    est_ms_gap8: float = float("nan")
    sat_pct: float = float("nan")
    snr_db: float = float("nan")
    flash_bytes: int = 0
    ram_bytes: int = 0
    source: str = "ptq"

    @property
    def delta_ptq(self) -> float:
        return self.acc_f32 - self.acc_ptq

    @property
    def delta_qat(self) -> float:
        return self.acc_f32 - self.acc_qat


def table2_rows(cfg: CapsNetConfig, tcfg: TrainConfig, *,
                float_steps: int, qat_steps: int,
                roundings=("floor", "nearest"), eval_n: int = 512,
                eval_seed: int = 999_999, mesh=None, log=None,
                variants: VariantSet | None = None,
                device=None) -> list:
    """Train once in float, then branch per rounding mode: PTQ the float
    weights directly, and QAT-fine-tune a copy before quantizing it
    (same seed, same calibration images, so the two deltas are
    comparable).  `variants` selects the int8 operator variants, which
    the plans carry and QAT trains against.  The int8 models run the
    `cuda` backend (the kernels) on the card and the `torch` oracle on
    the CPU, so the accuracies are the ones served.  Under a data-parallel
    `mesh` both trainers split their steps over its ranks (the rows are
    those of the one-rank run); the evaluations run replicated.
    Returns [Table2Row, ...]."""
    from repro_torch.edge import lower, total_latency_ms
    from repro_torch.edge.arena import memory_report
    from repro_torch.obs.numerics import run_numerics

    device = resolve_device(api.rank_device(mesh, device))
    backend = "cuda" if device.type == "cuda" else "torch"
    if variants is not None:
        tcfg = dataclasses.replace(tcfg, softmax_impl=variants.softmax,
                                   squash_impl=variants.squash)
    trainer = CapsTrainer(cfg, tcfg, mesh=mesh, device=device)
    caps = trainer.pipeline.layers[-1]
    vtag = VariantSet(softmax=caps.softmax_impl,
                      squash=caps.squash_impl).tag
    state, _ = trainer.resume_or_init()          # ckpt_dir -> resume
    remaining = max(0, float_steps - trainer.step_index(state))
    state, _, _ = trainer.fit(state, remaining,
                              log_every=50 if log else 0,
                              log=log or print)

    images, labels = make_image_dataset(tcfg.dataset, eval_n,
                                        seed=eval_seed)
    acc_f = eval_float(trainer.pipeline, state["params"]["caps"],
                       images, labels)

    rows = []
    for rounding in roundings:
        # QAT branches fork from the float weights; no checkpointing here
        # (they would clobber the float run's snapshots)
        rtc = dataclasses.replace(tcfg, rounding=rounding, ckpt_every=0)
        q_ptq = trainer.quantize(state, rounding=rounding, backend=backend)
        acc_ptq = eval_q7(q_ptq, images, labels)

        qtrainer = CapsTrainer(cfg, rtc, mesh=mesh, device=device)
        qstate, _, _ = qtrainer.fit(state, qat_steps, qat=True,
                                    log_every=25 if log else 0,
                                    log=log or print)
        q_qat = qtrainer.quantize(qstate, rounding=rounding,
                                  backend=backend)
        acc_qat = eval_q7(q_qat, images, labels)

        fp32 = trainer.pipeline.param_bytes(state["params"]["caps"])
        # the static MCU latency axis: the PTQ'd model lowered once and
        # priced on both calibrated profiles (QAT shares its geometry)
        program = lower(q_ptq)
        mem = memory_report(program)
        # the numeric-health axis: one probed VM pass of the PTQ model
        # with the trained float weights as the SNR oracle
        health = run_numerics(q_ptq, images[:min(64, eval_n)],
                              params=state["params"]["caps"],
                              program=program)
        rows.append(Table2Row(
            name=cfg.name, rounding=rounding, acc_f32=acc_f,
            acc_ptq=acc_ptq, acc_qat=acc_qat,
            saving_pct=100.0 * (1 - q_ptq.memory_bytes() / fp32),
            variant=vtag,
            est_ms_m7=total_latency_ms(program, "cortex-m7"),
            est_ms_gap8=total_latency_ms(program, "gap8"),
            sat_pct=100.0 * health.worst_saturation_rate(),
            snr_db=health.min_snr_db(),
            flash_bytes=int(mem["flash_bytes"]),
            ram_bytes=int(mem["ram_bytes"])))
    return rows


def format_rows(rows) -> str:
    """The Table-2 analogue printout (paper band: 0.07-0.18 % loss,
    74.99 % memory saving)."""
    head = (f"  {'config':<18}{'variant':<16}{'rounding':<10}{'src':<7}"
            f"{'fp32':>8}"
            f"{'ptq':>8}{'qat':>8}{'d_ptq':>8}{'d_qat':>8}{'saving':>9}"
            f"{'m7_ms':>9}{'gap8_ms':>9}{'sat%':>7}{'snr_db':>8}"
            f"{'flash':>9}{'ram':>8}")
    lines = [head]
    for r in rows:
        lines.append(
            f"  {r.name:<18}{r.variant:<16}{r.rounding:<10}{r.source:<7}"
            f"{r.acc_f32:8.4f}"
            f"{r.acc_ptq:8.4f}{r.acc_qat:8.4f}{r.delta_ptq:8.4f}"
            f"{r.delta_qat:8.4f}{r.saving_pct:8.2f}%"
            f"{r.est_ms_m7:9.2f}{r.est_ms_gap8:9.2f}"
            f"{r.sat_pct:7.2f}{r.snr_db:8.1f}"
            f"{r.flash_bytes:>9,}{r.ram_bytes:>8,}")
    lines.append("  paper Table 2: accuracy loss 0.07-0.18 %, "
                 "saving 74.99 % (latency est: repro_torch.edge.costmodel; "
                 "sat/snr: repro_torch.obs.numerics)")
    return "\n".join(lines)
