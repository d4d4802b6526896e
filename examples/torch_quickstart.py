"""Quickstart on the PyTorch/CUDA port: quantize a CapsNet to int8 with
the typed pipeline API, check the CUDA kernels bit for bit, serve batched
requests, then export the model as a bit-exact MCU artifact.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The counterpart of examples/quickstart.py on `repro_torch`: the paper's
MNIST CapsNet (Table 1) as a `CapsPipeline`, post-training-quantized with
the Qm.n power-of-two framework (Alg. 6/7), the footprint (Table 2
analogue), the `torch` backend held against the `cuda` backend (the
fused `routing_q7` and `squash_q7` kernels) in place of the reference's
jnp-against-Pallas check, six requests served through
`CapsServeEngine`, and the `.capsbin` export re-verified in the EdgeVM.
Weights come from `torch.Generator().manual_seed(0)`; `quickstart(params=)`
takes any float params of the MNIST geometry instead (the tests carry the
reference's across with `repro_torch.convert.params_from_reference`).
On the CPU the `cuda` backend does not run, and the check says so.
"""
import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.edge import export_artifacts  # noqa: E402
from repro_torch.nn import MNIST, CapsPipeline  # noqa: E402
from repro_torch.serving import CapsServeEngine, ModelRegistry  # noqa: E402


def footprint(pipe: CapsPipeline, params, qnet) -> dict:
    """fp32 KB, int8 KB and the saving, as the reference's
    `ptq.footprint_report` gives them."""
    fp32, int8 = pipe.param_bytes(params), qnet.memory_bytes()
    return {"fp32_kb": fp32 / 1024.0, "int8_kb": int8 / 1024.0,
            "saving_pct": 100.0 * (1 - int8 / fp32)}


def quickstart(params=None, device=None, log=print) -> dict:
    """Run the quickstart on `device` (the card unless `cpu` is asked).
    Returns the printed numbers: {"footprint", "plan", "match" (None on
    the CPU), "lengths0", "preds", "buckets", "report", "verified"}."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    cfg = MNIST
    log(f"== {cfg.name}: conv{cfg.conv_filters} -> primary caps "
        f"{cfg.pcap_caps}x{cfg.pcap_dim} -> class caps "
        f"{cfg.num_classes}x{cfg.caps_dim} (routings={cfg.routings})")
    log(f"   capsule layer geometry: {cfg.num_classes}x"
        f"{cfg.num_input_caps}x{cfg.caps_dim}x{cfg.pcap_dim} "
        f"(paper Table 7 'L')")

    pipe = CapsPipeline.from_config(cfg)
    if params is None:
        params = pipe.init(torch.Generator().manual_seed(0), device)

    # --- post-training quantization (paper §4, Alg. 6/7) ------------------
    calib = make_image_dataset("mnist", 64, seed=1)[0]
    qnet = pipe.quantize(params, calib, rounding="nearest")
    rep = footprint(pipe, params, qnet)
    log(f"   footprint: fp32 {rep['fp32_kb']:.2f} KB -> int8 "
        f"{rep['int8_kb']:.2f} KB  (saving {rep['saving_pct']:.2f} %)")
    caps_plan = qnet.plan["caps"]
    log(f"   caps plan: uhat_shift={caps_plan.uhat_shift} "
        f"logit_frac={caps_plan.logit_frac} "
        f"caps_out_shifts={caps_plan.caps_out_shifts} "
        f"variants={qnet.variants.tag}")

    # --- int8 inference: torch oracle vs the CUDA kernel backend ----------
    x = make_image_dataset("mnist", 4, seed=2)[0]
    with torch.inference_mode():
        xq = qnet.quantize_input(torch.as_tensor(x, device=device))
        v_ref = qnet.forward(xq)                   # torch oracle semantics
        match = None
        if on_card:
            v_kern = qnet.with_backend("cuda").forward(xq)   # fused routing
            match = bool(torch.equal(v_ref, v_kern))
            log(f"   fused CUDA routing kernel == int8 oracle: {match}")
            if not match:
                raise AssertionError("the cuda backend differs from the "
                                     "torch oracle")
        else:
            log("   fused CUDA routing kernel == int8 oracle: not run "
                "(no card: the cuda backend runs on CUDA tensors only)")
        lengths0 = qnet.class_lengths(v_ref)[0].cpu().numpy()
    log(f"   class lengths (sample 0): {lengths0.round(3)}")

    # --- serve it: bucketed micro-batch waves -----------------------------
    served = qnet.with_backend("cuda") if on_card else qnet
    registry = ModelRegistry(specs={}, device=device)
    registry.install("mnist", served)
    engine = CapsServeEngine(registry, buckets=(1, 4, 8))
    engine.warmup("mnist")
    images = make_image_dataset("mnist", 6, seed=3)[0]
    engine.submit_many(images, "mnist")
    done = engine.drain()
    preds = [c.pred for c in done]
    buckets = sorted({c.bucket for c in done})
    log(f"   served preds: {preds} (wave buckets: {buckets})")
    log(f"   {engine.metrics.report()}")
    # engine waves are bit-identical to a direct QuantCapsNet.forward
    with torch.inference_mode():
        v_direct = qnet.forward(qnet.quantize_input(
            torch.as_tensor(images, device=device))).cpu().numpy()
    if not all(np.array_equal(c.v_q, v_direct[c.rid]) for c in done):
        raise AssertionError("a served v_q differs from a direct forward")

    # --- export it: the paper's actual endgame (repro_torch.edge) ---------
    with tempfile.TemporaryDirectory() as d:
        result = export_artifacts(served, d, stem="mnist_L",
                                  verify_images=x)
    r = result["report"]
    log(f"   MCU artifact: flash {r['flash_bytes'] / 1000:.1f} KB, "
        f"RAM {r['ram_bytes'] / 1000:.1f} KB "
        f"(arena {r['arena_bytes']} B), "
        f"{r['saving_pct']:.1f}% below fp32 — VM re-verified "
        f"bit-exact on {result['verified']} images")
    log("quickstart OK")
    return {"footprint": rep, "plan": caps_plan, "match": match,
            "lengths0": lengths0, "preds": preds, "buckets": buckets,
            "report": r, "verified": result["verified"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)
    return quickstart(device=args.device)


if __name__ == "__main__":
    main()
