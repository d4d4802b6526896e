"""Batched LM serving driver: prefill + greedy decode loop with optional
W8A8 quantization; the counterpart of `repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b \
      --requests 8 --prompt-len 64 --gen 32 --quant w8a8 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \
      --no-reduce --quant w8a8          # full size, on the card

Requests are batched (all rows of a wave share a decode position), the
KV cache (and a recurrent mixer's state) is allocated once per wave, an
encoder-decoder gets zero frame embeddings of the prompt's length (the
reference's speech-frontend stub), and --quant w8a8 swaps the
parameter tree for int8 weights with per-channel power-of-two scales
(repro_torch.quant.lm_quant), whose products run the `w8a8_dense` CUDA
kernel on the card.  The same flags, output lines and greedy loop as the
reference, with two differences: --device (the card unless `cpu` is
asked; no GPU and no --device cpu raises), and --reduce is a
BooleanOptionalAction, default on as in the reference, so --no-reduce
serves the full config (the reference's store_true flag with default
True cannot be turned off).

Weights are random from `torch.Generator(device).manual_seed(seed)`,
drawn leaf by leaf in float32 and cast, so a 15 B-parameter tree never
holds two float32 copies; with --quant w8a8 the float tree is quantized
leaf by leaf and freed as it goes.  Float matmuls run with TF32 off
(torch's default), which `serve` checks; the model's prefill and decode
steps turn off cuBLAS's reduced-precision bf16 reductions for their
duration (`models.layers.full_bf16_sums`), so every bf16 product is
rounded once from a float32 sum.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.synthetic import TokenTask
from repro_torch.device import resolve_device
from repro_torch.launch.train import reduced
from repro_torch.models.transformer import build_model, decode_alloc
from repro_torch.quant.lm_quant import quantize_lm_params, quantized_bytes


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, requests: int = 8, prompt_len: int = 64, gen: int = 32,
          quant: str = "none", device=None, seed: int = 0,
          log=print) -> dict:
    """Serve `requests` prompts of `prompt_len` tokens (TokenTask, seed
    3) for `gen` greedy tokens.  Returns {"tokens" int32 [requests, gen],
    "prefill_s", "decode_s", "tok_per_s", "fp_bytes", "param_bytes",
    "logits" (the last step's), "model", "params", "prompts", "pos0"}."""
    device = resolve_device(device)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("serve runs float matmuls in full float32: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(seed), device)
    fp_bytes = quantized_bytes(params)
    if quant == "w8a8":
        params = quantize_lm_params(params, consume=True)
        log(f"[quant] params {fp_bytes / 2**20:.1f} MiB -> "
            f"{quantized_bytes(params) / 2**20:.1f} MiB int8")
    elif quant != "none":
        raise ValueError(f"unknown quant {quant!r}")

    task = TokenTask(cfg.vocab_size, prompt_len, seed=3)
    prompts = torch.as_tensor(task.batch(0, requests)["inputs"],
                              device=device)
    alloc = decode_alloc(prompt_len + gen)
    batch = {"inputs": prompts}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.zeros(
            (requests, cfg.num_prefix_embeds, cfg.d_model),
            dtype=torch.float32, device=device)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros(
            (requests, prompt_len, cfg.d_model), dtype=torch.float32,
            device=device)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, alloc=alloc)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out_tokens = [tok]
        pos0 = prompt_len + (cfg.num_prefix_embeds
                             if cfg.family == "vlm" else 0)
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = model.decode_step(params, cache, tok, pos0 + i)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out_tokens.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    tokens = torch.cat(out_tokens, 1).cpu().numpy()
    return {"tokens": tokens, "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": requests * (gen - 1) / max(t_decode, 1e-9),
            "fp_bytes": fp_bytes, "param_bytes": quantized_bytes(params),
            "logits": logits, "model": model, "params": params,
            "prompts": prompts, "pos0": pos0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm_3b")
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve reduced(cfg, d_model=--d-model) (default); "
                    "--no-reduce serves the full config")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--quant", choices=("none", "w8a8"), default="none")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg, d_model=args.d_model)
    res = serve(cfg, args.requests, args.prompt_len, args.gen, args.quant,
                args.device)
    gen = np.asarray(res["tokens"])
    print(f"prefill: {res['prefill_s'] * 1e3:.1f} ms for "
          f"{args.requests}x{args.prompt_len} tokens")
    print(f"decode : {res['decode_s'] * 1e3:.1f} ms for {args.gen - 1} "
          f"steps ({res['tok_per_s']:.1f} tok/s aggregate)")
    print("sample completions (first 2 rows, first 12 tokens):")
    for r in range(min(2, args.requests)):
        print(f"  req{r}: {gen[r, :12].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
