"""Serve an LM with batched requests on the port, float vs W8A8 side by
side.

    PYTHONPATH=src python examples/torch_serve_quantized_lm.py \
        --arch stablelm_3b
    PYTHONPATH=src python examples/torch_serve_quantized_lm.py \
        --arch stablelm_3b --no-reduce      # the config in full, on the card

The counterpart of examples/serve_quantized_lm.py on `repro_torch`: the
paper's Qm.n power-of-two int8 framework generalized to transformer
serving, per-output-channel int8 weights and dynamic per-tensor int8
activations (`repro_torch.quant.lm_quant`), whose products run the
`w8a8_dense` CUDA kernel on the card.  Prints the weight bytes of both
trees, prefill and decode time of both paths, and the greedy-token
agreement between them.  The reference's flags, plus --device (the card
unless `cpu` is asked) and --reduce, a BooleanOptionalAction that is on
by default as the reference's example always reduces: --no-reduce
serves the full config (its bf16 tree and the int8 tree quantized from
it must fit the card together).  Times are on the host clock around
work that ends in `torch.cuda.synchronize()`.  A VLM's decode starts
after its image prefix, as `repro_torch.launch.serve` does.
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.data.synthetic import TokenTask  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import reduced  # noqa: E402
from repro_torch.models.transformer import (build_model,  # noqa: E402
                                            decode_alloc)
from repro_torch.quant.lm_quant import (quantize_lm_params,  # noqa: E402
                                        quantized_bytes)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_wave(model, params, prompts, gen, alloc, extra, pos0):
    """A prefill, then gen - 1 greedy decode steps: (tokens int32 [B,
    gen] on the host, prefill s, decode s)."""
    batch = dict(extra, inputs=prompts)
    device = prompts.device
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, alloc=alloc)
        _sync(device)
        t_pre = time.perf_counter() - t0
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        toks = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = model.decode_step(params, cache, tok, pos0 + i)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            toks.append(tok)
        _sync(device)
        t_dec = time.perf_counter() - t0
    return torch.cat(toks, 1).cpu().numpy(), t_pre, t_dec


def serve_quantized_lm(cfg, params=None, requests: int = 8,
                       prompt_len: int = 64, gen: int = 24, device=None,
                       log=print) -> dict:
    """Serve `cfg` float, then W8A8 from the same weights (drawn from
    `torch.Generator(device).manual_seed(0)` unless `params` is given).
    Returns {"fp_bytes", "q_bytes", "tokens_float", "tokens_w8a8",
    "prefill_s", "decode_s" (each a (float, w8a8) pair), "agree"}."""
    device = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(0), device)
    fp_bytes = quantized_bytes(params)
    qparams = quantize_lm_params(params)
    q_bytes = quantized_bytes(qparams)
    log(f"== {cfg.name} (d_model={cfg.d_model}, {cfg.num_layers} layers): "
        f"weights {fp_bytes / 2**20:.1f} MiB bf16 -> "
        f"{q_bytes / 2**20:.1f} MiB W8A8")

    prompts = torch.as_tensor(
        TokenTask(cfg.vocab_size, prompt_len, seed=3)
        .batch(0, requests)["inputs"], device=device)
    alloc = decode_alloc(prompt_len + gen)
    extra = {}
    pos0 = prompt_len
    if cfg.family == "vlm":
        extra["prefix_embeds"] = torch.zeros(
            (requests, cfg.num_prefix_embeds, cfg.d_model),
            dtype=torch.float32, device=device)
        pos0 += cfg.num_prefix_embeds
    if cfg.is_encoder_decoder:
        extra["frames"] = torch.zeros(
            (requests, prompt_len, cfg.d_model), dtype=torch.float32,
            device=device)

    g_f, pre_f, dec_f = run_wave(model, params, prompts, gen, alloc, extra,
                                 pos0)
    g_q, pre_q, dec_q = run_wave(model, qparams, prompts, gen, alloc, extra,
                                 pos0)
    agree = float((g_f == g_q).mean())
    n_tok = requests * (gen - 1)
    for what, pre, dec in (("float", pre_f, dec_f), ("w8a8 ", pre_q, dec_q)):
        log(f"  {what}: prefill {pre * 1e3:7.1f} ms, decode "
            f"{dec * 1e3:7.1f} ms ({dec * 1e3 / max(gen - 1, 1):.2f} ms a "
            f"step, {n_tok / max(dec, 1e-9):7.1f} tok/s)")
    log(f"  greedy-token agreement float vs w8a8: {agree:.3f}")
    return {"fp_bytes": fp_bytes, "q_bytes": q_bytes, "tokens_float": g_f,
            "tokens_w8a8": g_q, "prefill_s": (pre_f, pre_q),
            "decode_s": (dec_f, dec_q), "agree": agree}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm_3b")
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve reduced(cfg, d_model=--d-model) (default); "
                    "--no-reduce serves the full config")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg, d_model=args.d_model)
    return serve_quantized_lm(cfg, requests=args.requests,
                              prompt_len=args.prompt_len, gen=args.gen,
                              device=args.device)


if __name__ == "__main__":
    main()
