"""Serving launcher: thin CLI over the serving engine (``repro/launch/serve.py``).

Runs an architecture through the continuous-batching engine — batched
single-pass prefill and blocked decode with on-device sampling — and
reports per-request latency, aggregate tokens/s and the executor counts.
``--sequential`` runs the token-by-token oracle path instead. Runs on the
card unless ``--device cpu`` is given. The MoE configs (grok-1-314b,
deepseek-v3-671b) and qwen2-vl-72b do not fit one card at ``--full``:
``chip_smoke.py`` serves them at published widths with their depth cut
(qwen2-vl-72b: 16 of 80 layers, 66.1 GB of fp32 weights), through
``build_inputs``, ``build_engine`` and ``run_engine``. qwen2-vl-72b serves
text only, as the reference does: M-RoPE over the text ids.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --full \
      --batch 2 --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --full \
      --batch 2 --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --full \
      --batch 2 --prompt-len 2080 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --full \
      --batch 2 --prompt-len 4096 --gen 32 --spec-gamma 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium --full \
      --batch 4 --prompt-len 416 --gen 32 [--cache-dtype int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch deepseek-v3-671b \
      --batch 2 --prompt-len 32 --gen 8 [--cache-dtype int8] [--spec-gamma 2]
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch gemma3-1b \
      --batch 2 --prompt-len 32 --gen 8 [--spec-gamma 2] [--prefix-cache]
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch qwen2-vl-72b \
      --batch 2 --prompt-len 32 --gen 8 [--spec-gamma 2] [--prefix-cache]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.common.backend import resolve_device
from repro_torch.common.config import get_config
from repro_torch.launch.engine import (CACHE_DTYPES, ServeEngine, parse_cache_dtype,
                                       sequential_decode, sequential_prefill,
                                       sequential_step_fn)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

def build_inputs(cfg, batch: int, prompt_len: int, seed: int = 0, device="cpu"):
    """(params, prompts, extra_embeds) for a serve run. The prompts, and
    the audio family's frames [batch, encoder_seq, d] (None for the other
    families: the VLM family serves text only, as in the reference), are
    the reference's (one ``np.random.RandomState(seed)``, the frames drawn
    after the prompts); the params come from the port's
    ``init_params`` with a generator seeded with ``seed`` on ``device``
    itself, so they are not the reference's, and on the card they differ
    from the CPU's (a full-width model is drawn there rather than on one
    CPU generator; ``chip_smoke.py`` phase 3e times both)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = L.init_params(T.model_specs(cfg), gen, torch.float32, device)
    rng = np.random.RandomState(seed)
    prompts = rng.randint(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    extra = None
    if cfg.family == "audio":
        extra = rng.randn(batch, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    return params, prompts, extra


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dtype", default="bf16",
                    help=f"one of {sorted(CACHE_DTYPES)} (int8 = quantized caches)")
    ap.add_argument("--decode-block", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=0,
                    help="decode slots (0 = --batch)")
    ap.add_argument("--spec-gamma", type=int, default=0,
                    help="self-speculative draft length (0 = off; greedy only)")
    ap.add_argument("--spec-draft-layers", type=int, default=0,
                    help="truncated-depth draft layers (0 = num_layers // 2)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="seed caches from previously-seen pow2 prompt heads")
    ap.add_argument("--sequential", action="store_true",
                    help="run the token-by-token oracle path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        args.cache_dtype = parse_cache_dtype(args.cache_dtype)
    except ValueError as e:
        ap.error(str(e))
    try:
        cfg = get_config(args.arch, smoke=args.smoke)
        T.model_specs(cfg)
    except (KeyError, ValueError) as e:
        ap.error(f"--arch {args.arch}: not an LLM architecture ({e!r})")
    return args


def build_engine(cfg, params, args):
    """The ``ServeEngine`` the CLI's flags describe."""
    return ServeEngine(cfg, params, max_batch=args.max_batch or args.batch,
                       cache_dtype=args.cache_dtype, decode_block=args.decode_block,
                       temperature=args.temperature, seed=args.seed,
                       spec_gamma=args.spec_gamma,
                       spec_draft_layers=args.spec_draft_layers or None,
                       prefix_cache=args.prefix_cache)


def run_engine(engine, prompts, extra, args):
    """Serve ``prompts`` (with the audio family's frames ``extra``) through
    ``engine`` for ``args.gen`` new tokens each: (report, tokens)."""
    tokens, rep = engine.generate(list(prompts), args.gen, extra_embeds=extra)
    prefill_s = max((r["prefill_s"] for r in rep["requests"]), default=0.0)
    decode_s = max(rep["wall_s"] - prefill_s, 1e-9)
    report = {
        "arch": args.arch,
        "mode": "engine",
        "batch": args.batch,
        "prefill_s": round(prefill_s, 3),
        # decode-only rate (same basis as ms_per_decode_step); end-to-end
        # throughput is tokens_per_s_e2e
        "decode_tok_per_s": round(rep["generated_tokens"] / decode_s, 1),
        "tokens_per_s_e2e": rep["tokens_per_s"],
        "ms_per_decode_step": round(1000 * decode_s / max(args.gen, 1), 2),
        "wall_s": rep["wall_s"],
        "requests": rep["requests"],
        "compiled_executors": rep["compiled_executors"],
        "sample_output": tokens[0][:8],
        "generated_tokens": rep["generated_tokens"],
    }
    for k in ("speculative", "prefix_cache"):
        if k in rep:
            report[k] = rep[k]
    return report, tokens


def run(args):
    """Serve one batch of prompts: (report, tokens per request)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    t0 = time.perf_counter()
    params, prompts, extra = build_inputs(cfg, args.batch, args.prompt_len, args.seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_init = time.perf_counter() - t0

    if args.sequential:
        step = sequential_step_fn(cfg)
        t0 = time.perf_counter()
        logits, caches = sequential_prefill(cfg, params, prompts, args.prompt_len + args.gen,
                                            extra, args.cache_dtype, step=step)
        logits.cpu()  # wait for the prefill
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = sequential_decode(cfg, params, logits, caches, args.prompt_len, args.gen,
                                 args.temperature, args.seed, step=step)
        t_decode = max(time.perf_counter() - t0, 1e-9)
        report = {
            "arch": args.arch,
            "mode": "sequential",
            "batch": args.batch,
            "prefill_s": round(t_prefill, 3),
            "decode_tok_per_s": round(args.batch * args.gen / t_decode, 1),
            "ms_per_decode_step": round(1000 * t_decode / max(args.gen, 1), 2),
            "wall_s": round(t_prefill + t_decode, 3),
            "sample_output": toks[0, :8].tolist(),
        }
        tokens = toks.tolist()
    else:
        report, tokens = run_engine(build_engine(cfg, params, args), prompts, extra, args)
    report["init_s"] = round(t_init, 3)
    report["device"] = str(device)
    if device.type == "cuda":
        report["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    return report, tokens


def main(argv=None):
    report, _ = run(parse_args(argv))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
