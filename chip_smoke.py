#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the nvcc build of every kernel source in src/repro_torch/csrc/ (one
     nvcc per source, all started together); ptxas must report no spills
     for the flash and compress kernels;
  2. the compress kernel against its plain PyTorch version on the card, at
     the main path's shape (also with NaN rows) and at a large ragged shape
     (levels 0, 16, 128): bit-identical (torch.equal), with device times
     (CUDA graph replays timed by CUDA events) beside the least time the
     card could take and the launch floor (a one-element zero_() timed the
     same way); then the edge-case matrix: widths 1 to 4000 (every
     register bucket, non-multiples of 32, the shared-memory body past
     1024) with k <= 0, k >= len, len = 0, tied magnitudes, ±inf, NaN,
     all-zero rows, subnormals, values near the fp32 maximum and rows with
     no finite value (all NaN, all ±inf, NaN mixed with ±inf), at levels
     0, 16 and 128 (torch.equal; NaN only where both versions give NaN);
  2b. the same for the DP compress kernel (clip C, noise multiplier σ):
     the main message with noise from a CUDA generator (C=1, σ=1), the
     large ragged shape (σ=0.5), NaN rows, the edge-case matrix (σ=0.5),
     and σ=0 with C=1e30 against the non-DP kernel; its time over the
     non-DP kernel's at the same shape;
  3. the main path: ``repro_torch.launch.train.run_ehealth`` — paper-cnn,
     organamnist, c-hsgd (k=0.25, b=128), M=10, K=64, α=0.25, 2048 samples,
     P=4, Q=2, 10 rounds — with the launch counters zeroed just before and
     read just after;
  3b. the fixed private path: the main path with --dp-clip 1 --dp-sigma 1
     --secure-agg: 20 DP launches and no other, one round executor, the
     composed ε of 20 releases;
  3c. the §VI adaptive path: the main path with --adaptive --dp-clip 1
     --dp-sigma 1 --epsilon 25 (T = 40 steps, pre-training probe on): one
     DP launch a round, ε within 25, one executor per (P, Q, k, b) bucket;
     and --adaptive without DP, whose loss must fall;
  4. the card against the CPU: 2 c-hsgd rounds from the same initial model
     and the same participant draws, per-step losses within rtol 1e-3;
  4b. the same for 2 rounds of the fixed private path (same participants,
     noise rows and masks) and for a short adaptive run (T = 8, no probe:
     the same P, Q and rungs); and on the card the masked ring aggregate
     equals the unmasked one bit for bit;
  4e. the card against the CPU on the population path: 2 semi_async rounds
     from the same initial model, the same cohorts and round records,
     per-step losses within rtol 1e-3;
  4f. the card against the CPU on the LLM path: 2 rounds at gemma3-1b's
     smoke widths (--pods 2, k=0.25, b=128) from the same CPU-drawn model
     and token stream, per-step losses within rtol 1e-3;
  5. a {"kernels": [...]} summary line (the compress kernels, flash, the
     scan and its backward), the nvidia-smi line, and last the
     {"ok": true, "device": {...}} line.

The LLM-scale federation (phases 2, 2b and after 3h):
  2, 2b. the edge-case matrix also holds widths past one block's shared
     memory (58113, 65536, 262144: the wide body, one block a row) and the
     last width of the shared-memory body (58112), for both kernels; the
     head's rows of gemma3-1b's exchange message, [1152, 262144] at
     k = 25 %, b = 128, are held bit for bit and timed beside their bound;
  3i. ``repro_torch.launch.train --arch gemma3-1b`` at the published widths
     (26 layers, d 1152, V 262144; --batch 2 --seq 64, random weights):
     --steps 20 --compression-k 0.25 --quantization 128 --pods 2, and
     --adaptive --steps 16 --max-interval 8 with the same k and b. Each
     runs once with the counters zeroed just before and read just after:
     exactly 4 compress launches (the message's row groups) an exchange
     that compresses, one executor a bucket, finite losses that fall
     within every exchange interval of two or more steps, steps/s and peak
     device memory; and once with every row group held against plain as
     it is made (torch.equal), then dropped, each launch timed by CUDA
     events beside its bound.

The population and fault-tolerant runtimes (after phase 3c):
  3f. ``repro_torch.launch.train --population sync`` and ``semi_async`` at the
     full width (paper-cnn, M=10, K=64, 2048 samples, 64 simulated
     devices a group, cohort 8, P=4, Q=2, C-HSGD k=0.25, b=128), 10 rounds,
     the counters zeroed just before and read just after: rounds × Λ compress
     launches and no other kernel, one executor per cohort bucket seen,
     finite losses that fall; steps/s and simulated seconds; every message
     the runs handed the compress kernel (the cohort bucket's row count, not
     the fixed path's) held against the plain version (torch.equal), and
     the first one timed as in phase 2;
  3g. the defense's cost on fault-free rounds: on one cohort, 4 runs of 10
     rounds of each executor in alternating order: the plain cohort
     executor, the screened one (fault terms all zero) with the robust
     center always computed as mean, median and trimmed, the screened one
     with the center left out (the screen's own cost) and with the center
     behind a host branch (the reference's lax.cond); steps/s, and every
     screened run's parameters and losses equal the plain run's
     (torch.equal);
     then the resilient runtime with --fault-dropout 0.1 --fault-nan 0.05
     --fault-outlier 0.05 --fault-msg-corrupt 0.05 --ckpt-every 2, robust
     (ends recovered, updates flagged) and --no-defense, both with executed
     rounds × Λ compress launches (rolled-back rounds counted) and the
     kernel held against plain on every message they handed it, the naive
     run's non-finite rows included (equal, NaN where both are NaN); then
     --preempt-round 3 raises at round 3 and --resume finishes with losses
     and parameters equal (torch.equal) to the uninterrupted robust run;
  3h. --population adaptive (one compress launch an executed exchange) and
     the quickstart twin (``repro_torch.examples.quickstart``, whose
     auc_roc > 0.6 assertion must hold) on the card.

Serving (after phase 2b, 3h and 4b respectively):
  2c. the flash-attention kernel against its plain PyTorch version on the
     card: [8, 4096, 256] (gemma3-1b's prefill) with windows 0 and 1024,
     [64, 4096, 64] (stablelm-1.6b's head_dim), a ragged [3, 2500, 128],
     [5, 1000, 32], and bf16; tile edges at BH = 2: S in {1, 63, 65, 129,
     4097} at D = 256 (fp32, bf16) and D = 64 (bf16), windows 1, = S and
     > S; within 2e-5 + 2e-5·|plain| in fp32 and 2e-2 + 2e-2·|plain| in
     bf16, with the kernel's, the plain version's and
     F.scaled_dot_product_attention's times beside the tensor-core route's
     bound (3xTF32 at the TF32 rate for fp32, the bf16 rate for bf16) and
     the old bound of fp32 outside the tensor cores. Phase 1 also checks
     that ptxas reports no spills for any flash instantiation;
  3d. the serving path at full width: ``repro_torch.launch.serve`` with
     --arch gemma3-1b --full --batch 2 --prompt-len 4096 --gen 32, the
     launch counters zeroed just before and read just after: exactly 26
     flash launches (one per layer of the one prefill group), 64 tokens in
     [0, V), with prefill seconds, decode tokens/s, first-token latency,
     executor counts and peak device memory;
  4c. the card against the CPU on the serving path: gemma3-1b's smoke
     widths with a 4096-token prompt (the card takes the flash kernel, the
     CPU the blockwise twin): first-step logits within 1e-4 of the largest
     |logit|, and equal greedy tokens from the engine.

The rest of dense serving and the last two dense configs (phase 2c's
cases, then after 3d, 3e and 4f respectively):
  2c. also gemma3-4b's prefill shape [16, 4096, 256] (windows 0 and 1024)
     and nemotron-4-15b's [96, 4096, 128] (head_dim 128, GQA 48:8), fp32;
  3j. phase 3d's command with --spec-gamma 4 (self-speculative decoding, a
     13-layer draft): the tokens equal phase 3d's plain tokens (the same
     seed draws the same weights on the card), exactly 26 flash launches
     and no other, one spec executor; acceptance and ms a generated token;
     then the same prompts through the engine with the output projections
     of layers >= 13 zeroed (those layers pass the residual through, so
     the draft is the full model), against their own plain run: equal
     tokens and acceptance >= 0.9. At the first token that differs from
     plain decode the full model's top-2 logit gap is printed;
  3k. ``repro_torch.launch.loadgen`` with --arch gemma3-1b --full --requests
     8 --rate 4 --prompt-len 4096 --gen 16 --shared-prefix-frac 0.75
     --prefix-cache --cache-dtype bf16 --max-batch 2, the counters zeroed
     just before and read just after: hits > 0, 2048 seeded tokens a hit,
     flash launches a positive multiple of 26 (the missed prefill groups)
     and no other kernel, every request's tokens equal to a solo plain run
     of its prompt; p50/p99 queue, first-token and total latency,
     sustained tokens/s and SLO attainment;
  3l. the serve CLI at full width for gemma3-4b and nemotron-4-15b (--batch
     2 --prompt-len 4096 --gen 32), the card's memory freed before each:
     exactly 34 and 32 flash launches and no other, tokens in [0, V),
     prefill seconds, ms a decode step, peak device memory; nemotron-4-15b
     (varied tokens: an untied head) again with --spec-gamma 4, its tokens
     equal to its plain run's;
  4g. the card against the CPU at smoke widths with a 4096-token prompt:
     gemma3-1b's spec and plain tokens equal on both; gemma3-4b's and
     nemotron-4-15b's first-step logits within 1e-4 of the largest |logit|
     and equal greedy tokens.

Serving the ssm family (after phase 2c, 3d and 4c respectively):
  2d. the scan kernel against its plain PyTorch version on the card, bit for
     bit (torch.equal), in fp32 and bf16: falcon-mamba-7b's prefill chunk
     [2, 256, 131072], its decode step [2, 1, 131072] and ragged
     [3, 37, 7] and [2, 300, 200]; the kernel's and the plain version's
     times beside the bytes bound (no single PyTorch call computes it);
  3e. ``repro_torch.launch.serve`` with --arch falcon-mamba-7b --full --batch
     2 --prompt-len 4096 --gen 32, the launch counters zeroed just before
     and read just after: exactly 1024 scan launches for the prefill (64
     layers x 16 chunks of 256 tokens) plus 64 per decode step, no other
     kernel of the port, 64 tokens in [0, V), prefill seconds, ms a decode
     step, peak device memory and the seconds the weights took to draw on
     the card and the host's peak resident memory; then one layer's w_in
     (6.7e7 values) drawn as on the CPU, with its seconds and memory;
  4d. the card against the CPU at falcon-mamba-7b's smoke widths with a
     300-token prompt (blocks of 256, 32, 8 and 4 tokens in the engine):
     first-step logits within 1e-4 of the largest |logit|, and equal greedy
     tokens.

Serving the hybrid family, zamba2-2.7b (phase 2d's cases, then after 3e
and 4d respectively):
  2d. also zamba2-2.7b's prefill chunk [2, 256, 327680] and decode step
     [2, 1, 327680] in fp32 (a Mamba-2 layer folds H·P·N = 80·64·64
     channels into the scan, its per-head decay broadcast over P·N);
  3m. ``repro_torch.launch.serve`` with --arch zamba2-2.7b --full --batch 2
     --prompt-len 2080 --gen 32 --cache-dtype bf16, the launch counters
     zeroed just before and read just after: the shared attention block's
     ring is 2048 slots, so the prompt prefills as one 2048-token block (8
     scan chunks a layer) and 32 single tokens; exactly 54 x (8 + 32) + 54
     x 32 decode steps = 3888 scan launches, no flash and no compress
     launch, 64 tokens in [0, V), prefill seconds, ms a decode step, peak
     device memory, the weights' draw time and the executors built; then
     the same seed's weights again and the first-step logits through the
     engine's blocks: finite;
  4h. the card against the CPU at zamba2-2.7b's smoke widths (4 layers, 2
     super-blocks, window 32) with a 48-token prompt (a 32-token block,
     then 16 single-token steps past the ring's edge) and 8 new tokens:
     first-step logits within 1e-4 of the largest |logit|, equal greedy
     tokens, scan launches and no flash launch on the card.

Training the ssm and hybrid families (after phase 2d, 3l and 4h
respectively):
  2e. the scan's backward kernel against its plain version on the card,
     bit for bit (torch.equal): zamba2-2.7b's θ0 chunk [2, 64, 327680]
     (∂h_last nonzero and zero) and a tower's [2, 32, 327680],
     falcon-mamba-7b's θ0 chunk [2, 64, 131072], T = 1, T = 37 (not a
     multiple of the unroll), C = 200 (not a multiple of 256), a = 1 with
     b = 0, and a = 1e-30; each also as SSMScan's gradient through
     torch.autograd.grad; the kernel's and the plain version's times
     beside the bytes bound;
  3n. ``repro_torch.launch.train --arch zamba2-2.7b --steps 20
     --compression-k 0.25 --quantization 128 --pods 2`` at published widths
     (54 Mamba-2 layers, d 2560, 80 SSD heads of 64 x 64, N 64, V 32000;
     arXiv:2411.15242), --batch 2 --seq 64, random weights, the launch
     counters zeroed just before and read just after: exactly the scan,
     backward-scan and compress launches pinned in TRAIN_CELLS
     (``train_launches``) and no other kernel (no flash), finite losses
     falling within every exchange interval, steps/s and peak device
     memory; then one more round timed and profiled for the device's busy
     share;
  3o. the same for falcon-mamba-7b at its published widths (d 4096,
     d_inner 8192, N 16, V 65024; arXiv:2410.05355) with depth cut from 64
     to FALCON_TRAIN_LAYERS layers, built as the CLI builds it
     (``llm_hybrid(n_tower=1, remat=False)``, ``init_llm_params`` from the
     seed on the card) and run through ``LLMRoundRunner.run_fixed``;
  4i. the card against the CPU at zamba2-2.7b's and falcon-mamba-7b's smoke
     widths: 2 fixed rounds (--pods 2, k = 0.25, b = 128) from one
     CPU-drawn model and one token stream, per-step losses within rtol
     1e-3, scan and backward-scan launches on the card.
Phase 3d also prints the device bytes allocated at its start.

The audio family, whisper-medium, and the last two example twins (phase 2's
head rows, then after 3o and 4i respectively):
  2. also whisper-medium's head rows [1024, 51865] (k = 25 %, b = 128: a
     width not a multiple of 32 in the shared-memory body), bit for bit and
     timed beside its bound;
  3p. ``repro_torch.launch.serve --arch whisper-medium --full --batch 4
     --prompt-len 416 --gen 32`` (416 + 32 = whisper's 448-token text
     context, cache bucket 512; 24 encoder and 24 decoder layers, d 1024,
     1500 frames; arXiv:2212.04356), with fp32 caches, then with int8
     caches, the launch counters zeroed just before and read just after:
     no kernel of the port (no flash: no prefill block passes 2048 tokens;
     no scan), 128 tokens in [0, V), prefill seconds, the encoder's share
     of it (CUDA events around the encoder and the cross K/V projection
     inside that prefill), ms a decode step, peak device memory; then
     5 requests through 2 slots, each with its own frames, at full width:
     every request's tokens equal ``sequential_generate``'s on the card;
  3q. ``repro_torch.launch.train --arch whisper-medium --steps 20
     --compression-k 0.25 --quantization 128 --pods 2`` at published
     widths, depth not cut: exactly exchanges x row groups compress
     launches (pinned in TRAIN_CELLS; every exchange's group count read
     from ``row_groups`` of the message the run built) and no other
     kernel, finite losses falling within every exchange interval,
     steps/s, peak device memory; then one more round whose first
     exchange's four row groups ([7077888, 64], [744120, 1024] with ζ1
     and ζ2, [147456, 4096], [2048, 51865]) are each held torch.equal
     against the plain version, and one more profiled for the busy share,
     kernels a step and device ms by kernel;
  3r. the example twins on the card: ``repro_torch.examples.train_100m_hsgd
     --steps 20`` (adaptive) and ``--fixed --q 4 --steps 20``, steps/s and
     the per-round trace, launches counted; then
     ``repro_torch.examples.serve_batched`` (int8 caches, γ = 1, the prefix
     cache, a Poisson trace, then the serve CLI);
  4j. the card against the CPU at whisper-medium's smoke widths: first-step
     logits within 1e-4 of the largest |logit| and equal greedy tokens from
     the engine (each request with its own frames), and 2 training rounds
     (--pods 2, k = 0.25, b = 128) from one CPU-drawn model, per-step
     losses within rtol 1e-3.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.common.backend import resolve_device  # noqa: E402
from repro_torch.common.config import get_config  # noqa: E402
from repro_torch.common.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.core import federation as F  # noqa: E402
from repro_torch.core.baselines import make_runner  # noqa: E402
from repro_torch.core.compression import compress_rows_ref  # noqa: E402
from repro_torch.core.controller import (  # noqa: E402
    AdaptiveConfig,
    AdaptiveHSGDRunner,
    epsilon_of,
    gaussian_rho,
    ladder_from,
)
from repro_torch.core.hsgd import HSGDRunner, exchange, init_state, resize_cohort  # noqa: E402
from repro_torch.core.population import (CoordinatorPreempted, DeviceRegistry,  # noqa: E402
                                         PopulationConfig)
from repro_torch.examples import quickstart, serve_batched, train_100m_hsgd  # noqa: E402
from repro_torch.kernels import build, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import compress as compress_kernels  # noqa: E402
from repro_torch.kernels.compress import fused_compress, stack_rows  # noqa: E402
from repro_torch.kernels.compress_cases import EDGE_WIDTHS, edge_case_rows, same_values  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention_cuda,  # noqa: E402
                                                 flash_attention_ref)
from repro_torch.kernels.ssm_scan import (SSMScan, ssm_scan_bwd_cuda,  # noqa: E402
                                          ssm_scan_bwd_ref, ssm_scan_cuda, ssm_scan_ref)
from repro_torch.launch import loadgen, profile_train, serve, steps as llm_steps  # noqa: E402
from repro_torch.launch.engine import ServeEngine, sequential_generate  # noqa: E402
from repro_torch.launch.timing import device_ms  # noqa: E402
from repro_torch.data.synthetic import llm_batch_fn  # noqa: E402
from repro_torch.launch.steps import LLMRoundRunner, init_llm_params  # noqa: E402
from repro_torch.launch.train import (build_llm, parse_args, population_rounds,  # noqa: E402
                                      run_ehealth, run_llm, run_population_cli, setup_ehealth)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.split_model import llm_hybrid  # noqa: E402
from repro_torch.models.ssm import CHUNK as SSM_CHUNK  # noqa: E402

# Data-sheet rates, dense, at the full power limit: (memory B/s, fp32 FLOP/s
# outside the tensor cores). Matched on the name nvidia-smi reports.
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),  # SXM
    ("H200", 4.8e12, 67e12),
)
MAIN_ARGV = ["--model", "paper-cnn", "--dataset", "organamnist", "--algorithm", "c-hsgd",
             "--groups", "10", "--devices", "64", "--alpha", "0.25", "--samples", "2048",
             "--p", "4", "--q", "2"]
PRIVATE_ARGV = ["--dp-clip", "1", "--dp-sigma", "1", "--secure-agg"]
ADAPTIVE_ARGV = ["--adaptive", "--dp-clip", "1", "--dp-sigma", "1", "--epsilon", "25"]
# bf16 dense tensor-core rate, FLOP/s, matched as CARD_RATES is
CARD_BF16_RATES = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12),
                   ("H200", 989e12))
# TF32 dense tensor-core rate: half the bf16 rate
CARD_TF32_RATES = tuple((key, rate / 2) for key, rate in CARD_BF16_RATES)
MAIN_ROUNDS = 10
# (name, BH, S, D, window, dtype); the first two are the serving path's
FLASH_CASES = (
    ("gemma3-1b prefill, global layer", 8, 4096, 256, 0, torch.float32),
    ("gemma3-1b prefill, local layer", 8, 4096, 256, 1024, torch.float32),
    ("stablelm-1.6b head_dim", 64, 4096, 64, 0, torch.float32),
    ("ragged S", 3, 2500, 128, 0, torch.float32),
    ("ragged S, window 700", 3, 2500, 128, 700, torch.float32),
    ("head_dim 32, window 100", 5, 1000, 32, 100, torch.float32),
    ("gemma3-1b prefill bf16, global layer", 8, 4096, 256, 0, torch.bfloat16),
    ("gemma3-1b prefill bf16, local layer", 8, 4096, 256, 1024, torch.bfloat16),
    # tile edges: S around the 64-row query tile and the 32/64-key KV tiles
    *((f"tile edge S={S}{sfx}", 2, S, D, 0, dtype)
      for S in (1, 63, 65, 129, 4097)
      for D, dtype, sfx in ((256, torch.float32, ""), (256, torch.bfloat16, " bf16"),
                            (64, torch.bfloat16, " D=64 bf16"))),
    ("tile edge, window 1", 2, 129, 256, 1, torch.float32),
    ("tile edge, window 1 bf16", 2, 129, 256, 1, torch.bfloat16),
    ("tile edge, window 1, S=4097", 2, 4097, 256, 1, torch.float32),
    ("tile edge, window = S", 2, 65, 256, 65, torch.float32),
    ("tile edge, window > S, D=64 bf16", 2, 4097, 64, 5000, torch.bfloat16),
    ("gemma3-4b prefill, global layer", 16, 4096, 256, 0, torch.float32),
    ("gemma3-4b prefill, local layer", 16, 4096, 256, 1024, torch.float32),
    ("nemotron-4-15b prefill", 96, 4096, 128, 0, torch.float32),
)
SERVE_ARGV = ["--arch", "gemma3-1b", "--full", "--batch", "2", "--prompt-len", "4096",
              "--gen", "32"]
SERVE_PARITY_LEN, SERVE_PARITY_GEN = 4096, 8
# self-speculative decoding at gemma3-1b full width (phase 3j): phase 3d's
# command with a draft of 4 tokens from the first 13 layers
SPEC_ARGV = SERVE_ARGV + ["--spec-gamma", "4"]
# arrival-driven traffic sharing a 3072-token system-prompt head (phase 3k):
# the prefix cache seeds its pow2 block of 2048 tokens on a hit
LOADGEN_ARGV = ["--arch", "gemma3-1b", "--full", "--requests", "8", "--rate", "4",
                "--prompt-len", "4096", "--gen", "16", "--shared-prefix-frac", "0.75",
                "--prefix-cache", "--cache-dtype", "bf16", "--max-batch", "2"]
PREFIX_LEN = 2048
# the last two dense configs at full width (phase 3l); nemotron-4-15b's
# untied head gives varied tokens, so it also runs speculatively against
# its plain tokens (gemma3's sqrt(d)-scaled tied embedding makes a random
# model repeat its last prompt token)
DENSE_ARCHS = ("gemma3-4b", "nemotron-4-15b")
DENSE_SERVE_ARGV = ["--full", "--batch", "2", "--prompt-len", "4096", "--gen", "32"]
DENSE_SPEC_ARCH = "nemotron-4-15b"
# (name, (B, T, C), a and b dtype, h0 dtype); the first is the serving
# path's prefill chunk (C = d_inner * ssm_state of falcon-mamba-7b)
SCAN_CASES = (
    ("falcon-mamba-7b prefill chunk", (2, 256, 131072), torch.float32, torch.float32),
    ("falcon-mamba-7b decode step", (2, 1, 131072), torch.float32, torch.float32),
    # zamba2-2.7b's Mamba-2 layer folds H * P * N = 80 * 64 * 64 channels
    ("zamba2-2.7b prefill chunk", (2, 256, 327680), torch.float32, torch.float32),
    ("zamba2-2.7b decode step", (2, 1, 327680), torch.float32, torch.float32),
    ("ragged", (3, 37, 7), torch.float32, torch.float32),
    ("ragged", (2, 300, 200), torch.float32, torch.float32),
    ("falcon-mamba-7b prefill chunk bf16", (2, 256, 131072), torch.bfloat16, torch.bfloat16),
    ("falcon-mamba-7b decode step bf16", (2, 1, 131072), torch.bfloat16, torch.bfloat16),
    ("ragged bf16, f32 state", (3, 37, 7), torch.bfloat16, torch.float32),
    ("ragged bf16", (2, 300, 200), torch.bfloat16, torch.bfloat16),
)
SSM_SERVE_ARGV = ["--arch", "falcon-mamba-7b", "--full", "--batch", "2", "--prompt-len", "4096",
                  "--gen", "32"]
SSM_PARITY_LEN, SSM_PARITY_GEN = 300, 8
# zamba2-2.7b at full width (phase 3m). The cache bucket is pow2(2080 + 32)
# = 4096, so the shared block's ring is min(4096, 2048) = 2048 slots: the
# first 2048-token block fills the ring exactly, the 32-token tail then
# prefills one token at a time across the ring's edge, and decode writes
# wrap the ring. (A 4096-token prompt, as in the dense cells, would prefill
# 2048 tokens one at a time.)
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_SERVE_ARGV = ["--arch", HYBRID_ARCH, "--full", "--batch", "2", "--prompt-len", "2080",
                     "--gen", "32", "--cache-dtype", "bf16"]
# phase 4h at smoke widths (window 32): a 32-token block, then 16 single
# tokens past the ring's edge
HYBRID_PARITY_LEN, HYBRID_PARITY_GEN = 48, 8
PARITY_ROUNDS = 2
ADAPTIVE_PARITY_STEPS = 8
# the population path at full width: the reference CLI's defaults
# (its paper widths) with C-HSGD's k and b
POP_ARGV = ["--model", "paper-cnn", "--dataset", "organamnist", "--algorithm", "hsgd",
            "--compression-k", "0.25", "--quantization", "128", "--groups", "10",
            "--devices", "64", "--alpha", "0.25", "--samples", "2048", "--p", "4", "--q", "2",
            "--pop-devices", "64", "--cohort", "8"]
FAULT_ARGV = ["--fault-dropout", "0.1", "--fault-nan", "0.05", "--fault-outlier", "0.05",
              "--fault-msg-corrupt", "0.05", "--ckpt-every", "2"]
POP_ROUNDS = 10
# the LLM-scale federation at gemma3-1b's published widths (phase 3i): the
# reference CLI's --batch 2 --seq 64, random weights
LLM_FIXED_ARGV = ["--arch", "gemma3-1b", "--steps", "20", "--compression-k", "0.25",
                  "--quantization", "128", "--pods", "2"]
LLM_ADAPTIVE_ARGV = ["--arch", "gemma3-1b", "--adaptive", "--steps", "16", "--max-interval", "8",
                     "--compression-k", "0.25", "--quantization", "128"]
# the head's rows of that message: [d_model, vocab] (phases 2 and 2b)
HEAD_SHAPE = (1152, 262144)
# the widest row of the compress kernels' shared-memory body (csrc/compress.cu)
SMEM_ROW_FLOATS = 58112
LLM_GROUPS = 4  # row groups of one gemma3-1b exchange message
# the scan's backward kernel against its plain version (phase 2e): (name,
# (B, T, C), the decay a, ∂h_last nonzero); the first is the hybrid
# training path's θ0 chunk (zamba2-2.7b: H·P·N = 327680 channels, 64 tokens)
SCAN_BWD_CASES = (
    ("zamba2-2.7b theta0 chunk", (2, 64, 327680), "sigmoid", True),
    ("zamba2-2.7b theta0 chunk, zero d_h_last", (2, 64, 327680), "sigmoid", False),
    ("zamba2-2.7b tower chunk", (2, 32, 327680), "sigmoid", True),
    ("falcon-mamba-7b theta0 chunk", (2, 64, 131072), "sigmoid", True),
    ("T = 1", (2, 1, 131072), "sigmoid", True),
    ("T = 37, not a multiple of the unroll; C = 7", (3, 37, 7), "sigmoid", True),
    ("C = 200, not a multiple of 256", (2, 300, 200), "sigmoid", False),
    ("a = 1 with b = 0", (2, 45, 300), "one", True),
    ("strong decay, a = 1e-30", (2, 64, 1000), "strong", True),
)
# the ssm and hybrid training cells (phases 3n, 3o): the reference CLI's
# --batch 2 --seq 64 and fixed rounds at published widths, random weights
TRAIN_ARGV = ["--steps", "20", "--compression-k", "0.25", "--quantization", "128", "--pods", "2"]
# falcon-mamba-7b's depth in phase 3o, cut from 64 layers: one pod of the
# full depth (7.8e9 fp32 parameters, 31 GB) does not fit beside its
# gradients, its stale θ0 and a second pod
FALCON_TRAIN_LAYERS = 16
# arch -> (θ0's Mamba layers, the exchange message's row groups, the run's
# launches), pinned from launch/steps.py's structure (train_launches)
TRAIN_CELLS = {
    "zamba2-2.7b": (54, 7, {"ssm_scan": 4440, "ssm_scan_bwd": 4400, "fused_compress": 70}),
    "falcon-mamba-7b": (FALCON_TRAIN_LAYERS, 5,
                        {"ssm_scan": 1400, "ssm_scan_bwd": 1360, "fused_compress": 50}),
    # no Mamba layer: row groups of widths 64, 1024, 4096 and 51865
    "whisper-medium": (0, 4, {"fused_compress": 40}),
}
# whisper-medium at published widths (phases 3p, 3q, 4j): --prompt-len 416
# + --gen 32 fill whisper's 448-token text context (cache bucket 512), far
# below the 2048 tokens that route a prefill block to flash
AUDIO_ARCH = "whisper-medium"
AUDIO_SERVE_ARGV = ["--arch", AUDIO_ARCH, "--full", "--batch", "4", "--prompt-len", "416",
                    "--gen", "32"]
AUDIO_HEAD_SHAPE = (1024, 51865)
# 5 requests through 2 slots at full width (phase 3p): (prompt length, new tokens)
AUDIO_REQUESTS = ((64, 8), (64, 12), (32, 6), (32, 10), (48, 8))
AUDIO_PARITY_LEN, AUDIO_PARITY_GEN = 24, 8
# checkpoints of phase 3g, inside the checkout's ignored build directory
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    raise RuntimeError(f"chip_smoke: no data-sheet rates for card {name!r}")


def compress_bound_ms(mat, row_len, levels: int, bw: float, flops: float, dp: bool = False):
    """Least time for one fused compress: bytes (each row's valid prefix read
    once, and with DP as much again of noise; the whole matrix written once
    with its padding as 0; k and row_len read once) over the memory rate,
    against operations (per valid element: 1 max + 16 bisection compares +
    1 keep compare; with quantization 2 extrema + sub, div, round, mul, add;
    with DP the square and sum of the norm and the scale, noise product and
    add) over the fp32 rate. Returns (bound_ms, bound_by)."""
    rows, n = mat.shape
    valid = int(row_len.sum())
    nbytes = valid * 4 * (2 if dp else 1) + rows * n * 4 + 2 * rows * 4
    ops = valid * (18 + (7 if levels > 1 else 0) + (5 if dp else 0))
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_compress(name, mat, k_rows, len_rows, levels, bw, flops, floor_ms, dp=None):
    """Kernel vs plain version on one input: bit-identical, then timed, with
    the launch floor ``floor_ms`` beside it. ``dp`` = (clip, sigma, noise),
    all on the card, selects the DP kernel; its time is then also set
    against the non-DP kernel's on the input."""
    dp_args = () if dp is None else dp
    got = fused_compress(mat, k_rows, levels, len_rows, *dp_args)
    want = compress_rows_ref(mat, k_rows, levels, len_rows, *dp_args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"{name}: kernel differs from plain (max |diff| {err})")
    nnz = int((got != 0).sum())
    ms = device_ms(lambda: fused_compress(mat, k_rows, levels, len_rows, *dp_args))
    plain_ms = device_ms(lambda: compress_rows_ref(mat, k_rows, levels, len_rows, *dp_args))
    bound, bound_by = compress_bound_ms(mat, len_rows, levels, bw, flops, dp is not None)
    extra = ""
    if dp is not None:
        row1_ms = device_ms(lambda: fused_compress(mat, k_rows, levels, len_rows))
        extra = f" non_dp_kernel_ms={row1_ms} dp_over_non_dp={ms / row1_ms}"
    print(f"[kernel] {name}: shape={tuple(mat.shape)} levels={levels} nnz={nnz} "
          f"bit-identical max_abs_err={err} kernel_ms={ms} plain_ms={plain_ms} "
          f"bound_us={bound * 1e3} ({bound_by}) bound/kernel={bound / ms} "
          f"launch_floor_ms={floor_ms} kernel/floor={ms / floor_ms}{extra} library_ms=null "
          f"(no single PyTorch call computes this function)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by}


def check_nan_rows(mat, k_rows, len_rows, levels, dp=None):
    """A NaN in a row's valid prefix: the kernel keeps that row's non-NaN
    entries and drops the NaN, bit for bit as the plain version does (the
    row max propagates NaN, so the bisection ends at 0). With DP the NaN
    makes the row's norm NaN, and the whole row comes out as zeros."""
    dp_args = () if dp is None else dp
    bad = mat.clone()
    rows = torch.arange(0, bad.shape[0], 97, device=bad.device)
    bad[rows, 0] = float("nan")
    for lv in sorted({0, levels}):
        got = fused_compress(bad, k_rows, lv, len_rows, *dp_args)
        want = compress_rows_ref(bad, k_rows, lv, len_rows, *dp_args)
        torch.cuda.synchronize()
        tag = f"NaN rows{' (DP)' if dp else ''}, levels={lv}"
        check(torch.equal(got, want), f"{tag}: kernel differs from plain")
        check(bool(torch.isfinite(got).all()), f"{tag}: NaN in the output")
        kept = (got[rows] != 0).sum(dim=1)
        if dp:
            check(int(kept.max()) == 0, f"{tag}: a NaN row kept {int(kept.max())} entries")
        else:
            check(int(kept.min()) > 0, f"{tag}: a NaN row kept no entry")
        print(f"[kernel] {tag}: {rows.numel()} rows: bit-identical, nonzeros in a NaN "
              f"row {int(kept.min())}..{int(kept.max())}")


def main_message(device):
    """The uncompressed θ0+ζ1+ζ2 message of one exchange of the main path,
    stacked as the compression kernel receives it."""
    args = parse_args(MAIN_ARGV)
    model, fed, train, data, _, _ = setup_ehealth(args, device)
    runner, eff_fed = make_runner(args.algorithm, model, fed, train)
    state = init_state(torch.Generator().manual_seed(args.seed), model, eff_fed, data)
    state = exchange(model, state, data, eff_fed)  # uncompressed
    leaves = tree_leaves({"theta0": state.stale["theta0"], "z1": state.stale["z1"],
                          "z2": state.stale["z2"]})
    mat, k_rows, len_rows, _ = stack_rows(leaves, runner.train.compression_k)
    return mat, k_rows, len_rows, runner.train.quantization_bits


def large_ragged(device, k_frac: float, seed: int = 0):
    """16384 rows cycling through widths 1024/300/129, padded to 1024."""
    widths = torch.tensor([1024, 300, 129], dtype=torch.int32)
    rows = 16384
    len_rows = widths[torch.arange(rows) % 3]
    k_rows = torch.clamp_min(torch.round(len_rows.double() * k_frac), 1).to(torch.int32)
    g = torch.Generator(device=device).manual_seed(seed)
    mat = torch.randn((rows, 1024), generator=g, device=device)
    mat = torch.where(torch.arange(1024, device=device) < len_rows.to(device)[:, None], mat, 0.0)
    return mat.contiguous(), k_rows.to(device), len_rows.to(device)


def dp_operands(mat, clip: float, sigma: float, seed: int = 1):
    """(clip, σ, noise) on the card: one-element tensors and standard
    normals from a CUDA generator, as the private path draws them."""
    g = torch.Generator(device=mat.device).manual_seed(seed)
    noise = torch.randn(mat.shape, generator=g, device=mat.device)
    as_t = lambda v: torch.tensor(v, dtype=torch.float32, device=mat.device)
    return as_t(clip), as_t(sigma), noise


def check_edge_cases(device, dp: bool):
    """The compress kernel (``dp``: the DP kernel, C=1, σ=0.5) against its
    plain version on every edge case at every width in EDGE_WIDTHS (every
    register bucket of 1..32 values a lane, non-multiples of 32, and the
    shared-memory body past 1024) and levels 0, 16 and 128."""
    checked = 0
    for n in EDGE_WIDTHS:
        mat, k_rows, len_rows = (t.to(device) for t in edge_case_rows(n))
        dp_args = dp_operands(mat, 1.0, 0.5) if dp else ()
        for lv in (0, 16, 128):
            got = fused_compress(mat, k_rows, lv, len_rows, *dp_args)
            want = compress_rows_ref(mat, k_rows, lv, len_rows, *dp_args)
            torch.cuda.synchronize()
            if not same_values(got, want):
                bad = [r for r in range(mat.shape[0]) if not same_values(got[r], want[r])]
                check(False, f"edge cases n={n} levels={lv}{' DP' if dp else ''}: kernel "
                             f"differs from plain in rows {bad} (k={k_rows[bad].tolist()}, "
                             f"len={len_rows[bad].tolist()})")
            checked += mat.shape[0]
    print(f"[kernel] {'DP ' if dp else ''}edge cases: {checked} rows at widths {EDGE_WIDTHS} "
          f"x levels 0, 16, 128: equal to plain (torch.equal; NaN where both are NaN)")


def check_dp_kernel(mat, k_rows, len_rows, levels, bw, flops, floor_ms):
    """Phase 2b: the DP kernel against its plain version; returns the main
    message's comparison and the largest difference seen."""
    main_dp = compare_compress("DP main-path message C=1 sigma=1", mat, k_rows, len_rows,
                               levels, bw, flops, floor_ms, dp_operands(mat, 1.0, 1.0))
    max_err = main_dp["max_abs_err"]
    check_nan_rows(mat, k_rows, len_rows, levels, dp_operands(mat, 1.0, 1.0))
    for k_frac in (0.1, 0.25):
        big = large_ragged(device=mat.device, k_frac=k_frac)
        for lv in (0, 16, 128):
            res = compare_compress(f"DP large ragged k={k_frac} C=1 sigma=0.5", *big, lv, bw,
                                   flops, floor_ms, dp_operands(big[0], 1.0, 0.5))
            max_err = max(max_err, res["max_abs_err"])
    check_edge_cases(mat.device, dp=True)
    for name, (m, k, ln) in (("main-path message", (mat, k_rows, len_rows)),
                             ("large ragged k=0.25", large_ragged(mat.device, 0.25))):
        for lv in sorted({0, levels}):
            same = fused_compress(m, k, lv, ln, *dp_operands(m, 1e30, 0.0))
            check(torch.equal(same, fused_compress(m, k, lv, ln)),
                  f"{name} levels={lv}: DP kernel at sigma=0, C=1e30 differs from the non-DP kernel")
            print(f"[kernel] DP {name} levels={lv}: sigma=0, C=1e30 identical to the "
                  f"non-DP kernel")
    return main_dp, max_err


def flash_pairs(S: int, window: int) -> int:
    """Unmasked (i, j) pairs of one [S, S] causal (windowed) score matrix."""
    i = torch.arange(S, dtype=torch.int64) + 1
    return int((torch.clamp(i, max=window) if window > 0 else i).sum())


def flash_bound_ms(BH, S, D, window, dtype, bw, flops, passes: int = 1):
    """Least time for one flash call: 4·D operations per unmasked pair,
    ``passes`` times, at the rate ``flops``, against q, k, v read once and
    the output written once. Returns (bound_ms, bound_by)."""
    elem = torch.finfo(dtype).bits // 8
    t_bytes = 4 * BH * S * D * elem / bw * 1e3
    t_ops = passes * BH * flash_pairs(S, window) * 4 * D / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_no_spills(src: str) -> None:
    """Every kernel of ``src`` fits its registers: ptxas reports 0 spill
    bytes (stores and loads) for each entry function."""
    rows = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      build.build_log(src))
    check(bool(rows), f"{src}: no ptxas report in the build log")
    check(all(st == "0" and ld == "0" for _, st, ld in rows),
          f"{src}: ptxas reports spills (stack frame, stores, loads): {rows}")
    print(f"[build] {src}: {len(rows)} kernels, 0 spill bytes; stack frames "
          f"{[int(frame) for frame, _, _ in rows]} bytes")


def sdpa_yardstick(q, k, v, window: int):
    """F.scaled_dot_product_attention on the same function: causal for window
    0, a boolean band mask otherwise. Timed here, never called by the port."""
    q4, k4, v4 = (x.unsqueeze(0) for x in (q, k, v))
    if window <= 0:
        return lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                                         is_causal=True)
    pos = torch.arange(q.shape[1], device=q.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=band)


def check_flash_kernel(device, name):
    """Phase 2c: the flash kernel against its plain version on every case,
    timed beside the plain version, the library call and the bound. Returns
    the comparison at the serving path's global-layer shape and the largest
    fp32 difference at the serving path's shape."""
    bw, flops32 = card_rates(name)
    flops16 = next(r for key, r in CARD_BF16_RATES if key in name)
    flops_tf32 = next(r for key, r in CARD_TF32_RATES if key in name)
    results = {}
    for case, BH, S, D, window, dtype in FLASH_CASES:
        g = torch.Generator(device=device).manual_seed(BH * S + D + window)
        q, k, v = (torch.randn((BH, S, D), generator=g, device=device).to(dtype)
                   for _ in range(3))
        got = flash_attention_cuda(q, k, v, window=window)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == q.shape, f"flash {case}: output {got.dtype}")
        err = (got.float() - want.float()).abs()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        worst = float((err - tol * want.float().abs()).max())
        check(worst <= tol, f"flash {case}: max |kernel - plain| - {tol}·|plain| = {worst} "
                            f"over {tol} (max |diff| {float(err.max())})")
        lib = sdpa_yardstick(q, k, v, window)
        lib_err = float((lib()[0].float() - want.float()).abs().max())
        ms = device_ms(lambda: flash_attention_cuda(q, k, v, window=window), inner=5, reps=7)
        plain_ms = device_ms(lambda: flash_attention_ref(q, k, v, window=window), inner=2, reps=5)
        library_ms = device_ms(lib, inner=5, reps=7)
        # the route's bound: 3xTF32 (three TF32 passes) for fp32, bf16 wgmma
        # for bf16; beside it the bound of fp32 outside the tensor cores
        if dtype == torch.float32:
            bound, bound_by = flash_bound_ms(BH, S, D, window, dtype, bw, flops_tf32, passes=3)
        else:
            bound, bound_by = flash_bound_ms(BH, S, D, window, dtype, bw, flops16)
        simt, _ = flash_bound_ms(BH, S, D, window, dtype, bw, flops32)
        res = {"max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms}
        results[case] = res
        print(f"[flash] {case}: shape=[{BH}, {S}, {D}] window={window} dtype={dtype} "
              f"max_abs_err={res['max_abs_err']} (tol {tol} + {tol}·|plain|) kernel_ms={ms} "
              f"plain_ms={plain_ms} library_ms={library_ms} (sdpa max_abs_err {lib_err}) "
              f"bound_ms={bound} ({bound_by}, tensor-core route) kernel/bound={ms / bound} "
              f"simt_bound_ms={simt} (fp32 outside the tensor cores) "
              f"kernel/library={ms / library_ms}")
        del q, k, v, got, want, err
    main_err = max(results[c[0]]["max_abs_err"] for c in FLASH_CASES[:2])
    return results[FLASH_CASES[0][0]], main_err


def scan_bound_ms(shape, a_dtype, h_dtype, bw, flops):
    """Least time for one scan: a and b read once, hs written once (in a's
    type), h0 read and h_last written once (in h0's type), against 2 fp32
    operations a step. Returns (bound_ms, bound_by)."""
    B, T, C = shape
    ea, eh = torch.finfo(a_dtype).bits // 8, torch.finfo(h_dtype).bits // 8
    t_bytes = (3 * B * T * C * ea + 2 * B * C * eh) / bw * 1e3
    t_ops = 2 * B * T * C / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_scan_kernel(device, name):
    """Phase 2d: the scan kernel against its plain version, bit for bit, on
    every case, timed beside the plain version and the bound. Returns the
    comparison at the serving path's prefill chunk (fp32) and the largest
    difference seen (0 when all are bit-identical)."""
    bw, flops32 = card_rates(name)
    results, max_err = {}, 0.0
    for case, shape, a_dtype, h_dtype in SCAN_CASES:
        g = torch.Generator(device=device).manual_seed(sum(shape))
        a = torch.sigmoid(torch.randn(shape, generator=g, device=device)).to(a_dtype)
        b = torch.randn(shape, generator=g, device=device).to(a_dtype)
        h0 = torch.randn((shape[0], shape[2]), generator=g, device=device).to(h_dtype)
        got = ssm_scan_cuda(a, b, h0)
        torch.cuda.synchronize()
        want = ssm_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        check(got[0].dtype == a_dtype and got[1].dtype == h_dtype, f"scan {case}: output types")
        err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
        max_err = max(max_err, err)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"scan {case} {shape} {a_dtype}: kernel differs from plain (max |diff| {err})")
        ms = device_ms(lambda: ssm_scan_cuda(a, b, h0))
        plain_ms = device_ms(lambda: ssm_scan_ref(a, b, h0), inner=2, reps=5)
        bound, bound_by = scan_bound_ms(shape, a_dtype, h_dtype, bw, flops32)
        res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": bound_by}
        results[case, shape] = res
        print(f"[scan] {case}: shape={list(shape)} a={a_dtype} h0={h_dtype} bit-identical "
              f"kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound} ({bound_by}) "
              f"kernel/bound={ms / bound} library_ms=null (no single PyTorch call computes "
              f"this function)")
        del a, b, h0, got, want
    return results[SCAN_CASES[0][0], SCAN_CASES[0][1]], max_err


def scan_bwd_bound_ms(shape, bw, flops):
    """Least time for one backward scan (fp32): a, ∂hs, ∂h_last, h0 and
    hs[:, :T-1] read once, ∂a, ∂b and ∂h0 written once, against 3
    operations a step. Returns (bound_ms, bound_by)."""
    B, T, C = shape
    t_bytes = 4 * (B * T * C * 4 + B * max(T - 1, 0) * C + 3 * B * C) / bw * 1e3
    t_ops = 3 * B * T * C / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_scan_bwd_kernel(device, name):
    """Phase 2e: the backward scan kernel against its plain version, bit for
    bit, on every case, directly and as ``SSMScan``'s gradient through
    ``torch.autograd.grad``; timed beside the plain version and the bound.
    Returns the comparison at the hybrid training path's θ0 chunk and the
    largest difference seen (0 when all are bit-identical)."""
    bw, flops32 = card_rates(name)
    results, max_err = {}, 0.0
    for case, shape, decay, with_last in SCAN_BWD_CASES:
        B, T, C = shape
        g = torch.Generator(device=device).manual_seed(sum(shape) + with_last)
        a = {"sigmoid": lambda: torch.sigmoid(torch.randn(shape, generator=g, device=device)),
             "one": lambda: torch.ones(shape, device=device),
             "strong": lambda: torch.full(shape, 1e-30, device=device)}[decay]()
        b = (torch.zeros(shape, device=device) if decay == "one"
             else torch.randn(shape, generator=g, device=device))
        h0 = torch.randn((B, C), generator=g, device=device)
        hs = ssm_scan_ref(a, b, h0)[0]
        d_hs = torch.randn(shape, generator=g, device=device)
        d_last = (torch.randn((B, C), generator=g, device=device) if with_last
                  else torch.zeros((B, C), device=device))
        got = ssm_scan_bwd_cuda(a, h0, hs, d_hs, d_last)
        torch.cuda.synchronize()
        want = ssm_scan_bwd_ref(a, h0, hs, d_hs, d_last)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) if x.numel() else 0.0 for x, y in zip(got, want))
        max_err = max(max_err, err)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"scan backward {case} {shape}: kernel differs from plain (max |diff| {err})")
        leaves = [x.clone().requires_grad_() for x in (a, b, h0)]
        auto = torch.autograd.grad(SSMScan.apply(*leaves), leaves, (d_hs, d_last))
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(auto, want)),
              f"scan backward {case}: SSMScan's gradients on the card differ from plain")
        del got, auto, leaves
        ms = device_ms(lambda: ssm_scan_bwd_cuda(a, h0, hs, d_hs, d_last))
        plain_ms = device_ms(lambda: ssm_scan_bwd_ref(a, h0, hs, d_hs, d_last), inner=2, reps=5)
        bound, bound_by = scan_bwd_bound_ms(shape, bw, flops32)
        res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": bound_by}
        results[case] = res
        print(f"[scan-bwd] {case}: shape={list(shape)} bit-identical (kernel and SSMScan's "
              f"autograd) d_h_last={'nonzero' if with_last else 'zero'} kernel_ms={ms} "
              f"plain_ms={plain_ms} bound_ms={bound} ({bound_by}) kernel/bound={ms / bound} "
              f"library_ms=null (no single PyTorch call computes this function)")
        del a, b, h0, hs, d_hs, d_last, want
    return results[SCAN_BWD_CASES[0][0]], max_err


def host_rss_bytes() -> int:
    """This process's resident set now."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def time_cpu_draw(cfg):
    """Draw one layer's ``w_in`` leaf of ``cfg`` as ``build_inputs`` would on
    the CPU (one CPU generator, ``init_params``): the cost per value that
    drawing the full-width weights on the card avoids. Prints seconds and
    host memory: the peak so far (the card's draw included) and the leaf's."""
    spec = T.block_specs(cfg, "mamba")["mamba"]["w_in"]
    peak0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    L.init_params({"w": L.Spec((64, 64), spec.axes)}, torch.Generator())  # first-call costs
    rss0 = host_rss_bytes()
    t0 = time.perf_counter()
    leaf = L.init_params({"w_in": spec}, torch.Generator().manual_seed(0))["w_in"]
    dt = time.perf_counter() - t0
    rss1 = host_rss_bytes()
    print(f"[init-cpu] peak host RSS before it {peak0} bytes; one layer's w_in "
          f"{list(spec.shape)}: {leaf.numel()} values drawn on one CPU generator in {dt} s "
          f"({leaf.numel() / dt} values/s, {torch.get_num_threads()} CPU threads); host RSS "
          f"{rss0} -> {rss1} bytes")
    check(bool(torch.isfinite(leaf).all()), "CPU-drawn w_in is not finite")
    del leaf


def run_serve_cli(argv):
    """``repro_torch.launch.serve`` on ``argv``: (report, tokens)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report, tokens = serve.run(serve.parse_args(argv))
    print(f"[serve] {json.dumps(report)}")
    return report, tokens


def first_step_logits(cfg, params, prompts, cache_len, cache_dtype=torch.float32, extra=None):
    """Logits [B, V] after ``prompts`` (numpy [B, S]), on the CPU: one
    fresh-cache block (after the audio family's encoder over the frames
    ``extra``), or, for the hybrid family's ring, the engine's blocks: one
    that fills the ring, then one token at a time past its edge."""
    dev = params["embed"]["table"].device
    toks = torch.from_numpy(prompts).to(dev)
    B, S = prompts.shape
    caches = T.init_decode_caches(cfg, B, cache_len, cache_dtype, dev)
    if cfg.family == "audio":
        caches = T.seed_audio_caches(cfg, params, caches, torch.from_numpy(extra).to(dev))
    if cfg.family != "hybrid":
        logits, _ = T.decode_step(cfg, params, toks, caches, 0, fresh_cache=True)
        return logits[:, -1].cpu()
    ring = min(cache_len, cfg.sliding_window)
    hidden, caches = T.decode_hidden(cfg, params, toks[:, :ring], caches, 0)
    for i in range(ring, S):
        hidden, caches = T.decode_hidden(cfg, params, toks[:, i:i + 1], caches, i)
    return T.logits_from_hidden(cfg, params, hidden[:, -1]).cpu()


def serve_parity(arch, prompt_len, gen, *devices):
    """``arch``'s smoke widths, one prompt pair of ``prompt_len`` tokens
    (each with its own frames for the audio family): (first-step logits
    [B, V] on the CPU, greedy engine tokens) per device, from the same
    CPU-drawn params."""
    cfg = get_config(arch, smoke=True)
    params0 = L.init_params(T.model_specs(cfg), torch.Generator().manual_seed(0))
    _, prompts, extra = serve.build_inputs(cfg, 2, prompt_len, seed=0)
    out = []
    for dev in devices:
        params = tree_map(lambda t: t.to(dev), params0)
        logits = first_step_logits(cfg, params, prompts, prompt_len, extra=extra)
        engine = ServeEngine(cfg, params, max_batch=2, cache_dtype=torch.float32,
                             decode_block=4)
        toks, _ = engine.generate(list(prompts), gen, extra_embeds=extra)
        out.append((logits, toks))
    return out


def top2_gap(cfg, params, prompt, tokens, frames=None):
    """The full model's top-2 logit gap after ``prompt`` and ``tokens``
    (one fresh-cache forward in fp32 caches, after the audio family's
    encoder over ``frames``): how near a tie the next token is."""
    seq = np.concatenate([np.asarray(prompt, np.int32), np.asarray(tokens, np.int32)])[None]
    dev = params["embed"]["table"].device
    caches = T.init_decode_caches(cfg, 1, seq.shape[1], torch.float32, dev)
    if frames is not None:
        caches = T.seed_audio_caches(cfg, params, caches, torch.from_numpy(frames[None]).to(dev))
    hidden, _ = T.decode_hidden(cfg, params, torch.from_numpy(seq).to(dev), caches, 0,
                                fresh_cache=True)
    top = torch.topk(T.logits_from_hidden(cfg, params, hidden[:, -1])[0], 2).values
    return float(top[0] - top[1])


def check_same_tokens(tag, cfg, params, prompts, want, got, frames=None):
    """Fails unless every request's tokens ``got`` equal ``want``; at the
    first mismatch prints the full model's top-2 logit gap there (after
    the request's ``frames`` for the audio family)."""
    for i, (w, g) in enumerate(zip(want, got)):
        if list(w) == list(g):
            continue
        j = next((t for t, (a, b) in enumerate(zip(w, g)) if a != b), min(len(w), len(g)))
        gap = (top2_gap(cfg, params, prompts[i], w[:j], None if frames is None else frames[i])
               if j < min(len(w), len(g)) else None)
        print(f"[{tag}] request {i}: first mismatch at token {j}: want {list(w)[j:j + 4]} got "
              f"{list(g)[j:j + 4]}; the full model's top-2 logit gap there: {gap}")
        check(False, f"{tag}: request {i}'s tokens differ from the plain run's at token {j} "
                     f"(top-2 logit gap {gap})")
    check(len(want) == len(got), f"{tag}: {len(got)} requests, expected {len(want)}")


def pass_through(params, dk):
    """``params`` with the output projections (attention ``wo``, MLP
    ``w_down``) of layers >= dk zeroed in place: those layers then pass the
    residual through exactly, so a dk-layer draft is the full model."""
    params["layers"]["attn"]["wo"][dk:] = 0
    params["layers"]["mlp"]["w_down"][dk:] = 0
    return params


def check_spec_serving(device, plain_tokens):
    """Phase 3j: the serve CLI with --spec-gamma 4 at gemma3-1b full width
    (tokens equal phase 3d's plain ones, 26 flash launches and no other,
    one spec executor); then, through the engine, the same prompts with the
    layers past the draft passing the residual through, against their own
    plain run: equal tokens and acceptance >= 0.9."""
    args = serve.parse_args(SPEC_ARGV)
    cfg = get_config(args.arch, smoke=args.smoke)
    gamma = args.spec_gamma
    reset_launch_counts()
    report, tokens = run_serve_cli(SPEC_ARGV)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    spec, ex = report["speculative"], report["compiled_executors"]
    print(f"[spec] launches={counts} speculative={spec} executors={ex} "
          f"prefill_s={report['prefill_s']} ms_per_generated_token (per request)="
          f"{report['ms_per_decode_step']} decode_tok_per_s={report['decode_tok_per_s']} "
          f"peak_device_bytes={report['peak_device_bytes']}")
    if tokens != plain_tokens:
        params, prompts, _ = serve.build_inputs(cfg, args.batch, args.prompt_len, args.seed,
                                                device)
        check_same_tokens("spec", cfg, params, prompts, plain_tokens, tokens)
    check(counts == {"flash_attention": cfg.num_layers},
          f"spec serving launches {counts}, expected {cfg.num_layers} flash launches and no other")
    check(ex["spec_buckets"] == ex["spec_compiles"] == 1, f"spec executors {ex}")
    out = {"random": {"acceptance": spec["acceptance"],
                      "ms_per_token": report["ms_per_decode_step"]}}
    del report, tokens
    params, prompts, _ = serve.build_inputs(cfg, args.batch, args.prompt_len, args.seed,
                                            device)
    pass_through(params, cfg.num_layers // 2)
    args.max_batch = args.batch
    runs = []
    for g in (0, gamma):
        args.spec_gamma = g
        engine = serve.build_engine(cfg, params, args)
        t0 = time.perf_counter()
        toks, rep = engine.generate(list(prompts), args.gen)
        wall = time.perf_counter() - t0
        prefill_s = max(r["prefill_s"] for r in rep["requests"])
        runs.append((toks, rep, 1000 * (wall - prefill_s) / args.gen))
        del engine
    (plain, _, plain_ms), (toks, rep, spec_ms) = runs
    acc = rep["speculative"]["acceptance"]
    print(f"[spec-pass-through] layers >= {cfg.num_layers // 2} pass the residual through: "
          f"speculative={rep['speculative']} ms_per_generated_token (per request) spec="
          f"{spec_ms} plain={plain_ms}")
    check_same_tokens("spec-pass-through", cfg, params, prompts, plain, toks)
    check(acc >= 0.9, f"pass-through acceptance {acc} under 0.9")
    out["pass_through"] = {"acceptance": acc, "ms_per_token": spec_ms,
                           "plain_ms_per_token": plain_ms}
    return out


def check_loadgen(device):
    """Phase 3k: the load generator with the prefix cache at gemma3-1b full
    width: hits seed 2048 tokens each, every request's tokens equal a solo
    plain run of its prompt, flash runs 26 times a missed prefill group."""
    args = loadgen.parse_args(LOADGEN_ARGV)
    cfg = get_config(args.arch, smoke=args.smoke)
    reset_launch_counts()
    rep, engine, trace = loadgen.run(args)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    pc, ex = rep["engine"]["prefix_cache"], rep["engine"]["compiled_executors"]
    print(f"[loadgen] launches={counts} prefix_cache={pc} executors={ex} "
          f"queue_s={rep['queue_s']} first_token_s={rep['first_token_s']} "
          f"total_s={rep['total_s']} sustained_tokens_per_s={rep['sustained_tokens_per_s']} "
          f"slo_attainment={rep['slo_attainment']} (first token within "
          f"{rep['slo_first_token_s']} s) span_s={rep['span_s']} wall_s={rep['wall_s']} "
          f"peak_device_bytes={rep['peak_device_bytes']} "
          f"arrivals_s={[round(r.t_arrival, 4) for r in trace]}")
    check(rep["requests"] == len(trace) and rep["generated_tokens"] == len(trace) * args.gen,
          f"loadgen finished {rep['requests']} requests, {rep['generated_tokens']} tokens")
    check(pc["hits"] > 0 and pc["seeded_tokens"] == PREFIX_LEN * pc["hits"],
          f"prefix cache stats {pc}")
    check(pc["hits"] + pc["misses"] == len(trace), f"prefix cache stats {pc}")
    flash = counts.pop("flash_attention", 0)
    check(not counts and flash > 0 and flash % cfg.num_layers == 0,
          f"loadgen launches flash={flash} others={counts}, expected a positive multiple "
          f"of {cfg.num_layers} and no other")
    done = sorted(engine.done, key=lambda r: r.rid)
    solo = []
    for r in done:
        eng = ServeEngine(cfg, engine.params, max_batch=1, cache_dtype=args.cache_dtype,
                          decode_block=args.decode_block)
        solo.append(eng.generate([r.prompt], r.max_new)[0][0])
        del eng
    check_same_tokens("loadgen", cfg, engine.params, [r.prompt for r in done], solo,
                      [r.tokens for r in done])
    print(f"[loadgen] every request's {args.gen} tokens equal a solo plain run of its prompt "
          f"({len(done)} requests, {pc['hits']} seeded from the store)")
    out = {k: rep[k] for k in ("queue_s", "first_token_s", "total_s", "sustained_tokens_per_s",
                               "slo_attainment", "peak_device_bytes")}
    out.update(prefix_cache=pc, flash_launches=flash)
    return out


def check_hybrid_serving(device):
    """Phase 3m: the serve CLI at zamba2-2.7b's full width, the launch
    counters zeroed just before and read just after: exactly one scan
    launch a layer for each 256-token chunk of the ring-filling block, each
    single-token step of the tail and each decode step, and no other kernel
    of the port (the shared block never takes the fresh-cache route to the
    flash kernel); tokens in [0, V). Then the same seed's weights again and
    the prompts' first-step logits through the engine's blocks: finite."""
    cfg = get_config(HYBRID_ARCH)
    args = serve.parse_args(HYBRID_SERVE_ARGV)
    reset_launch_counts()
    report, tokens = run_serve_cli(HYBRID_SERVE_ARGV)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    cache_len = 1 << (args.prompt_len + args.gen - 1).bit_length()
    ring = min(cache_len, cfg.sliding_window)
    decode_steps = args.decode_block * math.ceil((args.gen - 1) / args.decode_block)
    want_prefill = cfg.num_layers * (math.ceil(ring / SSM_CHUNK) + args.prompt_len - ring)
    want = want_prefill + cfg.num_layers * decode_steps
    print(f"[serve-hybrid] launches={counts} (prefill {want_prefill}: {cfg.num_layers} layers x "
          f"({math.ceil(ring / SSM_CHUNK)} chunks of the {ring}-token block + "
          f"{args.prompt_len - ring} single-token steps); {cfg.num_layers} x {decode_steps} "
          f"decode steps) prefill_s={report['prefill_s']} "
          f"ms_per_decode_step={report['ms_per_decode_step']} "
          f"decode_tok_per_s={report['decode_tok_per_s']} first_token_s="
          f"{[r['first_token_s'] for r in report['requests']]} "
          f"executors={report['compiled_executors']} "
          f"peak_device_bytes={report['peak_device_bytes']} "
          f"peak_device_GiB={report['peak_device_bytes'] / 2 ** 30} "
          f"init_s={report['init_s']} (weights of {cfg.param_count()} params drawn on the card)")
    check(counts == {"ssm_scan": want},
          f"hybrid serving path launches {counts}, expected {want} scan launches and no other")
    check(report["generated_tokens"] == 2 * args.gen,
          f"generated {report['generated_tokens']} tokens")
    check(len(tokens) == 2 and all(len(t) == args.gen and all(0 <= x < cfg.vocab_size
                                                              for x in t) for t in tokens),
          "hybrid serving tokens out of [0, V)")
    del report
    torch.cuda.empty_cache()
    params, prompts, _ = serve.build_inputs(cfg, args.batch, args.prompt_len, args.seed,
                                            device)
    logits = first_step_logits(cfg, params, prompts, cache_len, args.cache_dtype)
    first = torch.argmax(logits, dim=-1).tolist()
    print(f"[serve-hybrid] first-step logits {list(logits.shape)}: max |logit| "
          f"{float(logits.abs().max())}, argmax {first} (the CLI's first tokens "
          f"{[t[0] for t in tokens]})")
    check(bool(torch.isfinite(logits).all()), "hybrid serving: first-step logits not finite")
    del params, logits
    torch.cuda.empty_cache()
    return counts


def check_dense_configs():
    """Phase 3l: gemma3-4b and nemotron-4-15b through the serve CLI at full
    width, one after the other with the card's memory freed between them:
    exactly one flash launch a layer, tokens in [0, V), prefill seconds, ms
    a decode step and peak device memory."""
    out = {}
    for arch in DENSE_ARCHS:
        torch.cuda.empty_cache()
        argv = ["--arch", arch] + DENSE_SERVE_ARGV
        args = serve.parse_args(argv)
        cfg = get_config(arch, smoke=args.smoke)
        before = torch.cuda.memory_allocated()
        reset_launch_counts()
        report, tokens = run_serve_cli(argv)
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        gen = args.gen
        print(f"[serve-{arch}] launches={counts} params={cfg.param_count()} "
              f"({4 * cfg.param_count()} bytes in fp32) allocated before the run={before} "
              f"init_s={report['init_s']} prefill_s={report['prefill_s']} "
              f"ms_per_decode_step={report['ms_per_decode_step']} "
              f"decode_tok_per_s={report['decode_tok_per_s']} first_token_s="
              f"{[r['first_token_s'] for r in report['requests']]} "
              f"executors={report['compiled_executors']} "
              f"peak_device_bytes={report['peak_device_bytes']} "
              f"peak_device_GiB={report['peak_device_bytes'] / 2 ** 30}")
        check(counts == {"flash_attention": cfg.num_layers},
              f"{arch}: launches {counts}, expected {cfg.num_layers} flash launches and no other")
        check(report["generated_tokens"] == 2 * gen, f"{arch}: {report['generated_tokens']} tokens")
        check(len(tokens) == 2 and all(len(t) == gen and all(0 <= x < cfg.vocab_size for x in t)
                                       for t in tokens), f"{arch}: tokens out of [0, V)")
        out[arch] = {k: report[k] for k in ("prefill_s", "ms_per_decode_step",
                                            "peak_device_bytes", "init_s")}
        del report
        if arch == DENSE_SPEC_ARCH:
            torch.cuda.empty_cache()
            reset_launch_counts()
            spec_report, spec_tokens = run_serve_cli(argv + ["--spec-gamma", "4"])
            torch.cuda.synchronize()
            counts = dict(launch_counts)
            spec = spec_report["speculative"]
            print(f"[serve-{arch}-spec] launches={counts} speculative={spec} "
                  f"ms_per_generated_token (per request)={spec_report['ms_per_decode_step']} "
                  f"(plain {out[arch]['ms_per_decode_step']}) distinct tokens a request="
                  f"{[len(set(t)) for t in tokens]}")
            check(counts == {"flash_attention": cfg.num_layers},
                  f"{arch} spec: launches {counts}, expected {cfg.num_layers} flash launches")
            if spec_tokens != tokens:
                params, prompts, _ = serve.build_inputs(cfg, args.batch, args.prompt_len,
                                                        args.seed, torch.device("cuda"))
                check_same_tokens(f"{arch}-spec", cfg, params, prompts, tokens, spec_tokens)
            out[arch]["spec"] = {"acceptance": spec["acceptance"],
                                 "ms_per_token": spec_report["ms_per_decode_step"]}
            del spec_report, spec_tokens
        del tokens
    torch.cuda.empty_cache()
    return out


def spec_parity(arch, prompt_len, gen, *devices):
    """``arch``'s smoke widths, one prompt pair: (plain tokens, spec tokens
    with γ = 4) per device, from the same CPU-drawn params."""
    cfg = get_config(arch, smoke=True)
    params0 = L.init_params(T.model_specs(cfg), torch.Generator().manual_seed(0))
    prompts = serve.build_inputs(cfg, 2, prompt_len, seed=0)[1]
    out = []
    for dev in devices:
        params = tree_map(lambda t: t.to(dev), params0)
        runs = []
        for gamma in (0, 4):
            engine = ServeEngine(cfg, params, max_batch=2, cache_dtype=torch.float32,
                                 decode_block=4, spec_gamma=gamma)
            runs.append(engine.generate(list(prompts), gen)[0])
        out.append(runs)
    return out


def run_cli(argv, run=run_ehealth):
    """``run`` (``run_ehealth`` or ``run_llm``) on ``argv``, its stdout
    echoed: (metrics, losses, the (P, rung) of each ``[adaptive] round``
    line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        metrics, losses = run(parse_args(argv))
    out = buf.getvalue()
    print(out, end="")
    rounds = [(int(p), int(r)) for p, r in
              re.findall(r"^\[adaptive\] round +\d+: P=Q= *(\d+) .* rung=(\d+) ", out, re.M)]
    return metrics, losses, rounds


def same_start_private_losses(*devices):
    """Per-step losses of PARITY_ROUNDS rounds of the fixed private path
    (C=1, σ=1, secure aggregation) on each device, from one initial model,
    one set of participants and one set of noise rows (drawn on the CPU)."""
    args = parse_args(MAIN_ARGV + PRIVATE_ARGV)
    gen = torch.Generator().manual_seed(args.seed)
    init = parts = noise = None
    out = []
    for dev in devices:
        model, fed, train, data, w, _ = setup_ehealth(args, dev)
        runner, eff_fed = make_runner(args.algorithm, model, fed, train)
        n = PARITY_ROUNDS * eff_fed.lam
        if init is None:
            init = model.init(gen)
            parts = torch.stack([F.sample_participants(gen, eff_fed) for _ in range(n)])
        state = init_state(torch.Generator(), model, eff_fed, data,
                           params=tree_map(lambda t: t.to(dev), init))
        if noise is None:
            leaves = tree_leaves({"theta0": state.stale["theta0"], "z1": state.stale["z1"],
                                  "z2": state.stale["z2"]})
            shape = tuple(stack_rows(leaves, runner.train.compression_k)[0].shape)
            noise = [torch.randn(shape, generator=gen) for _ in range(n)]
        _, losses = runner.run_private(state, data, w, PARITY_ROUNDS, seed=args.seed,
                                       dp_clip=args.dp_clip, dp_sigma=args.dp_sigma,
                                       secure_agg=True, participants=parts, dp_noise=noise)
        out.append(losses.cpu())
    return out


def same_start_adaptive(*devices):
    """A short adaptive run (T = 8, no pre-training probe) on each device
    from one initial model and one set of participants: (losses, the
    (P, Q, rung) of each round) per device."""
    args = parse_args(MAIN_ARGV)
    gen = torch.Generator().manual_seed(args.seed)
    init = parts = None
    out = []
    for dev in devices:
        model, fed, train, data, w, _ = setup_ehealth(args, dev)
        runner, eff_fed = make_runner(args.algorithm, model, fed, train)
        if init is None:
            init = model.init(gen)
            parts = torch.stack([F.sample_participants(gen, eff_fed)
                                 for _ in range(ADAPTIVE_PARITY_STEPS)])
        state = init_state(torch.Generator(), model, eff_fed, data,
                           params=tree_map(lambda t: t.to(dev), init))
        cfg = AdaptiveConfig(total_steps=ADAPTIVE_PARITY_STEPS, init_probe=False,
                             max_interval=args.max_interval, eta_max=max(args.lr * 10, 0.05),
                             ladder=ladder_from(runner.train.compression_k,
                                                runner.train.quantization_bits))
        res = AdaptiveHSGDRunner(model, fed, runner.train, cfg).run(
            state, data, w, participants=parts)
        out.append((torch.from_numpy(res.losses), [(h["P"], h["Q"], h["rung"])
                                                   for h in res.history]))
    return out


def check_ring_on_card(device):
    """The masked ring aggregate of a real θ2 equals the unmasked one bit
    for bit on the card."""
    args = parse_args(MAIN_ARGV)
    model, fed, train, data, _, _ = setup_ehealth(args, device)
    state = init_state(torch.Generator().manual_seed(args.seed), model, fed, data)
    g = torch.Generator(device=device).manual_seed(2)
    theta2 = tree_map(lambda t: t + 0.01 * torch.randn(t.shape, generator=g, device=device),
                      state.theta2)
    masks = F.secure_agg_masks(theta2, args.seed, 0)
    got = F.secure_local_aggregate(F.secure_mask_uplink(theta2, masks), theta2)
    bare = F.secure_local_aggregate(
        F.secure_mask_uplink(theta2, tree_map(torch.zeros_like, masks)), theta2)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(bare))),
          "masked ring aggregate differs from the unmasked one on the card")
    plain = F.local_aggregate(theta2)
    dev_ = max(float((a - p).abs().max()) for a, p in zip(tree_leaves(got), tree_leaves(plain)))
    check(dev_ <= 2.0 ** -15, f"ring aggregate off the float mean by {dev_}")
    print(f"[ring] masked == unmasked ring aggregate bit for bit on the card; "
          f"max |ring - float mean| {dev_}")


def same_start_losses(*devices):
    """Per-step losses of PARITY_ROUNDS c-hsgd rounds on each device, all
    from one initial model and one set of participant draws."""
    args = parse_args(MAIN_ARGV)
    gen = torch.Generator().manual_seed(args.seed)
    init = parts = None
    out = []
    for dev in devices:
        model, fed, train, data, w, _ = setup_ehealth(args, dev)
        runner, eff_fed = make_runner(args.algorithm, model, fed, train)
        if init is None:
            init = model.init(gen)
            parts = torch.stack([F.sample_participants(gen, eff_fed)
                                 for _ in range(PARITY_ROUNDS * eff_fed.lam)])
        state = init_state(torch.Generator(), model, eff_fed, data,
                           params=tree_map(lambda t: t.to(dev), init))
        _, losses = runner.run(state, data, w, PARITY_ROUNDS, participants=parts)
        out.append(losses.cpu())
    return out


def run_pop(argv):
    """``run_population_cli`` on ``argv``, its stdout echoed: (report, result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, res = run_population_cli(parse_args(argv))
    print(f"[population] {json.dumps(out)}")
    return out, res


def state_tensors(state):
    """Every tensor of an HSGDState."""
    return [t for part in (state.theta0, state.theta1, state.theta2, state.stale, state.batch)
            for t in tree_leaves(part)]


def same_state(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(state_tensors(a), state_tensors(b)))


@contextlib.contextmanager
def kept_messages(limit=None):
    """Yield a list that collects every message a run hands the compress
    kernel (the first ``limit`` of them, if given), as (x, k, levels,
    row_len, dp...) by reference: each is a fresh tensor the path never
    writes again. The kernel's wrapper still launches, and counts, every
    call."""
    launch, kept = compress_kernels.fused_compress, []

    def keep(x, k, levels=0, row_len=None, *dp):
        if limit is None or len(kept) < limit:
            kept.append((x, k, levels, row_len) + dp)
        return launch(x, k, levels, row_len, *dp)

    compress_kernels.fused_compress = keep
    try:
        yield kept
    finally:
        compress_kernels.fused_compress = launch


def check_path_messages(tag, kept, exact: bool):
    """The compress kernel against its plain version on every message a run
    handed it. ``exact``: torch.equal on each; else NaN is allowed where
    both versions give NaN (same_values), and the rows whose whole valid
    prefix is non-finite are counted. Returns the largest |difference|."""
    shapes, nonfinite, whole, err = set(), 0, 0, 0.0
    for x, k, lv, ln, *dp in kept:
        got = fused_compress(x, k, lv, ln, *dp)
        want = compress_rows_ref(x, k, lv, ln, *dp)
        torch.cuda.synchronize()
        same = torch.equal(got, want) if exact else same_values(got, want)
        check(same, f"{tag}: kernel differs from plain on a path message of shape "
                    f"{tuple(x.shape)}")
        both = torch.isfinite(got) & torch.isfinite(want)
        if bool(both.any()):
            err = max(err, float((got - want)[both].abs().max()))
        valid = torch.arange(x.shape[1], device=x.device) < ln[:, None]
        bad = valid & ~torch.isfinite(x)
        nonfinite += int(bad.any(dim=1).sum())
        whole += int(((bad | ~valid).all(dim=1) & (ln > 0)).sum())
        shapes.add(tuple(x.shape))
    print(f"[kernel] {tag}: {len(kept)} messages of shapes {sorted(shapes)}: kernel "
          f"{'torch.equal to' if exact else 'equal (NaN where both are NaN) to'} plain; rows "
          f"with a non-finite value {nonfinite}, of them wholly non-finite {whole}")
    return err


def check_population_paths(device, bw, flops, floor_ms):
    """Phase 3f: sync and semi_async at full width through the CLI, the
    kernel held bit for bit against plain on every cohort message they gave
    it; returns ({mode: (steps/s, simulated seconds, compress launches)},
    the first cohort message's comparison, the largest difference)."""
    lam = parse_args(POP_ARGV).p // parse_args(POP_ARGV).q
    stats, timed, err = {}, None, 0.0
    for mode in ("sync", "semi_async"):
        argv = POP_ARGV + ["--population", mode, "--device", "cuda", "--rounds", str(POP_ROUNDS)]
        with kept_messages() as kept:
            reset_launch_counts()
            out, res = run_pop(argv)
            torch.cuda.synchronize()
            counts = dict(launch_counts)
        buckets = sorted({h["bucket"] for h in res["history"]})
        losses = res["losses"]
        print(f"[population-{mode}] launches={counts} buckets={buckets} "
              f"executors={out['executors_compiled']} steps/s={out['steps'] / out['wall_s']} "
              f"wall_s={out['wall_s']} sim_seconds={out['sim_seconds']} "
              f"cohort sizes={[h['cohort_sizes'] for h in res['history'][:2]]}...")
        check(counts == {"fused_compress": POP_ROUNDS * lam},
              f"{mode}: launches {counts}, expected {POP_ROUNDS * lam} compress launches")
        check(len(kept) == POP_ROUNDS * lam, f"{mode}: {len(kept)} messages kept")
        check(out["executors_compiled"] == len(buckets),
              f"{mode}: {out['executors_compiled']} executors for buckets {buckets}")
        check(np.isfinite(losses).all(), f"{mode}: non-finite loss")
        first, last = float(losses[:4].mean()), float(losses[-4:].mean())
        check(last < first, f"{mode}: loss did not fall: first-4 {first}, last-4 {last}")
        stats[mode] = (out["steps"] / out["wall_s"], out["sim_seconds"], counts["fused_compress"])
        err = max(err, check_path_messages(f"{mode} cohort messages", kept, exact=True))
        if timed is None:
            x, k, lv, ln = kept[0][:4]  # the cohort path has no DP operands
            timed = compare_compress(f"cohort message A={buckets[0]}", x, k, ln, lv, bw, flops,
                                     floor_ms)
        del kept
    return stats, timed, err


def _screen_only(theta2, pmask, trust, method="mean", trim_frac=0.1, agg_masks=None):
    """The screened executor's eq. (1) with the robust center left out: the
    masked mean, which is what every slot trusted gives."""
    return F.local_aggregate(theta2, pmask)


def _host_branch(robust):
    """``robust`` behind a host branch, as the reference's lax.cond: the
    center only when a group has a flagged slot and a survivor, at one
    device-to-host copy an aggregation."""
    def agg(theta2, pmask, trust, method="mean", trim_frac=0.1, agg_masks=None):
        cnt = torch.sum(pmask * trust, dim=1)
        flagged = torch.sum(pmask * (1.0 - trust), dim=1)
        if bool(((flagged > 0) & (cnt > 0)).any()):
            return robust(theta2, pmask, trust, method, trim_frac, agg_masks)
        return F.local_aggregate(theta2, pmask)
    return agg


# the fault-free defense timing: executors, and turns of POP_ROUNDS rounds
# each, run in alternating order (forward, backward, ...)
DEFENSE_VARIANTS = ("plain", "screen-only", "host-branch", "mean", "median", "trimmed")
DEFENSE_TURNS = 4


def defense_overhead(device):
    """Phase 3g, first half: what the defense costs on fault-free rounds.
    On one full-width cohort, POP_ROUNDS rounds a run from one initial
    model, DEFENSE_TURNS runs of each executor in alternating order: the
    plain cohort executor; the screened one (fault terms all zero) with the
    robust center always computed as ``--robust-agg mean``, ``median`` and
    ``trimmed``; the screened one with the center left out (``screen-only``:
    the screen's own cost); and with the center behind a host branch
    (``host-branch``: the reference's ``lax.cond``). Every screened run's
    parameters and losses must equal the plain run's (torch.equal).
    Returns {variant: mean steps/s}."""
    args = parse_args(POP_ARGV + ["--population", "semi_async", "--device", "cuda"])
    model, fed, train, data, w, _ = setup_ehealth(args, device)
    pop = PopulationConfig(seed=args.seed, devices_per_group=args.pop_devices,
                           target_cohort=args.cohort)
    cohort = DeviceRegistry(data, pop).sample_cohort(0, 0.0)
    M, A = cohort.pmask.shape
    init = tree_map(lambda t: t.to(device), model.init(torch.Generator().manual_seed(args.seed)))
    w = w.cpu().numpy()
    clean = (np.zeros((M, A), np.float32), np.zeros(M, np.float32))
    robust = F.robust_local_aggregate

    def screened(method, agg=robust):
        runner = HSGDRunner(model, dataclasses.replace(fed, robust_agg=method), train)
        return runner.fault_round_fn(args.p, args.q, A, robust=True), clean, agg

    fns = {"plain": (HSGDRunner(model, fed, train).cohort_round_fn(args.p, args.q, A,
                                                                   collect_stats=False),
                     (), robust),
           "screen-only": screened("mean", _screen_only),
           "host-branch": screened("mean", _host_branch(robust)),
           **{m: screened(m) for m in ("mean", "median", "trimmed")}}

    def rounds(name, n):
        fn, faults, agg = fns[name]
        state = resize_cohort(init_state(torch.Generator(), model, fed, data, params=init),
                              model, data, A)
        losses = []
        F.robust_local_aggregate = agg
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                state, loss, *_ = fn(state, data, w, args.lr, cohort.idx, cohort.pmask, *faults)
                losses.append(loss)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            F.robust_local_aggregate = robust
        return state, torch.cat(losses), n * args.p / seconds

    for name in DEFENSE_VARIANTS:  # warm-up
        rounds(name, 1)
    sps = {name: [] for name in DEFENSE_VARIANTS}
    ref = None
    for turn in range(DEFENSE_TURNS):
        for name in DEFENSE_VARIANTS[::1 if turn % 2 == 0 else -1]:
            state, losses, rate = rounds(name, POP_ROUNDS)
            sps[name].append(rate)
            if ref is None:
                ref = (state, losses)
            check(same_state(ref[0], state) and torch.equal(ref[1], losses),
                  f"fault-free {name} rounds differ from the plain cohort rounds")
    mean = {name: float(np.mean(r)) for name, r in sps.items()}
    for name in DEFENSE_VARIANTS:
        print(f"[defense] {name}: steps/s={sps[name]} mean={mean[name]} "
              f"min={min(sps[name])} max={max(sps[name])} of plain={mean[name] / mean['plain']} "
              f"overhead={1.0 - mean[name] / mean['plain']}")
    print(f"[defense] fault-free rounds at A={A}, {POP_ROUNDS} rounds a run, "
          f"{DEFENSE_TURNS} runs each in alternating order; every screened run's parameters "
          f"and losses equal the plain run's (torch.equal); the robust center's share "
          f"(always computed, of plain) mean={(mean['screen-only'] - mean['mean']) / mean['plain']} "
          f"median={(mean['screen-only'] - mean['median']) / mean['plain']} "
          f"trimmed={(mean['screen-only'] - mean['trimmed']) / mean['plain']}")
    return mean


def check_fault_paths(device):
    """Phase 3g, second half: the resilient runtime through the CLI, robust
    and naive, the kernel held against plain on every message they gave it
    (the naive run's include a diverged model's non-finite rows); then a
    preemption and its resume. Returns the robust run's report, its
    compress launches and the largest difference."""
    lam = parse_args(POP_ARGV).p // parse_args(POP_ARGV).q
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    base = POP_ARGV + ["--population", "semi_async", "--device", "cuda",
                       "--rounds", str(POP_ROUNDS)] + FAULT_ARGV
    runs, err = {}, 0.0
    for name, extra in (("robust", []), ("naive", ["--no-defense"])):
        with kept_messages() as kept:
            reset_launch_counts()
            out, res = run_pop(base + extra + ["--checkpoint", str(CKPT_DIR / name)])
            torch.cuda.synchronize()
            counts = dict(launch_counts)
        executed = len(res["fault_log"])
        rolled = sum(1 for r in res["fault_log"] if r.get("rolled_back"))
        print(f"[faults-{name}] launches={counts} executed rounds={executed} "
              f"(rolled back {rolled}) steps/s={out['steps'] / out['wall_s']} "
              f"recovered={out['recovered']} flagged={out['updates_flagged']} "
              f"rollbacks={out['rollbacks']} dropped={out['devices_dropped']} "
              f"grad_faults={out['grad_faults']} msg_faults={out['msg_faults']}")
        check(counts == {"fused_compress": executed * lam},
              f"{name}: launches {counts}, expected executed rounds x Λ = {executed * lam}")
        check(len(kept) == executed * lam, f"{name}: {len(kept)} messages kept")
        err = max(err, check_path_messages(f"faults-{name} messages", kept, exact=False))
        del kept
        runs[name] = (out, res, counts)
    out, res, counts = runs["robust"]
    check(out["recovered"] and out["updates_flagged"] > 0,
          f"robust run: recovered={out['recovered']} flagged={out['updates_flagged']}")
    preempt = base + ["--checkpoint", str(CKPT_DIR / "preempt"), "--preempt-round", "3"]
    try:
        run_pop(preempt)
        check(False, "--preempt-round 3 did not raise")
    except CoordinatorPreempted as e:
        check(e.round_idx == 3, f"preempted at round {e.round_idx}, expected 3")
        print(f"[faults-preempt] raised CoordinatorPreempted at round {e.round_idx}")
    out_r, res_r = run_pop(preempt + ["--resume"])
    check(np.array_equal(res_r["losses"], res["losses"], equal_nan=True),
          "resumed losses differ from the uninterrupted run's")
    check(same_state(res_r["state"], res["state"]),
          "resumed parameters differ from the uninterrupted run's (torch.equal)")
    print(f"[faults-resume] resumed run equal to the uninterrupted one: {len(res_r['losses'])} "
          f"losses and every state tensor (torch.equal)")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out, counts, err


def check_adaptive_population_and_quickstart(device):
    """Phase 3h: --population adaptive, and the quickstart twin on the card."""
    reset_launch_counts()
    out, res = run_pop(POP_ARGV + ["--population", "adaptive", "--device", "cuda",
                                   "--rounds", str(POP_ROUNDS)])
    torch.cuda.synchronize()
    hist = res["history"]
    want = sum(h["P"] // h["Q"] for h in hist if h["compression_k"] or h["quant_levels"])
    print(f"[population-adaptive] launches={dict(launch_counts)} rounds={len(hist)} "
          f"plans={[(h['P'], h['Q'], h['rung']) for h in hist]} "
          f"executors={out['executors_compiled']} steps/s={out['steps'] / out['wall_s']} "
          f"sim_seconds={out['sim_seconds']}")
    check(dict(launch_counts) == {"fused_compress": want},
          f"adaptive population launches {dict(launch_counts)}, expected {want}")
    check(np.isfinite(res["losses"]).all(), "adaptive population: non-finite loss")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        metrics = quickstart.main(["--device", "cuda"])  # raises unless auc_roc > 0.6
    print(buf.getvalue(), end="")
    print(f"[quickstart] on the card: auc_roc={metrics['auc_roc']}")
    return out


def same_start_population(*devices):
    """PARITY_ROUNDS semi_async rounds at full width on each device from one
    CPU-drawn initial model: (losses, round records) per device."""
    args = parse_args(POP_ARGV + ["--population", "semi_async"])
    init = None
    out = []
    for dev in devices:
        model, fed, train, data, _, _ = setup_ehealth(args, dev)
        if init is None:
            init = model.init(torch.Generator().manual_seed(args.seed))
        res = population_rounds(args, model, fed, train, data, PARITY_ROUNDS,
                                params=tree_map(lambda t: t.to(dev), init))
        out.append((torch.from_numpy(res["losses"]), res["history"]))
    return out


def check_head_rows(device, bw, flops, dp: bool, shape=HEAD_SHAPE):
    """Phases 2 and 2b at an LLM message's widest group, the head's rows
    ``shape`` (k = 25%, b = 128; gemma3-1b's by default): the kernel against
    plain (torch.equal), timed beside its bound; the plain version is timed
    over fewer replays (one call at gemma3-1b's moves ~100 GB)."""
    g = torch.Generator(device=device).manual_seed(3)
    rows, n = shape
    mat = torch.randn(shape, generator=g, device=device) * 0.02
    k_rows = torch.full((rows,), round(0.25 * n), dtype=torch.int32, device=device)
    len_rows = torch.full((rows,), n, dtype=torch.int32, device=device)
    dp_args = dp_operands(mat, 1.0, 1.0) if dp else ()
    got = fused_compress(mat, k_rows, 128, len_rows, *dp_args)
    want = compress_rows_ref(mat, k_rows, 128, len_rows, *dp_args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tag = f"{'DP ' if dp else ''}LLM head rows {shape}"
    check(torch.equal(got, want), f"{tag}: kernel differs from plain (max |diff| {err})")
    del got, want
    ms = device_ms(lambda: fused_compress(mat, k_rows, 128, len_rows, *dp_args), inner=2, reps=7)
    plain_ms = device_ms(lambda: compress_rows_ref(mat, k_rows, 128, len_rows, *dp_args),
                         inner=1, reps=3)
    bound, bound_by = compress_bound_ms(mat, len_rows, 128, bw, flops, dp)
    body = "wide body, one block a row" if n > SMEM_ROW_FLOATS else "shared-memory body"
    print(f"[kernel] {tag} levels=128 k=25%: bit-identical ({body}) "
          f"kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound} ({bound_by}) "
          f"bound/kernel={bound / ms} library_ms=null")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by}


@contextlib.contextmanager
def checked_groups(bw, flops):
    """Hold every row group a run hands the compress kernel against the plain
    version as it is made (torch.equal), then drop it: yields a list of
    (shape, kernel ms from CUDA events around the launch, bound ms). The
    kernel's wrapper still launches, and counts, every call."""
    launch, seen = compress_kernels.fused_compress, []

    def check_now(x, k, levels=0, row_len=None, *dp):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch(x, k, levels, row_len, *dp)
        b.record()
        want = compress_rows_ref(x, k, levels, row_len, *dp)
        same = torch.equal(out, want)
        check(same, f"an LLM exchange group of shape {tuple(x.shape)}: kernel differs from plain")
        dp_on = bool(dp) and dp[-1] is not None
        bound, _ = compress_bound_ms(x, row_len, levels, bw, flops, dp_on)
        seen.append((tuple(x.shape), a.elapsed_time(b), bound))
        return out

    compress_kernels.fused_compress = check_now
    try:
        yield seen
    finally:
        compress_kernels.fused_compress = launch


def compressing_exchanges(args, rounds) -> int:
    """Exchanges of an LLM run that compress: rounds × Λ on the fixed path;
    on the adaptive path (Λ = 1: P = Q) its rounds whose rung compresses."""
    if not args.adaptive:
        return (args.steps // args.p) * (args.p // args.q)
    ladder = ladder_from(args.compression_k, args.quantization)
    return sum(1 for _, rung in rounds if any(ladder[rung]))


def interval_falls(args, rounds, losses):
    """(loss at the first step, at the last step) of every exchange interval
    of two or more steps: the steps of one interval train on one batch, so
    the loss falls within it, while a fresh batch of 128 tokens drawn from
    a vocabulary of 262 144 need not score better than the last one."""
    lengths = [args.q] * (len(losses) // args.q) if not args.adaptive else [p for p, _ in rounds]
    out, t = [], 0
    for n in lengths:
        if n >= 2:
            out.append((float(losses[t]), float(losses[t + n - 1])))
        t += n
    return out


def check_llm_paths(device, bw, flops):
    """Phase 3i: the LLM-scale federation at gemma3-1b's published widths,
    fixed (--pods 2) and adaptive (one pod), through the CLI. Each command
    runs twice: once as it is (launch counts, executors, steps/s, peak
    memory, finite losses), once with every row group held against plain
    as it is made and each launch timed. Returns the report lines."""
    summary = {}
    for tag, argv in (("fixed", LLM_FIXED_ARGV), ("adaptive", LLM_ADAPTIVE_ARGV)):
        argv = argv + ["--device", "cuda"]
        args = parse_args(argv)
        reset_launch_counts()
        out, losses, rounds = run_cli(argv, run_llm)
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        buckets = len(set(rounds)) if args.adaptive else 1
        want = compressing_exchanges(args, rounds) * LLM_GROUPS
        print(f"[llm-{tag}] launches={counts} (expected {want // LLM_GROUPS} compressing "
              f"exchanges x "
              f"{LLM_GROUPS} groups) steps/s={out['steps'] / out['wall_s']} "
              f"wall_s={out['wall_s']} peak_device_bytes={out['peak_device_bytes']} "
              f"peak_device_GiB={out['peak_device_bytes'] / 2 ** 30} "
              f"executors={out['executors_compiled']} rounds={rounds}")
        check(counts == {"fused_compress": want}, f"LLM {tag}: launches {counts}, expected {want}")
        check(out["executors_compiled"] == buckets,
              f"LLM {tag}: {out['executors_compiled']} executors for {buckets} buckets")
        check(np.isfinite(losses).all(), f"LLM {tag}: non-finite loss")
        falls = interval_falls(args, rounds, losses)
        print(f"[llm-{tag}] losses={losses.tolist()} (first, last) step of each exchange "
              f"interval: {falls}")
        check(falls and all(last < first for first, last in falls),
              f"LLM {tag}: the loss did not fall within every exchange interval: {falls}")
        with checked_groups(bw, flops) as seen:
            _, _, rounds2 = run_cli(argv, run_llm)
            torch.cuda.synchronize()
        check(len(seen) == compressing_exchanges(args, rounds2) * LLM_GROUPS,
              f"LLM {tag}: {len(seen)} groups checked")
        by_shape = {}
        for shape, ms, bound in seen:
            by_shape.setdefault(shape, ([], bound))[0].append(ms)
        for shape, (times, bound) in sorted(by_shape.items()):
            print(f"[llm-{tag}] group {list(shape)}: {len(times)} launches, each held "
                  f"torch.equal to plain; kernel ms (CUDA events around the launch) median "
                  f"{float(np.median(times))} min {min(times)} bound_ms {bound} "
                  f"bound/kernel {bound / float(np.median(times))}")
        summary[tag] = {"steps_per_s": out["steps"] / out["wall_s"],
                        "peak_device_bytes": out["peak_device_bytes"],
                        "launches": counts["fused_compress"],
                        "groups_ms": {str(list(k)): float(np.median(v[0]))
                                      for k, v in by_shape.items()},
                        "loss_first": out["loss_first"], "loss_last": out["loss_last"]}
        torch.cuda.empty_cache()
    return summary


def same_start_llm(*devices, arch="gemma3-1b"):
    """PARITY_ROUNDS fixed-cadence rounds of the LLM path at ``arch``'s
    smoke widths (--pods 2, k = 0.25, b = 128) on each device from one
    CPU-drawn model and the same token stream: the losses per device."""
    args = parse_args(["--arch", arch, "--smoke", "--pods", "2", "--compression-k",
                       "0.25", "--quantization", "128", "--device", "cpu"])
    cfg, model, init, _ = build_llm(args, torch.device("cpu"))
    out = []
    for dev in devices:
        bf = llm_batch_fn(cfg, args.batch, args.seq, n_pods=args.pods, seed=args.seed, device=dev)
        _, losses = LLMRoundRunner(model, n_pods=args.pods).run_fixed(
            tree_map(lambda t: t.to(dev, copy=True), init), bf, PARITY_ROUNDS * args.p, args.p,
            args.q, args.lr, args.compression_k, args.quantization)
        out.append(torch.from_numpy(losses))
    return out


def train_launches(args, layers: int, groups: int):
    """The launches of a fixed-cadence LLM run at --batch 2 --seq 64 with one
    tower layer a side (``llm_hybrid(n_tower=1)``), from launch/steps.py's
    structure. Every exchange compresses the message with one launch a row
    group. With ``layers`` Mamba layers in θ0 (the ssm and hybrid families,
    whose towers are one Mamba layer each), every pod-step runs the
    hospital's pass (θ0 and tower 1) and the device's (θ0 and tower 2),
    each a forward then a backward through ``layers`` + 1 Mamba layers, one
    scan chunk a layer (θ0's 64 tokens and a tower's 32 are one chunk of at
    most 256): a scan and a backward scan launch a layer and pass; every
    exchange also runs both towers without grad on each pod (one scan
    launch each). With none (whisper: dense towers) nothing else launches."""
    exchanges = (args.steps // args.p) * (args.p // args.q)
    out = {"fused_compress": groups * exchanges}
    if layers:
        per_step = 2 * (layers + 1) * args.steps * args.pods
        out.update(ssm_scan=per_step + 2 * args.pods * exchanges, ssm_scan_bwd=per_step)
    return out


@contextlib.contextmanager
def exchange_groups():
    """Yield a list that gets the row-group count (``row_groups`` of its
    leaves) of every message the LLM path hands ``compress_pytree``, read
    from the message as the run built it."""
    compress, counts = llm_steps.compress_pytree, []

    def count(tree, *args, **kwargs):
        counts.append(len(compress_kernels.row_groups(tree_leaves(tree))))
        return compress(tree, *args, **kwargs)

    llm_steps.compress_pytree = count
    try:
        yield counts
    finally:
        llm_steps.compress_pytree = compress


def busy_share(run):
    """(device busy share, kernels a step, wall seconds, the 8 kernels with
    the most device time and their ms) of ``run()``, which returns its
    steps: timed on the host clock, then run again under torch.profiler,
    whose Chrome trace gives the union of the device's kernel, copy and
    memset intervals (``launch/profile_train.py``'s reading); the share is
    that union over the unprofiled wall time."""
    t0 = time.perf_counter()
    steps = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        intervals = profile_train.device_intervals(path)
    busy = profile_train.busy_us(intervals) / 1e6
    kernels = sum(1 for cat, *_ in intervals if cat == "kernel")
    by_name = {}
    for _, kname, _, dur in intervals:
        by_name[kname[:80]] = by_name.get(kname[:80], 0.0) + dur / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return busy / wall, kernels / steps, wall, top


def check_train_cell(tag, device, args, cell, model=None, params=None, batch_fn=None,
                     cli_argv=None, hold_messages=False):
    """Phases 3n, 3o and 3q: fixed rounds of ``model`` at ``args``' cadence
    on the card, the launch counters zeroed just before and read just
    after: exactly the launches ``cell`` (an entry of TRAIN_CELLS) pins and
    no other kernel (no flash), every exchange message of the row groups it
    pins (read from the message as the run built it); finite losses
    falling within every exchange interval; steps/s, peak device memory.
    Through the CLI on ``cli_argv`` when it is given (the CLI's seed then
    draws the weights again afterwards), else through
    ``LLMRoundRunner.run_fixed``. With ``hold_messages``, one more round
    keeps its first exchange's row groups and holds the kernel against
    plain on each (torch.equal), apart from the measured run so that the
    kept copies add nothing to its peak. Then one more round, timed and
    profiled, for the busy share."""
    layers, groups, pinned = cell
    want = train_launches(args, layers, groups)
    check(want == pinned, f"{tag}: launches derived {want}, pinned {pinned}")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with exchange_groups() as per_exchange:
        if cli_argv is not None:
            out, losses, _ = run_cli(cli_argv, run_llm)
            torch.cuda.synchronize()
            steps, wall_s = out["steps"], out["wall_s"]
            peak = torch.cuda.max_memory_allocated()  # the CLI reset it after drawing the weights
        else:
            t0 = time.perf_counter()
            params, losses = LLMRoundRunner(model, n_pods=args.pods).run_fixed(
                params, batch_fn, args.steps, args.p, args.q, args.lr, args.compression_k,
                args.quantization)
            torch.cuda.synchronize()
            steps, wall_s = len(losses), time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
    counts = dict(launch_counts)
    if cli_argv is not None:
        _, model, params, batch_fn = build_llm(args, device)
    falls = interval_falls(args, None, losses)
    print(f"[{tag}] launches={counts} (pinned {pinned}) row groups by exchange={per_exchange} "
          f"steps={steps} wall_s={wall_s} "
          f"steps/s={steps / wall_s} peak_device_bytes={peak} peak_device_GiB={peak / 2 ** 30} "
          f"allocated before the run={before} losses={losses.tolist()} (first, last) step of "
          f"each exchange interval: {falls}")
    check(counts == pinned, f"{tag}: launches {counts}, expected {pinned} and no other kernel")
    exchanges = pinned["fused_compress"] // groups
    check(per_exchange == [groups] * exchanges,
          f"{tag}: row groups by exchange {per_exchange}, pinned {groups} in each of {exchanges}")
    check(bool(np.isfinite(losses).all()), f"{tag}: non-finite loss")
    check(falls and all(last < first for first, last in falls),
          f"{tag}: the loss did not fall within every exchange interval: {falls}")
    fn = LLMRoundRunner(model, n_pods=args.pods).round_fn(
        args.p, args.q, args.compression_k, args.quantization, collect_stats=False)
    lam = args.p // args.q
    state = {"params": params}
    msg_err = None
    if hold_messages:
        with kept_messages(limit=groups) as kept:
            state["params"], _ = fn(state["params"], batch_fn(0, lam), args.lr)
            torch.cuda.synchronize()
        check(len(kept) == groups, f"{tag}: {len(kept)} row groups kept, {groups} pinned")
        msg_err = check_path_messages(f"{tag} messages", kept, exact=True)
        del kept
        torch.cuda.empty_cache()

    def one_round():
        state["params"], _ = fn(state["params"], batch_fn(0, lam), args.lr)
        return args.p

    busy, kernels, round_s, top = busy_share(one_round)
    print(f"[{tag}] one more round: {round_s} s ({args.p / round_s} steps/s), device busy "
          f"share {busy}, {kernels} kernels a step; device ms of the profiled round by kernel: "
          f"{top}")
    del state, params
    return {"steps_per_s": steps / wall_s, "peak_device_bytes": peak, "busy_share": busy,
            "kernels_per_step": kernels, "launches": counts, "messages_max_abs_err": msg_err,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


def check_ssm_training(device):
    """Phases 3n (zamba2-2.7b at full width through the CLI) and 3o
    (falcon-mamba-7b at its published widths, depth cut to
    FALCON_TRAIN_LAYERS, through ``LLMRoundRunner`` as the CLI builds it)."""
    summary = {}
    argv = ["--arch", HYBRID_ARCH] + TRAIN_ARGV + ["--device", "cuda"]
    summary[HYBRID_ARCH] = check_train_cell("train-hybrid", device, parse_args(argv),
                                            TRAIN_CELLS[HYBRID_ARCH], cli_argv=argv)
    torch.cuda.empty_cache()
    arch = "falcon-mamba-7b"
    args = parse_args(["--arch", arch] + TRAIN_ARGV + ["--device", "cuda"])
    cfg = get_config(arch).replace(num_layers=FALCON_TRAIN_LAYERS)
    model = llm_hybrid(cfg, n_tower=1, remat=False)
    params = init_llm_params(torch.Generator(device=device).manual_seed(args.seed), model,
                             n_pods=args.pods)
    batch_fn = llm_batch_fn(cfg, args.batch, args.seq, n_pods=args.pods, seed=args.seed,
                            device=device)
    summary[arch] = check_train_cell("train-ssm", device, args, TRAIN_CELLS[arch], model, params,
                                     batch_fn)
    del params
    torch.cuda.empty_cache()
    return summary


@contextlib.contextmanager
def encoder_spans():
    """Yield a list that gets, for every ``T.seed_audio_caches`` call of a
    run (the encoder and the cross K/V projection of a first prefill
    block), the CUDA events recorded on the stream just before and just
    after it; their elapsed time is the span of the prefill's device
    timeline the encoder took. Read them after a synchronize."""
    seed, spans = T.seed_audio_caches, []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = seed(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    T.seed_audio_caches = timed
    try:
        yield spans
    finally:
        T.seed_audio_caches = seed


def check_audio_serving(device):
    """Phase 3p: whisper-medium through the serve CLI at full width, with
    fp32 and then int8 caches, the launch counters zeroed just before and
    read just after: no kernel of the port, 4 x 32 tokens in [0, V),
    prefill seconds, the encoder's share of them, ms a decode step, peak
    device memory. Then 5 requests through 2 slots, each with its own
    frames: every request's tokens equal ``sequential_generate``'s."""
    cfg = get_config(AUDIO_ARCH)
    out = {}
    for cache in ("f32", "int8"):
        argv = AUDIO_SERVE_ARGV + ["--cache-dtype", cache]
        args = serve.parse_args(argv)
        torch.cuda.empty_cache()
        reset_launch_counts()
        with encoder_spans() as spans:
            report, tokens = run_serve_cli(argv)
            torch.cuda.synchronize()
        counts = dict(launch_counts)
        del report["requests"]
        enc_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
        check(len(spans) == 1, f"audio serving ({cache}): the encoder ran {len(spans)} times")
        print(f"[serve-audio] cache={cache} launches={counts} prefill_s={report['prefill_s']} "
              f"encoder_s={enc_s} (the encoder and the cross K/V of {args.batch} x "
              f"{cfg.encoder_seq} frames, CUDA events around them inside this prefill) "
              f"encoder_share={enc_s / report['prefill_s']} "
              f"ms_per_decode_step={report['ms_per_decode_step']} "
              f"decode_tok_per_s={report['decode_tok_per_s']} "
              f"executors={report['compiled_executors']} "
              f"peak_device_bytes={report['peak_device_bytes']} "
              f"peak_device_GiB={report['peak_device_bytes'] / 2 ** 30} "
              f"init_s={report['init_s']} (weights of {cfg.param_count()} params drawn on the "
              f"card)")
        check(counts == {}, f"audio serving ({cache}): launches {counts}, expected no kernel of "
                            f"the port (no flash at a 448-token context, no scan)")
        check(report["generated_tokens"] == args.batch * args.gen,
              f"audio serving ({cache}): generated {report['generated_tokens']} tokens")
        check(len(tokens) == args.batch and all(
            len(t) == args.gen and all(0 <= x < cfg.vocab_size for x in t) for t in tokens),
            f"audio serving ({cache}): tokens out of [0, V)")
        out[cache] = {k: report[k] for k in ("prefill_s", "ms_per_decode_step",
                                             "decode_tok_per_s", "peak_device_bytes")}
        out[cache].update(encoder_s=enc_s, encoder_share=enc_s / report["prefill_s"])
        del report, tokens
    params, _, _ = serve.build_inputs(cfg, args.batch, args.prompt_len, args.seed, device)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n, _ in AUDIO_REQUESTS]
    frames = rng.randn(len(prompts), cfg.encoder_seq, cfg.d_model).astype(np.float32)
    engine = ServeEngine(cfg, params, max_batch=2, cache_dtype=torch.float32, decode_block=4)
    rids = [engine.submit(p, n, f) for p, (_, n), f in zip(prompts, AUDIO_REQUESTS, frames)]
    t0 = time.perf_counter()
    reset_launch_counts()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_id = {r.rid: r.tokens for r in engine.done}
    got = [by_id[r] for r in rids]
    t0 = time.perf_counter()
    want = [sequential_generate(cfg, params, p[None], n, extra_embeds=f[None])[0].tolist()
            for p, (_, n), f in zip(prompts, AUDIO_REQUESTS, frames)]
    seq_s = time.perf_counter() - t0
    print(f"[serve-audio] {len(prompts)} requests (lengths, new tokens) {list(AUDIO_REQUESTS)} "
          f"through 2 slots, each with its own frames: engine {wall} s, executors "
          f"{engine.compile_counts()}, launches {dict(launch_counts)}; sequential_generate "
          f"{seq_s} s; tokens {got}")
    check(not launch_counts, f"audio serving: the 5-request run launched {dict(launch_counts)}")
    check_same_tokens("serve-audio-slots", cfg, params, prompts, want, got, frames)
    out["slots"] = {"engine_s": wall, "sequential_s": seq_s,
                    "executors": engine.compile_counts()}
    del engine, params
    torch.cuda.empty_cache()
    return out


def check_audio_training(device):
    """Phase 3q: whisper-medium training at full width through the CLI
    (``check_train_cell`` on TRAIN_CELLS' pins), the kernel held against
    plain on one exchange's four row groups at the path's own shapes."""
    argv = ["--arch", AUDIO_ARCH] + TRAIN_ARGV + ["--device", "cuda"]
    out = check_train_cell("train-audio", device, parse_args(argv), TRAIN_CELLS[AUDIO_ARCH],
                           cli_argv=argv, hold_messages=True)
    torch.cuda.empty_cache()
    return out


def check_example_twins(device):
    """Phase 3r: the twins of ``examples/train_100m_hsgd.py`` (adaptive, then
    --fixed --q 4, 20 steps each) and ``examples/serve_batched.py`` on the
    card, the launch counters zeroed before each and read after."""
    out = {}
    for tag, argv in (("adaptive", ["--steps", "20"]),
                      ("fixed", ["--fixed", "--q", "4", "--steps", "20"])):
        reset_launch_counts()
        res = train_100m_hsgd.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        losses = res["losses"]
        print(f"[example-100m-{tag}] steps={len(losses)} steps/s={res['steps_per_s']} "
              f"wall_s={res['wall_s']} launches={counts} loss {float(losses[0])} -> "
              f"{float(losses[-1])}")
        check(len(losses) == 20 and bool(np.isfinite(losses).all()),
              f"train_100m_hsgd {tag}: {len(losses)} steps, finite {np.isfinite(losses).all()}")
        out[tag] = {"steps_per_s": res["steps_per_s"], "launches": counts,
                    "rounds": None if res["history"] is None else len(res["history"])}
        del res
    torch.cuda.empty_cache()
    reset_launch_counts()
    res = serve_batched.main(["--device", "cuda"])
    torch.cuda.synchronize()
    load = res["load"]
    print(f"[example-serve] launches={dict(launch_counts)} requests={load['requests']} "
          f"tokens={load['generated_tokens']} sustained_tok_per_s="
          f"{load['sustained_tokens_per_s']} first_token p50/p99 s={load['first_token_s']} "
          f"serve tok/s={res['serve']['decode_tok_per_s']}")
    check(load["requests"] == 16 and load["generated_tokens"] == 16 * 8,
          f"serve_batched: {load['requests']} requests, {load['generated_tokens']} tokens")
    out["serve_batched"] = {"sustained_tokens_per_s": load["sustained_tokens_per_s"],
                            "first_token_s": load["first_token_s"]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    device = resolve_device("cuda")
    # -- phase 1: the card, versions, the build ---------------------------
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    bw, flops = card_rates(name)
    print(f"[card] {smi}")
    print(f"[versions] python={sys.version.split()[0]} torch={torch.__version__} "
          f"cuda={torch.version.cuda} devices={torch.cuda.device_count()}")
    t0 = time.perf_counter()
    sources = [src.stem for src in sorted(build.CSRC.glob("*.cu"))]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        seconds = dict(zip(sources, pool.map(build.build, sources)))
    print(f"[build] nvcc seconds per source: {seconds}; all: {time.perf_counter() - t0}")
    for src in seconds:
        print(f"[build] {src}: {build.build_log(src).strip()}")
    check_no_spills("flash_attention")
    check_no_spills("compress")

    # -- phase 2: kernel against plain, bit for bit -----------------------
    mat, k_rows, len_rows, levels = main_message(device)
    check(tuple(mat.shape) == (2900, 128), f"main-path message shape {tuple(mat.shape)}")
    check(sorted(set(len_rows.tolist())) == [11, 64, 128], "main-path widths")
    one = torch.zeros(1, device=device)
    floor_ms = device_ms(one.zero_)
    print(f"[kernel] launch floor: a one-element zero_() takes {floor_ms} ms (CUDA graph "
          f"replays, as every kernel time below)")
    main_cmp = compare_compress("main-path message", mat, k_rows, len_rows, levels, bw, flops,
                                floor_ms)
    max_err = main_cmp["max_abs_err"]
    check_nan_rows(mat, k_rows, len_rows, levels)
    for k_frac in (0.1, 0.25):
        big = large_ragged(device, k_frac)
        for lv in (0, 16, 128):
            res = compare_compress(f"large ragged k={k_frac}", *big, lv, bw, flops, floor_ms)
            max_err = max(max_err, res["max_abs_err"])
    check_edge_cases(device, dp=False)
    head_cmp = check_head_rows(device, bw, flops, dp=False)
    audio_head_cmp = check_head_rows(device, bw, flops, dp=False, shape=AUDIO_HEAD_SHAPE)

    # -- phase 2b: the DP kernel against plain, bit for bit ------------------
    main_dp, max_err_dp = check_dp_kernel(mat, k_rows, len_rows, levels, bw, flops, floor_ms)
    head_dp = check_head_rows(device, bw, flops, dp=True)
    max_err = max(max_err, head_cmp["max_abs_err"], audio_head_cmp["max_abs_err"])
    max_err_dp = max(max_err_dp, head_dp["max_abs_err"])

    # -- phase 2c: the flash-attention kernel against plain ------------------
    flash_main, max_err_flash = check_flash_kernel(device, name)

    # -- phase 2d: the scan kernel against plain, bit for bit ------------------
    scan_main, max_err_scan = check_scan_kernel(device, name)

    # -- phase 2e: the scan's backward kernel against plain, bit for bit ------
    scan_bwd_main, max_err_scan_bwd = check_scan_bwd_kernel(device, name)

    # -- phase 3: the main path -------------------------------------------
    args = parse_args(MAIN_ARGV + ["--device", "cuda", "--rounds", str(MAIN_ROUNDS)])
    reset_launch_counts()
    metrics, losses = run_ehealth(args)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    lam = args.p // args.q
    print(f"[main] launches={counts} steps/s={metrics['steps'] / metrics['wall_s']} "
          f"metrics={json.dumps(metrics)}")
    check(counts.get("fused_compress", 0) == MAIN_ROUNDS * lam,
          f"fused_compress launched {counts.get('fused_compress', 0)} times, "
          f"expected rounds x Λ = {MAIN_ROUNDS * lam}")
    check(all(math.isfinite(float(v)) for v in losses), "non-finite training loss")
    first, last = float(losses[:4].mean()), float(losses[-4:].mean())
    check(last < first, f"loss did not fall: first-4 mean {first}, last-4 mean {last}")
    check(metrics["steps"] == MAIN_ROUNDS * args.p, "step count")
    check(not counts.get("fused_compress_dp"), "the non-private path launched the DP kernel")

    # -- phase 3b: the fixed private path ------------------------------------
    argv = MAIN_ARGV + PRIVATE_ARGV + ["--device", "cuda", "--rounds", str(MAIN_ROUNDS)]
    reset_launch_counts()
    metrics, losses, _ = run_cli(argv)
    torch.cuda.synchronize()
    counts_dp = dict(launch_counts)
    print(f"[private] launches={counts_dp} steps/s={metrics['steps'] / metrics['wall_s']}")
    check(counts_dp.get("fused_compress_dp", 0) == MAIN_ROUNDS * lam and
          not counts_dp.get("fused_compress"),
          f"private path launches {counts_dp}, expected {MAIN_ROUNDS * lam} DP and no other")
    check(metrics["executors_compiled"] == 1, f"executors {metrics['executors_compiled']}")
    eps = epsilon_of(MAIN_ROUNDS * lam * gaussian_rho(1.0), 1e-5)
    check(abs(metrics["epsilon"] - eps) <= 1e-12 * eps, f"epsilon {metrics['epsilon']} != {eps}")
    check(all(math.isfinite(float(v)) for v in losses), "non-finite loss on the private path")
    check(metrics["steps"] == MAIN_ROUNDS * args.p, "private step count")

    # -- phase 3c: the adaptive path, with DP and without --------------------
    argv = MAIN_ARGV + ADAPTIVE_ARGV + ["--device", "cuda", "--rounds", str(MAIN_ROUNDS)]
    reset_launch_counts()
    metrics, losses, rounds = run_cli(argv)
    torch.cuda.synchronize()
    counts_ad = dict(launch_counts)
    print(f"[adaptive-dp] launches={counts_ad} rounds={rounds} "
          f"steps/s={metrics['steps'] / metrics['wall_s']}")
    check(len(rounds) == metrics["adaptive_rounds"] > 0, "adaptive round lines")
    check(counts_ad.get("fused_compress_dp", 0) == metrics["adaptive_rounds"]
          and not counts_ad.get("fused_compress"),
          f"adaptive DP launches {counts_ad}, expected one a round ({metrics['adaptive_rounds']})")
    check(metrics["epsilon"] <= 25.0, f"adaptive epsilon {metrics['epsilon']} over 25")
    check(metrics["executors_compiled"] == len(set(rounds)),
          f"executors {metrics['executors_compiled']} for buckets {sorted(set(rounds))}")
    check(all(math.isfinite(float(v)) for v in losses), "non-finite loss on the adaptive path")
    argv = MAIN_ARGV + ["--adaptive", "--device", "cuda", "--rounds", str(MAIN_ROUNDS)]
    reset_launch_counts()
    metrics, losses, rounds = run_cli(argv)
    torch.cuda.synchronize()
    print(f"[adaptive] launches={dict(launch_counts)} rounds={rounds}")
    check(launch_counts.get("fused_compress", 0) == metrics["adaptive_rounds"],
          "adaptive path: one compress launch a round")
    first, last = float(losses[:4].mean()), float(losses[-4:].mean())
    check(all(math.isfinite(float(v)) for v in losses) and last < first,
          f"adaptive loss did not fall: first-4 mean {first}, last-4 mean {last}")

    # -- phase 3f: the population runtime at full width -----------------------
    pop_stats, cohort_cmp, err = check_population_paths(device, bw, flops, floor_ms)
    max_err = max(max_err, err, cohort_cmp["max_abs_err"])

    # -- phase 3g: the defense's cost, faults, preemption and resume -----------
    defense_sps = defense_overhead(device)
    fault_out, fault_counts, err = check_fault_paths(device)
    max_err = max(max_err, err)

    # -- phase 3h: the adaptive population run and the quickstart twin ---------
    check_adaptive_population_and_quickstart(device)
    print(f"[population-summary] sync/semi_async (steps/s, sim s, compress launches)="
          f"{pop_stats} defense steps/s={defense_sps} "
          f"fault run compress launches={fault_counts}")

    # -- phase 3i: the LLM-scale federation at full width ----------------------
    llm_summary = check_llm_paths(device, bw, flops)
    print(f"[llm-summary] {json.dumps(llm_summary)}")

    # -- phase 3d: the serving path at full width -----------------------------
    print(f"[serve] allocated at phase 3d's start: {torch.cuda.memory_allocated()} bytes "
          f"(the script calls no gc.collect())")
    reset_launch_counts()
    report, tokens = run_serve_cli(SERVE_ARGV)
    torch.cuda.synchronize()
    counts_serve = dict(launch_counts)
    vocab = get_config("gemma3-1b").vocab_size
    print(f"[serve] launches={counts_serve} prefill_s={report['prefill_s']} "
          f"decode_tok_per_s={report['decode_tok_per_s']} first_token_s="
          f"{[r['first_token_s'] for r in report['requests']]} "
          f"executors={report['compiled_executors']} "
          f"peak_device_GiB={report['peak_device_bytes'] / 2 ** 30}")
    check(counts_serve == {"flash_attention": 26},
          f"serving path launches {counts_serve}, expected 26 flash launches and no other")
    check(report["generated_tokens"] == 2 * 32, f"generated {report['generated_tokens']} tokens")
    check(len(tokens) == 2 and all(len(t) == 32 and all(0 <= x < vocab for x in t)
                                   for t in tokens), "serving tokens out of [0, V)")
    plain_tokens = tokens

    # -- phase 3j: self-speculative decoding at full width ----------------------
    spec_summary = check_spec_serving(device, plain_tokens)
    print(f"[spec-summary] {json.dumps(spec_summary)}")

    # -- phase 3k: the load generator with the prefix cache --------------------
    load_summary = check_loadgen(device)
    print(f"[loadgen-summary] {json.dumps(load_summary)}")
    torch.cuda.empty_cache()

    # -- phase 3e: the ssm serving path at full width ------------------------
    reset_launch_counts()
    report, tokens = run_serve_cli(SSM_SERVE_ARGV)
    torch.cuda.synchronize()
    counts_ssm = dict(launch_counts)
    ssm_cfg = get_config("falcon-mamba-7b")
    ssm_args = serve.parse_args(SSM_SERVE_ARGV)
    gen, block = ssm_args.gen, ssm_args.decode_block
    decode_steps = block * math.ceil((gen - 1) / block)  # the prefill samples token 1
    want_prefill = ssm_cfg.num_layers * math.ceil(ssm_args.prompt_len / SSM_CHUNK)
    want = want_prefill + ssm_cfg.num_layers * decode_steps
    print(f"[serve-ssm] launches={counts_ssm} (prefill {want_prefill} + {ssm_cfg.num_layers} x "
          f"{decode_steps} decode steps) prefill_s={report['prefill_s']} "
          f"ms_per_decode_step={report['ms_per_decode_step']} "
          f"decode_tok_per_s={report['decode_tok_per_s']} first_token_s="
          f"{[r['first_token_s'] for r in report['requests']]} "
          f"executors={report['compiled_executors']} "
          f"peak_device_bytes={report['peak_device_bytes']} "
          f"peak_device_GiB={report['peak_device_bytes'] / 2 ** 30} "
          f"init_s={report['init_s']} (weights of {ssm_cfg.param_count()} params drawn on the card)")
    check(counts_ssm == {"ssm_scan": want},
          f"ssm serving path launches {counts_ssm}, expected {want} scan launches and no other")
    check(report["generated_tokens"] == 2 * gen, f"generated {report['generated_tokens']} tokens")
    check(len(tokens) == 2 and all(len(t) == gen and all(0 <= x < ssm_cfg.vocab_size for x in t)
                                   for t in tokens), "ssm serving tokens out of [0, V)")
    del report, tokens
    torch.cuda.empty_cache()
    time_cpu_draw(ssm_cfg)

    # -- phase 3m: the hybrid serving path at full width ---------------------
    counts_hyb = check_hybrid_serving(device)

    # -- phase 3l: gemma3-4b and nemotron-4-15b at full width -----------------
    dense_summary = check_dense_configs()
    print(f"[dense-summary] {json.dumps(dense_summary)}")

    # -- phases 3n, 3o: training the hybrid and ssm families at full width ----
    train_summary = check_ssm_training(device)
    print(f"[train-summary] {json.dumps(train_summary)}")

    # -- phases 3p, 3q, 3r: whisper-medium serving and training, the twins ----
    audio_serve = check_audio_serving(device)
    print(f"[audio-serve-summary] {json.dumps(audio_serve)}")
    audio_train = check_audio_training(device)
    print(f"[audio-train-summary] {json.dumps(audio_train)}")
    twins = check_example_twins(device)
    print(f"[twins-summary] {json.dumps(twins)}")

    # -- phase 4: the card against the CPU ---------------------------------
    on_cpu, on_card = same_start_losses(torch.device("cpu"), device)
    rel = float(((on_card - on_cpu).abs() / on_cpu.abs()).max())
    print(f"[parity] cpu={on_cpu.tolist()} cuda={on_card.tolist()} max_rel_diff={rel}")
    check(torch.allclose(on_card, on_cpu, rtol=1e-3, atol=0.0),
          f"card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")

    # -- phase 4b: the card against the CPU on the new paths ---------------
    on_cpu, on_card = same_start_private_losses(torch.device("cpu"), device)
    rel = float(((on_card - on_cpu).abs() / on_cpu.abs()).max())
    print(f"[parity-private] cpu={on_cpu.tolist()} cuda={on_card.tolist()} max_rel_diff={rel}")
    check(torch.allclose(on_card, on_cpu, rtol=1e-3, atol=0.0),
          f"private path: card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")
    (l_cpu, plan_cpu), (l_card, plan_card) = same_start_adaptive(torch.device("cpu"), device)
    print(f"[parity-adaptive] plans cpu={plan_cpu} cuda={plan_card} "
          f"cpu={l_cpu.tolist()} cuda={l_card.tolist()}")
    check(plan_card == plan_cpu, "adaptive path: card and CPU picked other (P, Q, rung)")
    rel = float(((l_card - l_cpu).abs() / l_cpu.abs()).max())
    check(torch.allclose(l_card, l_cpu, rtol=1e-3, atol=0.0),
          f"adaptive path: card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")
    check_ring_on_card(device)

    # -- phase 4c: the card against the CPU on the serving path -------------
    reset_launch_counts()
    (lg_cpu, tok_cpu), (lg_card, tok_card) = serve_parity(
        "gemma3-1b", SERVE_PARITY_LEN, SERVE_PARITY_GEN, torch.device("cpu"), device)
    rel = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
    print(f"[parity-serve] flash launches on the card={launch_counts['flash_attention']} "
          f"logits max |card - cpu| / max |cpu| = {rel} tokens cpu={tok_cpu} cuda={tok_card}")
    check(launch_counts["flash_attention"] > 0, "the card's serving parity run skipped the kernel")
    check(rel <= 1e-4, f"serving path: first-step logits differ by {rel} relative (> 1e-4)")
    check(tok_card == tok_cpu, "serving path: card and CPU greedy tokens differ")

    # -- phase 4d: the card against the CPU on the ssm serving path ----------
    reset_launch_counts()
    (lg_cpu, tok_cpu), (lg_card, tok_card) = serve_parity(
        "falcon-mamba-7b", SSM_PARITY_LEN, SSM_PARITY_GEN, torch.device("cpu"), device)
    rel = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
    print(f"[parity-serve-ssm] scan launches on the card={launch_counts['ssm_scan']} "
          f"logits max |card - cpu| / max |cpu| = {rel} tokens cpu={tok_cpu} cuda={tok_card}")
    check(launch_counts["ssm_scan"] > 0, "the card's ssm parity run skipped the kernel")
    check(rel <= 1e-4, f"ssm serving path: first-step logits differ by {rel} relative (> 1e-4)")
    check(tok_card == tok_cpu, "ssm serving path: card and CPU greedy tokens differ")

    # -- phase 4h: the card against the CPU on the hybrid serving path -------
    reset_launch_counts()
    (lg_cpu, tok_cpu), (lg_card, tok_card) = serve_parity(
        HYBRID_ARCH, HYBRID_PARITY_LEN, HYBRID_PARITY_GEN, torch.device("cpu"), device)
    rel = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
    print(f"[parity-serve-hybrid] launches on the card={dict(launch_counts)} "
          f"logits max |card - cpu| / max |cpu| = {rel} tokens cpu={tok_cpu} cuda={tok_card}")
    check(launch_counts["ssm_scan"] > 0 and not launch_counts.get("flash_attention"),
          "the card's hybrid parity run skipped the scan kernel or launched flash")
    check(rel <= 1e-4, f"hybrid serving path: first-step logits differ by {rel} relative "
                       f"(> 1e-4)")
    check(tok_card == tok_cpu, "hybrid serving path: card and CPU greedy tokens differ")

    # -- phase 4e: the card against the CPU on the population path ----------
    (l_cpu, h_cpu), (l_card, h_card) = same_start_population(torch.device("cpu"), device)
    rel = float(((l_card - l_cpu).abs() / l_cpu.abs()).max())
    print(f"[parity-population] cohorts={[h['cohort_sizes'] for h in h_card]} "
          f"cpu={l_cpu.tolist()} cuda={l_card.tolist()} max_rel_diff={rel}")
    check(h_card == h_cpu, "population path: card and CPU rounds differ (cohorts, clock)")
    check(torch.allclose(l_card, l_cpu, rtol=1e-3, atol=0.0),
          f"population path: card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")

    # -- phase 4f: the card against the CPU on the LLM path -------------------
    reset_launch_counts()
    l_cpu, l_card = same_start_llm(torch.device("cpu"), device)
    rel = float(((l_card - l_cpu).abs() / l_cpu.abs()).max())
    print(f"[parity-llm] compress launches on the card={launch_counts['fused_compress']} "
          f"cpu={l_cpu.tolist()} cuda={l_card.tolist()} max_rel_diff={rel}")
    check(launch_counts["fused_compress"] > 0, "the card's LLM parity run skipped the kernel")
    check(torch.allclose(l_card, l_cpu, rtol=1e-3, atol=0.0),
          f"LLM path: card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")

    # -- phase 4i: the card against the CPU on the ssm and hybrid train path --
    for arch in (HYBRID_ARCH, "falcon-mamba-7b"):
        reset_launch_counts()
        l_cpu, l_card = same_start_llm(torch.device("cpu"), device, arch=arch)
        rel = float(((l_card - l_cpu).abs() / l_cpu.abs()).max())
        print(f"[parity-train-{arch}] launches on the card={dict(launch_counts)} "
              f"cpu={l_cpu.tolist()} cuda={l_card.tolist()} max_rel_diff={rel}")
        check(launch_counts["ssm_scan"] > 0 and launch_counts["ssm_scan_bwd"] > 0,
              f"{arch}: the card's training parity run skipped a scan kernel")
        check(torch.allclose(l_card, l_cpu, rtol=1e-3, atol=0.0),
              f"{arch} training: card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")

    # -- phase 4j: the card against the CPU on whisper-medium -----------------
    reset_launch_counts()
    (lg_cpu, tok_cpu), (lg_card, tok_card) = serve_parity(
        AUDIO_ARCH, AUDIO_PARITY_LEN, AUDIO_PARITY_GEN, torch.device("cpu"), device)
    rel = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
    print(f"[parity-serve-audio] launches on the card={dict(launch_counts)} logits max "
          f"|card - cpu| / max |cpu| = {rel} tokens cpu={tok_cpu} cuda={tok_card}")
    check(rel <= 1e-4, f"audio serving path: first-step logits differ by {rel} relative "
                       f"(> 1e-4)")
    check(tok_card == tok_cpu, "audio serving path: card and CPU greedy tokens differ")
    reset_launch_counts()
    l_cpu, l_card = same_start_llm(torch.device("cpu"), device, arch=AUDIO_ARCH)
    rel = float(((l_card - l_cpu).abs() / l_cpu.abs()).max())
    print(f"[parity-train-{AUDIO_ARCH}] launches on the card={dict(launch_counts)} "
          f"cpu={l_cpu.tolist()} cuda={l_card.tolist()} max_rel_diff={rel}")
    check(launch_counts["fused_compress"] > 0, "the card's audio training parity run skipped "
                                               "the compress kernel")
    check(torch.allclose(l_card, l_cpu, rtol=1e-3, atol=0.0),
          f"audio training: card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")

    # -- phase 4g: the card against the CPU on spec decode and the new configs -
    reset_launch_counts()
    (plain_cpu, spec_cpu), (plain_card, spec_card) = spec_parity(
        "gemma3-1b", SERVE_PARITY_LEN, SERVE_PARITY_GEN, torch.device("cpu"), device)
    print(f"[parity-spec] flash launches on the card={launch_counts['flash_attention']} "
          f"spec tokens cpu={spec_cpu} cuda={spec_card} plain cpu={plain_cpu} "
          f"cuda={plain_card}")
    check(launch_counts["flash_attention"] > 0, "the card's spec parity run skipped the kernel")
    check(spec_card == spec_cpu == plain_cpu == plain_card,
          "spec decode: card and CPU tokens, spec and plain, differ")
    for arch in DENSE_ARCHS:
        reset_launch_counts()
        (lg_cpu, tok_cpu), (lg_card, tok_card) = serve_parity(
            arch, SERVE_PARITY_LEN, SERVE_PARITY_GEN, torch.device("cpu"), device)
        rel = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
        print(f"[parity-serve-{arch}] flash launches on the card="
              f"{launch_counts['flash_attention']} logits max |card - cpu| / max |cpu| = {rel} "
              f"tokens cpu={tok_cpu} cuda={tok_card}")
        check(launch_counts["flash_attention"] > 0, f"{arch}: the card's parity run skipped "
                                                    f"the kernel")
        check(rel <= 1e-4, f"{arch}: first-step logits differ by {rel} relative (> 1e-4)")
        check(tok_card == tok_cpu, f"{arch}: card and CPU greedy tokens differ")

    # -- phase 5: summary ----------------------------------------------------
    kernels = [{
        "name": "fused_compress",
        "route": "cuda",
        "source": "src/repro_torch/csrc/compress.cu",
        "replaces": "src/repro/kernels/compress.py:78",
        "launches": counts["fused_compress"] + audio_train["launches"]["fused_compress"] + sum(
            t["launches"].get("fused_compress", 0) for t in twins.values() if "launches" in t),
        "max_abs_err": max_err,
        "ms": main_cmp["ms"],
        "plain_ms": main_cmp["plain_ms"],
        "bound_ms": main_cmp["bound_ms"],
        "bound_by": main_cmp["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_compress_dp",
        "route": "cuda",
        "source": "src/repro_torch/csrc/compress.cu",
        "replaces": "src/repro/kernels/compress.py:103",
        "launches": counts_dp["fused_compress_dp"],
        "max_abs_err": max_err_dp,
        "ms": main_dp["ms"],
        "plain_ms": main_dp["plain_ms"],
        "bound_ms": main_dp["bound_ms"],
        "bound_by": main_dp["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": counts_serve["flash_attention"],
        "max_abs_err": max_err_flash,
        "ms": flash_main["ms"],
        "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"],
        "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:49",
        "launches": counts_ssm["ssm_scan"] + counts_hyb["ssm_scan"] + sum(
            cell["launches"]["ssm_scan"] for cell in train_summary.values()),
        "max_abs_err": max_err_scan,
        "ms": scan_main["ms"],
        "plain_ms": scan_main["plain_ms"],
        "bound_ms": scan_main["bound_ms"],
        "bound_by": scan_main["bound_by"],
        "library_ms": None,
    }, {
        "name": "ssm_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        # no TPU kernel: the reference takes jax.grad through the scan's twin
        "replaces": "jax.grad through src/repro/models/ssm.py:158 (_chunk_recurrence)",
        "launches": sum(cell["launches"]["ssm_scan_bwd"] for cell in train_summary.values()),
        "max_abs_err": max_err_scan_bwd,
        "ms": scan_bwd_main["ms"],
        "plain_ms": scan_bwd_main["plain_ms"],
        "bound_ms": scan_bwd_main["bound_ms"],
        "bound_by": scan_bwd_main["bound_by"],
        "library_ms": None,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
