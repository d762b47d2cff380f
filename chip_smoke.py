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
     register bucket, non-multiples of 32, the group body's one-warp and
     one-CTA rows past 1024) with k <= 0, k >= len, len = 0, tied
     magnitudes, ±inf, NaN, all-zero rows, subnormals, values near the
     fp32 maximum and rows with
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
     read just after, under the executor guard
     (``analysis.compile_guard``): exactly one ``hsgd_round`` built;
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
  2, 2b. the edge-case matrix also holds the first and last widths of the
     group body's clusters of 2, 4 and 8 CTAs (32769 to 262144), widths an
     older body ended at (58112, 58113, 65536) and the wide body's first
     (262145), for both kernels; each width's body, as the library reports
     it, must be the group body up to 262144 floats and the wide body past
     it. The head's rows of gemma3-1b's exchange message, [1152, 262144] at
     k = 25 %, b = 128, are held bit for bit and timed beside their bound
     (phase 2 also qwen2-vl-72b's [16384, 29568] and [8192, 152064]), each
     with its body, cluster size and share of the bound;
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
     layers x 16 chunks of 256 tokens) plus 64 per decode step, as many
     discretize launches (one before each scan), no other kernel of the
     port, 64 tokens in [0, V), prefill seconds, ms a decode
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
  2f. the Mamba-1 discretize kernels against the eager chain they replace
     (DISCRETIZE_CASES: falcon-mamba-7b's training chunk [2, 256, 8192,
     16] and decode step, K and d off the kernels' tiles, N 7): a and b bit
     for bit (torch.equal), ∂dt, ∂x, ∂B, ∂A through Mamba1Discretize within
     1e-5 of each sum's magnitude (only the order of the sums differs) and
     bit-identical over two runs; the forward kernel, the backward kernel
     with its sums, the chain's forward and the chain's forward and
     backward timed beside the bytes bounds; no spills;
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
  2. also whisper-medium's head rows [1024, 51865] (k = 25 %, b = 128: an
     odd width, rows not 16-byte aligned, on a cluster of 2 CTAs), bit for
     bit and timed beside its bound;
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

The MoE family, grok-1-314b and deepseek-v3-671b with MLA (after 3r and
4g respectively):
  3s. grok-1-314b at its published widths (d 6144, 48 heads of 128 over 8
     KV heads, 8 experts of 32 768, top 2, V 131 072; hf:xai-org/grok-1)
     with 2 of its 64 layers (``get_config(arch).replace(num_layers=2)``,
     weights drawn from the seed on the card), served through
     ``serve.build_inputs``, ``build_engine`` and ``run_engine`` with
     --batch 2 --prompt-len 4096 --gen 32 --cache-dtype bf16, the launch
     counters zeroed just before and read just after: exactly 2 flash
     launches (one a layer of the fresh 4096-token block, K and V repeated
     to the 48 heads: [96, 4096, 128]) and no other kernel; then with
     --spec-gamma 4 and a 1-layer draft: the same 2 flash launches and
     tokens equal to the plain ones; prefill seconds, ms a decode step,
     peak device bytes, and one more request batch profiled for the
     device's busy share and device ms by kernel class (the expert
     products, the dispatch and the combine, read from ``models/moe.py``'s
     profiler ranges; flash; GEMMs; the rest);
  3t. deepseek-v3-671b at its published widths (d 7168, MLA with q/kv ranks
     1536/512, 128 heads, 256 routed experts of 2048 top 8 and a shared
     one, V 129 280; arXiv:2412.19437) with 4 of its 61 layers (its 3 dense
     layers and 1 MoE layer), --batch 2 --prompt-len 1024 --gen 32, with
     bf16 and then int8 caches: no kernel of the port (MLA attends through
     its absorbed weights over the cached latent, never flash), the same
     numbers as 3s;
  3u. ``repro_torch.launch.train --arch grok-1-314b|deepseek-v3-671b
     --smoke --steps 20 --compression-k 0.25 --quantization 128 --pods 2``
     (at published widths no depth fits one card: one grok MoE layer's θ0
     is 22.9 GB a pod): exactly 10 exchanges x 1 row group compress
     launches (TRAIN_CELLS) and no other kernel, the first exchange's group
     torch.equal to plain, losses falling within every exchange interval;
     then 2 rounds from one CPU-drawn model on the card and the CPU:
     per-step losses within rtol 1e-3;
  4k. the card against the CPU at both smoke configs with 96-token prompts
     (192 tokens in the block, past an expert's 128 slots): first-step
     logits within 1e-4 of the largest |logit|, equal greedy tokens, and
     every router call's expert ids equal, except where the CPU's
     probabilities at the first differing rank and the next lie within
     1e-6.

The VLM family, qwen2-vl-72b (phase 2c's case, then after 3u and 4k):
  2c. also qwen2-vl-72b's prefill shape [128, 4096, 128] (batch 2 x 64
     heads after the 8x K/V repeat), fp32, timed beside its bound and
     F.scaled_dot_product_attention;
  3v. qwen2-vl-72b at its published widths (d 8192, 64 heads of 128 over 8
     KV heads, d_ff 29 568, V 152 064, M-RoPE sections (16, 24, 24);
     arXiv:2409.12191) with 16 of its 80 layers, weights drawn from the
     seed on the card, served text only (as the reference serves it)
     through ``serve.build_inputs``, ``build_engine`` and ``run_engine``
     with --batch 2 --prompt-len 4096 --gen 32 --cache-dtype bf16, the
     launch counters zeroed just before and read just after: exactly 16
     flash launches (one a layer of the fresh block) and no other kernel;
     then with --spec-gamma 4 and a 1-layer draft: the same launches and
     tokens equal to the plain ones; prefill seconds, ms a decode step,
     peak device bytes, one more request batch profiled (busy share,
     device ms of GEMMs, flash and the rest); then one no-grad ``lm_loss``
     at the same weights over 1 024 patch embeddings (a 32 x 32 grid of
     M-RoPE ids) and 1 024 tokens: finite, no kernel of the port (its 2 048
     keys take the plain route), its seconds;
  3w. ``repro_torch.launch.train --arch qwen2-vl-72b --smoke --steps 20
     --compression-k 0.25 --quantization 128 --pods 2``: exactly 10
     exchanges x 1 row group compress launches (TRAIN_CELLS) and no other
     kernel, the first exchange's group torch.equal to plain, losses
     falling within every exchange interval, steps/s, busy share, peak;
  3x. one published-width layer (``replace(num_layers=1)``) trained at one
     pod, --steps 4 with the same k and b, built as the CLI builds it:
     exactly 2 exchanges x 4 row groups compress launches (128 | 8192 |
     29568 | the head's 152064) and no other kernel, steps/s, peak device
     bytes; then one more round with every group held torch.equal to plain
     as it is made and timed beside its bound;
  4l. the card against the CPU at qwen2-vl-72b's smoke widths: first-step
     logits after a 4096-token prompt (flash on the card) within 1e-4 of
     the largest |logit| and equal greedy tokens; ``lm_loss`` over 4 and
     8 patch embeddings within rtol 1e-5; 2 training rounds (--pods 2,
     k = 0.25, b = 128) from one CPU-drawn model within rtol 1e-3.

Scale-out (after 3x and 4l; phases 3i, 3n and 3o also print the traced
FLOPs of one pod-step, ``launch/flops.py``, and the run's achieved share of
the fp32 peak, 67 TFLOP/s, beside the card's name and power limit):
  3y. gemma3-1b's program set (``launch/steps.py::build_programs``) at its
     published widths, bf16 as the reference's programs, plain tensors (a
     one-card mesh's layout: every constrain is the identity), for every
     input shape: train_4k's train_step, exchange and global_agg,
     prefill_32k's and decode_32k's serve_step, long_500k's serve_step
     with force_window. seq_len is kept; the global batch starts at the
     shape's own (PROGRAM_BATCH: train_step at 16, the prefill at 2) and
     halves on an out-of-memory error; each cut is listed with the bytes
     that the shape's own batch would need (decode: the caches' bytes; the
     others: the measured peak's part past the weights, scaled) and what
     forced it (memory, or the script's time limit). After a warm-up, the
     synchronised wall ms, the traced FLOPs, the achieved TFLOP/s and
     share of the bf16 peak (989 TFLOP/s), the peak device bytes; no
     kernel of the port launches (the prefill takes the plain blockwise
     route, the exchange compresses nothing);
  3z. a one-rank NCCL process group and a (1, 1) [data, model] DeviceMesh:
     the main path's ``HSGDRunner.run(mesh=)`` (2 c-hsgd rounds) gives
     the same losses as the run without a mesh, bit for bit; so do two
     chained ``run(rounds=1, mesh=)`` calls, each taking the state the one
     before returned, and ``AdaptiveHSGDRunner.run(mesh=)`` with DP (C = 1,
     σ = 1, ε ≤ 25) and secure aggregation against its run without the
     mesh (8 steps, no probe; one DP compress launch a round);
  3za. the legacy sort path (``HSGDRunner(fused_compression=False)``:
     ``torch.topk`` and a separate quantize, leaf by leaf): the main path
     (phase 3's run) on it and on the fused kernel, each a warm-up round
     drained, then 3 turns of a run of each in alternating order, each
     timed to a ``torch.cuda.synchronize()``: the best steps/s of each, the sort run's losses falling, no kernel of the port
     launched on it, one executor each; ``exchange(fused=False, dp_clip=)``
     raises; CUDA events (median of 21 launches) time the sort path against
     the compress kernel at the main path's message (leaf by leaf, against
     ``compress_pytree`` and the bare kernel) and at [16384, 29568],
     [8192, 152064] and [1152, 262144] with k = 0.25, b = 128, the
     kernel's body, cluster size and share of the bound beside it;
  3zb. the compress kernel with levels=0 (``topk_sparsify_cuda``) at the
     reference property test's (n, k) and at [2900, 128], k = 32: equal to
     its plain version, a superset of ``kernels/ref.py::topk_exact_ref``'s
     support, at most k + 8 survivors a row;
  4m. each program's outputs at gemma3-1b's smoke widths (fp32) on the card
     against the CPU from the same inputs: the loss and the exchange
     message within rtol 1e-4, the updated parameters within 1e-5 of the
     largest |parameter|, global_agg's within 1e-6, the logits and the
     caches within 1e-4 of the largest |value|.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
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

from repro_torch.analysis import compile_guard  # noqa: E402
from repro_torch.common.backend import resolve_device  # noqa: E402
from repro_torch.common.config import get_config  # noqa: E402
from repro_torch.common.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.core import federation as F  # noqa: E402
from repro_torch.core.baselines import make_runner  # noqa: E402
from repro_torch.core.compression import compress_message_sort, compress_rows_ref  # noqa: E402
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
from repro_torch.kernels import ref as kernel_ref  # noqa: E402
from repro_torch.kernels.compress import (CLUSTER_ROW_FLOATS, NARROW_WIDTH,  # noqa: E402
                                          compress_pytree, fused_compress, kernel_body,
                                          stack_rows)
from repro_torch.kernels.topk_sparsify import topk_sparsify_cuda  # noqa: E402
from repro_torch.kernels.compress_cases import EDGE_WIDTHS, edge_case_rows, same_values  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention_cuda,  # noqa: E402
                                                 flash_attention_ref)
from repro_torch.kernels.mamba1_discretize import (  # noqa: E402
    Mamba1Discretize, mamba1_discretize_bwd_cuda, mamba1_discretize_cuda, mamba1_discretize_ref)
from repro_torch.kernels.ssm_scan import (SSMScan, ssm_scan_bwd_cuda,  # noqa: E402
                                          ssm_scan_bwd_ref, ssm_scan_cuda, ssm_scan_ref)
from repro_torch.launch import loadgen, profile_serve, profile_train, serve  # noqa: E402
from repro_torch.launch import steps as llm_steps  # noqa: E402
from repro_torch.launch.engine import ServeEngine, sequential_generate  # noqa: E402
from repro_torch.launch.timing import (card_rates, compress_bound_ms, device_ms,  # noqa: E402
                                       event_median_ms)
from repro_torch.data.synthetic import llm_batch_fn  # noqa: E402
from repro_torch.launch.steps import LLMRoundRunner, init_llm_params  # noqa: E402
from repro_torch.launch.flops import traced_flops  # noqa: E402
from repro_torch.common.config import INPUT_SHAPES  # noqa: E402
from repro_torch.common.sharding import map_structure, structure_leaves  # noqa: E402
from repro_torch.launch.train import (build_llm, parse_args, population_rounds,  # noqa: E402
                                      run_ehealth, run_llm, run_population_cli, setup_ehealth)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.split_model import llm_hybrid  # noqa: E402
from repro_torch.models.ssm import CHUNK as SSM_CHUNK  # noqa: E402

MAIN_ARGV = ["--model", "paper-cnn", "--dataset", "organamnist", "--algorithm", "c-hsgd",
             "--groups", "10", "--devices", "64", "--alpha", "0.25", "--samples", "2048",
             "--p", "4", "--q", "2"]
PRIVATE_ARGV = ["--dp-clip", "1", "--dp-sigma", "1", "--secure-agg"]
ADAPTIVE_ARGV = ["--adaptive", "--dp-clip", "1", "--dp-sigma", "1", "--epsilon", "25"]
# bf16 dense tensor-core rate, FLOP/s, matched as launch/timing.py::CARD_RATES is
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
    # qwen2-vl-72b's prefill: batch 2 x 64 heads after the 8x K/V repeat
    ("qwen2-vl-72b prefill", 128, 4096, 128, 0, torch.float32),
)
VLM_FLASH_CASE = "qwen2-vl-72b prefill"
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
# qwen2-vl-72b's widest row groups of one published-width layer (phase 2:
# the MLP rows and the head), beside gemma3-1b's and whisper's heads
VLM_HEAD_SHAPES = ((16384, 29568), (8192, 152064))
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
# the Mamba-1 discretize kernels against the chain (phase 2f): (name, (B, K,
# d_inner, N)); the first is falcon-mamba-7b's training chunk
DISCRETIZE_CASES = (
    ("falcon-mamba-7b training chunk", (2, 256, 8192, 16)),
    ("falcon-mamba-7b decode step, K = 1", (2, 1, 8192, 16)),
    ("K = 37, d = 200: off the steps and tiles", (3, 37, 200, 16)),
    ("N = 7: one float a lane", (2, 45, 33, 7)),
)
DISCRETIZE_SUM_TOL = 1e-5
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
                        {"ssm_scan": 1400, "ssm_scan_bwd": 1360, "mamba1_discretize": 1400,
                         "mamba1_discretize_bwd": 1360, "mamba1_discretize_sum": 1360,
                         "fused_compress": 50}),
    # no Mamba layer: row groups of widths 64, 1024, 4096 and 51865
    "whisper-medium": (0, 4, {"fused_compress": 40}),
    # the MoE family at smoke widths (phase 3u): every row of the message is
    # at most 512 floats wide, so one row group
    "grok-1-314b": (0, 1, {"fused_compress": 10}),
    "deepseek-v3-671b": (0, 1, {"fused_compress": 10}),
    # the VLM family at smoke widths (phase 3w): rows of at most 512 floats,
    # one group (tests/test_torch_vlm.py::SMOKE_GROUPS)
    "qwen2-vl-72b": (0, 1, {"fused_compress": 10}),
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
# the MoE family at published widths (phases 3s, 3t), depth cut to fit one
# card with fp32 weights: grok-1-314b's 2 of 64 layers are 11.45e9
# parameters (45.8 GB), and its batch-2 4096-token prefill adds ~11 GB of
# [8, 2688, 32768] expert transients (3 layers would not fit); 3 dense + 1
# MoE layer of deepseek-v3-671b's 61 (15.11e9 parameters, 60.4 GB) is the
# shallowest cut that keeps its layer order and reaches an MoE layer, and a
# 1024-token prompt keeps its absorbed MLA scores [2, 128, 1024, 2048] at
# 2.15 GB (a 4096-token prompt would take 34.4 GB)
GROK_ARCH, GROK_LAYERS, GROK_DRAFT_LAYERS = "grok-1-314b", 2, 1
GROK_SERVE_ARGV = ["--arch", GROK_ARCH, "--full", "--batch", "2", "--prompt-len", "4096",
                   "--gen", "32"]
DEEPSEEK_ARCH, DEEPSEEK_LAYERS = "deepseek-v3-671b", 4
DEEPSEEK_SERVE_ARGV = ["--arch", DEEPSEEK_ARCH, "--full", "--batch", "2", "--prompt-len", "1024",
                       "--gen", "32"]
MOE_ARCHS = (GROK_ARCH, DEEPSEEK_ARCH)
# phase 4k at smoke widths: 2 x 96 = 192 tokens in the prefill block, more
# than an expert's 128 slots, so assignments can drop
MOE_PARITY_LEN, MOE_PARITY_GEN = 96, 8
# an expert id may differ between the card and the CPU only where the
# router's probabilities at that rank and the next lie this close
ROUTER_TIE = 1e-6
# qwen2-vl-72b at published widths (phase 3v), its depth cut to fit one card
# with fp32 weights: 16 of 80 layers are 16.53e9 parameters (66.1 GB; the
# full depth is 72.7e9, 291 GB), beside 1.07 GB of bf16 caches and ~4 GB of
# the batch-2 4096-token prefill's MLP and attention transients
VLM_ARCH, VLM_LAYERS, VLM_DRAFT_LAYERS = "qwen2-vl-72b", 16, 1
VLM_SERVE_ARGV = ["--arch", VLM_ARCH, "--full", "--batch", "2", "--prompt-len", "4096",
                  "--gen", "32", "--cache-dtype", "bf16"]
# the reference's launch/steps.py VIS_PATCHES: a 32 x 32 grid of patch
# embeddings in front of as many tokens (phase 3v's one forward whose M-RoPE
# sections see grid ids; its 2048 keys take the plain route, no kernel)
VLM_PATCHES, VLM_TEXT = 1024, 1024
# one published-width training layer at one pod (phase 3x): θ0 2.12e9, θ1
# 0.88e9 and θ2 2.12e9 parameters (20.5 GB), as much in gradients, θ0's copy
# in the exchange and its row groups (128 | 8192 | 29568 | the head's
# 152064: tests/test_torch_vlm.py::test_row_groups_of_the_training_message)
VLM_TRAIN_LAYERS = 1
VLM_TRAIN_ARGV = ["--arch", VLM_ARCH, "--steps", "4", "--compression-k", "0.25",
                  "--quantization", "128", "--pods", "1"]
VLM_TRAIN_CELL = (0, 4, {"fused_compress": 8})
# phase 4l at smoke widths: a 4096-token block takes flash on the card
VLM_PARITY_LEN, VLM_PARITY_GEN = 4096, 8
# phase 3y: gemma3-1b's programs at published widths. Each starts at its
# shape's own global batch, halved on out-of-memory, but for these two,
# which start lower: train_step at 16 (a sample holds ~3.7 GB at its peak,
# so 32 does not fit), the prefill at 2 for the script's time limit (a
# sample is 1.6e14 FLOPs, most of them fp32 attention over 32 768 keys:
# ~4 s). Each cut is printed with the bytes the own batch would need
PROGRAM_ARCH = "gemma3-1b"
PROGRAM_BATCH = {("train_4k", "train_step"): 16, ("prefill_32k", "serve_step"): 2}
BF16_PEAK, FP32_PEAK = 989e12, 67e12  # H100 SXM5 dense tensor-core bf16, fp32 (data sheet)
# phase 4m's smoke shapes: (seq_len, global_batch)
PROGRAM_PARITY = {"train_4k": (32, 2), "prefill_32k": (32, 2), "decode_32k": (32, 2),
                  "long_500k": (64, 1)}
# checkpoints of phase 3g, inside the checkout's ignored build directory
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
# The legacy sort path (phase 3za): the LLM shapes of PERF.md §6 at which it
# is timed against the compress kernel (qwen2-vl-72b's shared-memory and
# head groups, gemma3-1b's head), k = 0.25, b = 128; CUDA-event medians of
# SORT_LAUNCHES launches; steps/s best of SORT_REPS runs.
SORT_LLM_SHAPES = ((16384, 29568), (8192, 152064), (1152, 262144))
SORT_LAUNCHES = 21
SORT_REPS = 3
# The exact-support property (phase 3zb): the reference test's (n, k) on 8
# rows, and the main path's width at k = 0.25.
EXACT_CASES = ((8, 128, 13), (8, 256, 1), (8, 64, 64), (2900, 128, 32))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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
    register bucket of 1..32 values a lane, non-multiples of 32, the first
    and last widths of the group body's one-warp, one-CTA and cluster rows
    and the wide body past them) and levels 0, 16 and 128; each width's
    body as the library reports it is the one its width calls for."""
    checked = 0
    for n in EDGE_WIDTHS:
        body = kernel_body(n)["body"]
        want_body = ("register body" if n <= NARROW_WIDTH else
                     "group body" if n <= CLUSTER_ROW_FLOATS else "wide body")
        check(body == want_body, f"edge cases n={n}: the library runs the {body}, not the "
                                 f"{want_body}")
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
          f"x levels 0, 16, 128: equal to plain (torch.equal; NaN where both are NaN); "
          f"bodies {[(n, body_text(kernel_body(n))) for n in EDGE_WIDTHS if n > NARROW_WIDTH]}")


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
    the comparison at the serving path's global-layer shape, the largest
    fp32 difference at the serving path's shape and every case's
    comparison by name."""
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
    return results[FLASH_CASES[0][0]], main_err, results


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


def discretize_bounds_ms(shape, bw):
    """Least times of the discretize kernels (fp32, bytes): the forward
    reads dt, x, B, A and writes a and b once; the backward reads ∂a, ∂b
    and dt, x, B, A once and writes ∂dt, ∂x, ∂B, ∂A once."""
    B, K, d, N = shape
    big, small = 2 * B * K * d * N, 2 * B * K * d + B * K * N + d * N
    return 4 * (big + small) / bw * 1e3, 4 * (big + 2 * small) / bw * 1e3


def check_discretize_kernels(device, name):
    """Phase 2f: the Mamba-1 discretize kernels against the eager chain on
    every case: the forward bit for bit, the gradients through
    ``Mamba1Discretize`` within DISCRETIZE_SUM_TOL of each sum's magnitude
    and bit-identical over two runs; timed beside the chain and the bounds.
    Returns the forward's and the backward's comparisons at the training
    chunk, each as the ``kernels`` line lays out a kernel."""
    bw, _ = card_rates(name)
    check_no_spills("mamba1_discretize")
    results = {}
    for case, shape in DISCRETIZE_CASES:
        B, K, d, N = shape
        g = torch.Generator(device=device).manual_seed(sum(shape))
        # laid out as mamba1_forward hands them over: chunk views and a slice
        dt = (torch.rand(B, 2 * K, d, generator=g, device=device) * 0.5)[:, K:]
        x = torch.randn(B, 2 * K, d, generator=g, device=device)[:, :K]
        bm = torch.randn(B, K, 2 * N + 5, generator=g, device=device)[..., :N]
        A = -torch.exp(torch.randn(d, N, generator=g, device=device) * 0.5)
        d_a = torch.randn(B, K, d, N, generator=g, device=device)
        d_b = torch.randn(B, K, d, N, generator=g, device=device)
        got = mamba1_discretize_cuda(dt, x, bm, A)
        want = mamba1_discretize_ref(dt, x, bm, A)
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(got, want)),
              f"discretize {case}: the forward kernel differs from the chain")
        del got, want
        leaves = [t.clone().requires_grad_() for t in (dt, x, bm, A)]
        want = torch.autograd.grad(mamba1_discretize_ref(*leaves), leaves, (d_a, d_b))
        runs = [torch.autograd.grad(Mamba1Discretize.apply(*leaves), leaves, (d_a, d_b))
                for _ in range(2)]
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(*runs)),
              f"discretize {case}: two backward runs differ")
        a64 = torch.exp(dt.double()[..., None] * A.double())
        ga = (d_a.double() * a64).abs()
        gb = (d_b.double() * bm.double()[:, :, None, :]).abs().sum(-1)
        mags = [(ga * A.double().abs()).sum(-1) + gb * x.double().abs(), gb * dt.double().abs(),
                (d_b.double().abs() * (dt.double() * x.double()).abs()[..., None]).sum(2),
                (ga * dt.double().abs()[..., None]).sum((0, 1))]
        del a64, ga, gb
        rel = [float(((u.double() - v.double()).abs() / m.clamp_min(1e-300)).max())
               for u, v, m in zip(runs[0], want, mags)]
        max_err = max(float((u - v).abs().max()) for u, v in zip(runs[0], want))
        check(max(rel) <= DISCRETIZE_SUM_TOL,
              f"discretize {case}: gradients off the chain's by {rel} of their sums' magnitudes")
        del runs, want, mags
        ms = device_ms(lambda: mamba1_discretize_cuda(dt, x, bm, A))
        bwd_ms = device_ms(lambda: mamba1_discretize_bwd_cuda(d_a, d_b, dt, x, bm, A))
        plain_ms = device_ms(lambda: mamba1_discretize_ref(dt, x, bm, A), inner=5, reps=11)
        plain_fwd_bwd_ms = device_ms(
            lambda: torch.autograd.grad(mamba1_discretize_ref(*leaves), leaves, (d_a, d_b)),
            inner=5, reps=11)
        # the chain's backward alone over one graph built on the default stream,
        # which a CUDA graph cannot capture: CUDA events around each call
        chain = mamba1_discretize_ref(*leaves)
        plain_bwd_ms = event_median_ms(
            lambda: torch.autograd.grad(chain, leaves, (d_a, d_b), retain_graph=True), n=11)
        del chain
        bound, bwd_bound = discretize_bounds_ms(shape, bw)
        results[case] = (
            {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": "bytes", "library_ms": None},
            {"max_abs_err": max_err, "grad_err_of_magnitude": rel, "ms": bwd_ms,
             "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound, "bound_by": "bytes",
             "library_ms": None})
        print(f"[discretize] {case}: shape={list(shape)} forward bit-identical, gradients "
              f"(dt, x, B, A) off the chain's by {rel} of their sums' magnitudes, two runs "
              f"bit-identical; fwd_ms={ms} bound_ms={bound} fwd/bound={ms / bound} "
              f"bwd_ms={bwd_ms} (kernel and sums) bwd_bound_ms={bwd_bound} "
              f"bwd/bound={bwd_ms / bwd_bound} chain fwd_ms={plain_ms} chain "
              f"bwd_ms={plain_bwd_ms} chain fwd_bwd_ms={plain_fwd_bwd_ms} "
              f"kernels fwd+bwd / chain = "
              f"{(ms + bwd_ms) / plain_fwd_bwd_ms} library_ms=null (no single PyTorch call "
              f"computes this function)")
        del dt, x, bm, A, d_a, d_b, leaves
    return results[DISCRETIZE_CASES[0][0]]


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
    dt = time.perf_counter() - t0  # reprolint: disable=RP6 — a CPU draw, no CUDA work
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


def same_start_losses(*devices, mesh=None):
    """Per-step losses of PARITY_ROUNDS c-hsgd rounds on each device, all
    from one initial model and one set of participant draws (on ``mesh``
    when one is given)."""
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
        _, losses = runner.run(state, data, w, PARITY_ROUNDS, participants=parts, mesh=mesh)
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
    body = kernel_body(n)
    print(f"[kernel] {tag} levels=128 k=25%: bit-identical ({body_text(body)}) "
          f"kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound} ({bound_by}) "
          f"bound/kernel={bound / ms} library_ms=null")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "body": body}


def body_text(body: dict) -> str:
    """A compress body as ``kernel_body`` reports it, in words."""
    return (f"{body['body']}, cluster of {body['ctas']} CTA(s), {body['threads']} threads "
            f"of {body['values']} values a CTA")


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
        cfg = get_config(args.arch)  # the CLI's model (launch/train.py::build_llm)
        share = pod_step_share(f"llm-{tag}", cfg, llm_hybrid(cfg, n_tower=1, remat=False), args,
                               out["steps"] / out["wall_s"])
        summary[tag] = {**share, "steps_per_s": out["steps"] / out["wall_s"],
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
    launch each). A Mamba-1 layer (falcon-mamba) adds a discretize launch
    before each scan, and a discretize backward and a sum launch after
    each backward scan. With none (whisper: dense towers) nothing else
    launches."""
    exchanges = (args.steps // args.p) * (args.p // args.q)
    out = {"fused_compress": groups * exchanges}
    if layers:
        per_step = 2 * (layers + 1) * args.steps * args.pods
        out.update(ssm_scan=per_step + 2 * args.pods * exchanges, ssm_scan_bwd=per_step)
        if get_config(args.arch).ssm_version == 1:
            out.update(mamba1_discretize=out["ssm_scan"], mamba1_discretize_bwd=per_step,
                       mamba1_discretize_sum=per_step)
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
                     cli_argv=None, hold_messages=False, cfg=None):
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
    profiled, for the busy share. With ``cfg`` (the model's config), the
    traced FLOPs of one pod-step and the run's share of the fp32 peak."""
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
    share = pod_step_share(tag, cfg, model, args, steps / wall_s) if cfg is not None else {}
    del state, params
    return {"steps_per_s": steps / wall_s, "peak_device_bytes": peak, "busy_share": busy,
            "kernels_per_step": kernels, "launches": counts, "messages_max_abs_err": msg_err,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]), **share}


def check_ssm_training(device):
    """Phases 3n (zamba2-2.7b at full width through the CLI) and 3o
    (falcon-mamba-7b at its published widths, depth cut to
    FALCON_TRAIN_LAYERS, through ``LLMRoundRunner`` as the CLI builds it)."""
    summary = {}
    argv = ["--arch", HYBRID_ARCH] + TRAIN_ARGV + ["--device", "cuda"]
    summary[HYBRID_ARCH] = check_train_cell("train-hybrid", device, parse_args(argv),
                                            TRAIN_CELLS[HYBRID_ARCH], cli_argv=argv,
                                            cfg=get_config(HYBRID_ARCH))
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
                                     batch_fn, cfg=cfg)
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


def serve_batch(tag, cfg, params, prompts, args):
    """One request batch of ``prompts`` through the engine ``args`` describe
    (``serve.build_engine``, ``serve.run_engine``), the launch counters
    zeroed just before and read just after: (report with the peak device
    bytes of the run, tokens, launches); tokens checked in [0, V)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    report, tokens = serve.run_engine(serve.build_engine(cfg, params, args), prompts, None, args)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    report["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    del report["requests"]
    print(f"[{tag}] launches={counts} prefill_s={report['prefill_s']} "
          f"ms_per_decode_step={report['ms_per_decode_step']} "
          f"decode_tok_per_s={report['decode_tok_per_s']} "
          f"executors={report['compiled_executors']} speculative={report.get('speculative')} "
          f"peak_device_bytes={report['peak_device_bytes']} "
          f"peak_device_GiB={report['peak_device_bytes'] / 2 ** 30}")
    check(report["generated_tokens"] == args.batch * args.gen,
          f"{tag}: generated {report['generated_tokens']} tokens")
    check(len(tokens) == args.batch and all(
        len(t) == args.gen and all(0 <= x < cfg.vocab_size for x in t) for t in tokens),
        f"{tag}: tokens out of [0, V)")
    return report, tokens, counts


def profile_batch(tag, cfg, params, prompts, args):
    """One more request batch through a fresh engine, under torch.profiler
    (``profile_serve.profile_window``): the busy share of its wall time and
    device ms by kernel class: the kernels launched inside each of
    ``models/moe.py``'s profiler ranges (dispatch, expert products,
    combine; zero outside the MoE family), and by name flash, GEMMs (the
    expert products' among them) and the rest."""
    engine = serve.build_engine(cfg, params, args)
    win = profile_serve.profile_window(lambda: engine.generate(list(prompts), args.gen))
    ms = {key[:-3] + "_ms": win[key] / 1e3 for key in win if key.endswith("_us")
          and key != "top_kernels_us"}
    out = {"busy_share": win["device_busy_share"], "profiled_wall_s": win["profiled_wall_s"],
           "kernels": win["kernels"], **ms}
    print(f"[{tag}] profiled request batch: wall {win['profiled_wall_s']} s, device busy "
          f"{win['device_busy_s']} s (share {win['device_busy_share']}), {win['kernels']} "
          f"kernels; device ms by class {ms}; top kernels (us) {win['top_kernels_us']}")
    return out


def check_moe_serving(device):
    """Phases 3s and 3t: grok-1-314b (2 of 64 layers) and deepseek-v3-671b
    (3 dense + 1 MoE layer of 61) at their published widths, each built as
    ``get_config(arch).replace(num_layers=...)`` with its weights drawn from
    the seed on the card, served through ``build_inputs``, ``build_engine``
    and ``run_engine`` with the CLI's flags. grok (bf16 caches): exactly one
    flash launch a layer (the fresh 4096-token block) and no other kernel,
    plainly and with --spec-gamma 4 and a 1-layer draft, whose tokens equal
    the plain ones. deepseek (bf16, then int8 caches): no kernel of the port
    (MLA attends through its absorbed weights, never flash). Each: prefill
    seconds, ms a decode step, peak device bytes, then a profiled request
    batch for the busy share and device ms by kernel class."""
    out = {}
    cells = ((GROK_ARCH, GROK_LAYERS, GROK_SERVE_ARGV, ("bf16",)),
             (DEEPSEEK_ARCH, DEEPSEEK_LAYERS, DEEPSEEK_SERVE_ARGV, ("bf16", "int8")))
    for arch, layers, argv, caches in cells:
        cfg = get_config(arch).replace(num_layers=layers)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        args = serve.parse_args(argv)
        t0 = time.perf_counter()
        params, prompts, _ = serve.build_inputs(cfg, args.batch, args.prompt_len, args.seed,
                                                device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"[serve-{arch}] {layers} of {get_config(arch).num_layers} layers at published "
              f"widths: {n_params} params ({4 * n_params} bytes in fp32) drawn on the card in "
              f"{init_s} s; allocated before them {before} bytes")
        cell = {"init_s": init_s, "params": n_params}
        for cache in caches:
            args = serve.parse_args(argv + ["--cache-dtype", cache])
            tag = f"serve-{arch}-{cache}"
            report, tokens, counts = serve_batch(tag, cfg, params, prompts, args)
            want = {"flash_attention": layers} if arch == GROK_ARCH else {}
            check(counts == want, f"{tag}: launches {counts}, expected {want} and no other")
            cell[cache] = {k: report[k] for k in ("prefill_s", "ms_per_decode_step",
                                                  "decode_tok_per_s", "peak_device_bytes")}
            cell[cache]["launches"] = counts
            if arch == GROK_ARCH:
                args.spec_gamma, args.spec_draft_layers = 4, GROK_DRAFT_LAYERS
                spec, spec_tokens, spec_counts = serve_batch(f"{tag}-spec", cfg, params,
                                                                 prompts, args)
                check(spec_counts == want,
                      f"{tag} spec: launches {spec_counts}, expected {want} and no other")
                if spec_tokens != tokens:
                    check_same_tokens(f"{tag}-spec", cfg, params, prompts, tokens, spec_tokens)
                cell["spec"] = {"acceptance": spec["speculative"]["acceptance"],
                                "ms_per_token": spec["ms_per_decode_step"],
                                "launches": spec_counts}
                args.spec_gamma = 0
            cell[cache].update(profile_batch(tag, cfg, params, prompts, args))
            del report, tokens
        out[arch] = cell
        del params
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def router_picks():
    """Yield a list that gets (probabilities [T, E], expert ids [T, k]) of
    every router call, on the CPU."""
    route, picks = M.route, []

    def recorded(*args, **kwargs):
        probs, gate, idx = route(*args, **kwargs)
        picks.append((probs.detach().cpu(), idx.cpu()))
        return probs, gate, idx

    M.route = recorded
    try:
        yield picks
    finally:
        M.route = route


def check_router_ids(tag, want, got):
    """The card's router picks ``got`` against the CPU's ``want``, call by
    call: expert ids equal, except where the CPU's probabilities at the
    first rank that differs and the next lie within ROUTER_TIE (a near-tie
    an ulp of the router's logits can flip). Returns the rows that
    differed."""
    check(len(got) == len(want), f"{tag}: {len(got)} router calls, the CPU made {len(want)}")
    flipped = 0
    for (p_cpu, i_cpu), (_, i_card) in zip(want, got):
        check(i_card.shape == i_cpu.shape, f"{tag}: router ids {tuple(i_card.shape)} against "
                                           f"{tuple(i_cpu.shape)}")
        for row in torch.nonzero((i_card != i_cpu).any(dim=-1)).flatten().tolist():
            rank = int(torch.nonzero(i_card[row] != i_cpu[row])[0])
            srt = torch.sort(p_cpu[row], descending=True).values
            gap = float(srt[rank] - srt[rank + 1])
            print(f"[{tag}] router row {row}: ids cpu {i_cpu[row].tolist()} card "
                  f"{i_card[row].tolist()}, probabilities at rank {rank} and {rank + 1} "
                  f"{gap} apart")
            check(gap <= ROUTER_TIE, f"{tag}: expert ids differ at row {row} where the "
                                     f"probabilities are {gap} apart (> {ROUTER_TIE})")
            flipped += 1
    return flipped


def check_moe_training(device):
    """Phase 3u: ``--arch grok-1-314b|deepseek-v3-671b --smoke`` training
    through the CLI (``check_train_cell`` on TRAIN_CELLS' pins: exactly
    exchanges x row groups compress launches and no other kernel, the first
    exchange's groups held torch.equal against plain, losses falling within
    every exchange interval), then 2 rounds from one CPU-drawn model on the
    card and on the CPU: per-step losses within rtol 1e-3."""
    out = {}
    for arch in MOE_ARCHS:
        argv = ["--arch", arch, "--smoke"] + TRAIN_ARGV + ["--device", "cuda"]
        out[arch] = check_train_cell(f"train-{arch}", device, parse_args(argv),
                                     TRAIN_CELLS[arch], cli_argv=argv, hold_messages=True)
        reset_launch_counts()
        l_cpu, l_card = same_start_llm(torch.device("cpu"), device, arch=arch)
        rel = float(((l_card - l_cpu).abs() / l_cpu.abs()).max())
        print(f"[parity-train-{arch}] launches on the card={dict(launch_counts)} "
              f"cpu={l_cpu.tolist()} cuda={l_card.tolist()} max_rel_diff={rel}")
        check(launch_counts["fused_compress"] > 0,
              f"{arch}: the card's training parity run skipped the compress kernel")
        check(torch.allclose(l_card, l_cpu, rtol=1e-3, atol=0.0),
              f"{arch} training: card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")
        out[arch]["parity_max_rel"] = rel
    return out


def check_vlm_serving(device):
    """Phase 3v: qwen2-vl-72b at its published widths with VLM_LAYERS of its
    80 layers (``get_config(arch).replace(num_layers=...)``, weights drawn
    from the seed on the card), served text only through ``build_inputs``,
    ``build_engine`` and ``run_engine`` with VLM_SERVE_ARGV: exactly one
    flash launch a layer (the fresh 4096-token block, K and V repeated to
    the 64 heads: [128, 4096, 128]) and no other kernel, plainly and with
    --spec-gamma 4 and a 1-layer draft, whose tokens equal the plain ones;
    prefill seconds, ms a decode step, peak device bytes and a profiled
    request batch. Then one ``torch.no_grad()`` ``T.lm_loss`` at the same
    weights over VLM_PATCHES patch embeddings (a 32 x 32 grid of ids) and
    VLM_TEXT tokens: finite, no kernel of the port (2048 keys take the
    plain route), its seconds."""
    cfg = get_config(VLM_ARCH).replace(num_layers=VLM_LAYERS)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    args = serve.parse_args(VLM_SERVE_ARGV)
    t0 = time.perf_counter()
    params, prompts, extra = serve.build_inputs(cfg, args.batch, args.prompt_len, args.seed,
                                                device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(extra is None, "qwen2-vl serving drew patch embeddings: it serves text only")
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[serve-{VLM_ARCH}] {VLM_LAYERS} of {get_config(VLM_ARCH).num_layers} layers at "
          f"published widths: {n_params} params ({4 * n_params} bytes in fp32) drawn on the card "
          f"in {init_s} s; allocated before them {before} bytes")
    tag = f"serve-{VLM_ARCH}"
    want = {"flash_attention": VLM_LAYERS}
    report, tokens, counts = serve_batch(tag, cfg, params, prompts, args)
    check(counts == want, f"{tag}: launches {counts}, expected {want} and no other")
    cell = {"init_s": init_s, "params": n_params, "launches": counts}
    cell.update({k: report[k] for k in ("prefill_s", "ms_per_decode_step", "decode_tok_per_s",
                                        "peak_device_bytes")})
    args.spec_gamma, args.spec_draft_layers = 4, VLM_DRAFT_LAYERS
    spec, spec_tokens, spec_counts = serve_batch(f"{tag}-spec", cfg, params, prompts, args)
    check(spec_counts == want, f"{tag} spec: launches {spec_counts}, expected {want} and no other")
    if spec_tokens != tokens:
        check_same_tokens(f"{tag}-spec", cfg, params, prompts, tokens, spec_tokens)
    cell["spec"] = {"acceptance": spec["speculative"]["acceptance"],
                    "ms_per_token": spec["ms_per_decode_step"], "launches": spec_counts}
    args.spec_gamma = 0
    cell.update(profile_batch(tag, cfg, params, prompts, args))
    del report, tokens, spec, spec_tokens
    rng = np.random.RandomState(args.seed)
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, VLM_TEXT))
                                        .astype(np.int32)).to(device),
             "labels": torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, VLM_TEXT))
                                        .astype(np.int32)).to(device),
             "extra_embeds": torch.from_numpy(rng.randn(1, VLM_PATCHES, cfg.d_model)
                                              .astype(np.float32)).to(device)}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = float(T.lm_loss(cfg, params, batch, remat=False))
    loss_s = time.perf_counter() - t0
    counts = dict(launch_counts)
    print(f"[{tag}-patches] lm_loss over {VLM_PATCHES} patch embeddings (grid ids up to "
          f"{int(np.sqrt(VLM_PATCHES)) - 1}) and {VLM_TEXT} tokens: {loss} in {loss_s} s, "
          f"launches={counts}")
    check(math.isfinite(loss), f"{tag}: lm_loss over patches is {loss}")
    check(not counts, f"{tag}: lm_loss over {VLM_PATCHES + VLM_TEXT} positions launched {counts}")
    cell["patch_loss"], cell["patch_loss_s"] = loss, loss_s
    del params, batch
    torch.cuda.empty_cache()
    return cell


def check_vlm_training(device, bw, flops):
    """Phases 3w and 3x. 3w: ``--arch qwen2-vl-72b --smoke`` training through
    the CLI (``check_train_cell`` on TRAIN_CELLS' pins: exactly exchanges x
    row groups compress launches and no other kernel, the first exchange's
    group held torch.equal against plain, losses falling within every
    exchange interval). 3x: one published-width layer at one pod
    (VLM_TRAIN_ARGV, built as the CLI builds it, through
    ``LLMRoundRunner.run_fixed``): the launches VLM_TRAIN_CELL pins, steps/s
    and peak device bytes, then one more round with every row group held
    torch.equal against plain as it is made and each launch timed by CUDA
    events beside its bound (the head's [8192, 152064] among them)."""
    out = {}
    argv = ["--arch", VLM_ARCH, "--smoke"] + TRAIN_ARGV + ["--device", "cuda"]
    out["smoke"] = check_train_cell(f"train-{VLM_ARCH}", device, parse_args(argv),
                                    TRAIN_CELLS[VLM_ARCH], cli_argv=argv, hold_messages=True)
    torch.cuda.empty_cache()
    args = parse_args(VLM_TRAIN_ARGV + ["--device", "cuda"])
    cfg = get_config(VLM_ARCH).replace(num_layers=VLM_TRAIN_LAYERS)
    model = llm_hybrid(cfg, n_tower=1, remat=False)
    params = init_llm_params(torch.Generator(device=device).manual_seed(args.seed), model,
                             n_pods=args.pods)
    batch_fn = llm_batch_fn(cfg, args.batch, args.seq, n_pods=args.pods, seed=args.seed,
                            device=device)
    tag = f"train-{VLM_ARCH}-full"
    out["full"] = check_train_cell(tag, device, args, VLM_TRAIN_CELL, model, params, batch_fn)
    fn = LLMRoundRunner(model, n_pods=args.pods).round_fn(
        args.p, args.q, args.compression_k, args.quantization, collect_stats=False)
    lam = args.p // args.q
    with checked_groups(bw, flops) as seen:
        params, _ = fn(params, batch_fn(0, lam), args.lr)
        torch.cuda.synchronize()
    groups = VLM_TRAIN_CELL[1]
    check(len(seen) == lam * groups, f"{tag}: {len(seen)} groups checked, expected {lam * groups}")
    for shape, ms, bound in seen:
        print(f"[{tag}] group {list(shape)}: torch.equal to plain; kernel ms (CUDA events around "
              f"the launch) {ms} bound_ms {bound} bound/kernel {bound / ms}")
    out["full"]["groups_ms"] = {str(list(shape)): (ms, bound) for shape, ms, bound in seen}
    del params
    torch.cuda.empty_cache()
    return out


def check_vlm_parity(device):
    """Phase 4l: the card against the CPU at qwen2-vl-72b's smoke widths:
    first-step logits after a VLM_PARITY_LEN-token prompt (flash on the
    card) within 1e-4 of the largest |logit| and equal greedy tokens;
    ``lm_loss`` over 4 and 8 patch embeddings within rtol 1e-5; 2 training
    rounds from one CPU-drawn model within rtol 1e-3."""
    reset_launch_counts()
    (lg_cpu, tok_cpu), (lg_card, tok_card) = serve_parity(
        VLM_ARCH, VLM_PARITY_LEN, VLM_PARITY_GEN, torch.device("cpu"), device)
    logits_rel = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
    print(f"[parity-serve-{VLM_ARCH}] launches on the card={dict(launch_counts)} logits max "
          f"|card - cpu| / max |cpu| = {logits_rel} tokens cpu={tok_cpu} cuda={tok_card}")
    check(launch_counts["flash_attention"] > 0, f"{VLM_ARCH}: the card's parity run skipped "
                                                f"the kernel")
    check(logits_rel <= 1e-4, f"{VLM_ARCH}: first-step logits differ by {logits_rel} relative "
                              f"(> 1e-4)")
    check(tok_card == tok_cpu, f"{VLM_ARCH}: card and CPU greedy tokens differ")
    cfg = get_config(VLM_ARCH, smoke=True)
    params = L.init_params(T.model_specs(cfg), torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    losses = {}
    for P in (4, 8):
        batch = {"tokens": rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32),
                 "labels": rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32),
                 "extra_embeds": rng.randn(2, P, cfg.d_model).astype(np.float32)}
        got = []
        for dev in (torch.device("cpu"), device):
            on = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            with torch.no_grad():
                got.append(float(T.lm_loss(cfg, tree_map(lambda t: t.to(dev), params), on)))
        rel = abs(got[1] - got[0]) / abs(got[0])
        print(f"[parity-loss-{VLM_ARCH}] {P} patches: lm_loss cpu={got[0]} cuda={got[1]} "
              f"rel={rel}")
        check(rel <= 1e-5, f"{VLM_ARCH}: lm_loss over {P} patches differs by {rel} (> 1e-5)")
        losses[P] = rel
    reset_launch_counts()
    l_cpu, l_card = same_start_llm(torch.device("cpu"), device, arch=VLM_ARCH)
    rel = float(((l_card - l_cpu).abs() / l_cpu.abs()).max())
    print(f"[parity-train-{VLM_ARCH}] launches on the card={dict(launch_counts)} "
          f"cpu={l_cpu.tolist()} cuda={l_card.tolist()} max_rel_diff={rel}")
    check(launch_counts["fused_compress"] > 0,
          f"{VLM_ARCH}: the card's training parity run skipped the compress kernel")
    check(torch.allclose(l_card, l_cpu, rtol=1e-3, atol=0.0),
          f"{VLM_ARCH} training: card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")
    return {"logits_rel": logits_rel, "loss_rel": losses, "train_max_rel": rel}


# ---------------------------------------------------------------------------
# Scale-out: the pod-step's FLOPs, the program set, the one-rank mesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def pod_step_share(tag, cfg, model, args, steps_per_s):
    """Print and return the traced FLOPs (``launch/flops.py``) of one
    pod-step of an LLM run (``make_hsgd_train_step`` on one pod's batch of
    ``args``' shape, on meta tensors) and the run's achieved share of the
    fp32 peak: pods x pod-step FLOPs x steps/s, the steps/s of the whole
    run (exchanges and aggregations included), over 67 TFLOP/s."""
    batch = tree_map(lambda t: t[0, 0].to("meta"),
                     llm_batch_fn(cfg, args.batch, args.seq, n_pods=1, seed=args.seed)(0, 1))
    params = {k: L.abstract_params(s, torch.float32) for k, s in model.specs().items()}
    stale, _ = llm_steps.hybrid_stale_inputs(model, cfg.replace(dtype="float32"), batch)
    flops = traced_flops(llm_steps.make_hsgd_train_step(model), params, stale, batch)
    achieved = flops.total * args.pods * steps_per_s
    print(f"[{tag}] one pod-step (batch {args.batch} x seq {args.seq}): traced FLOPs "
          f"{flops.total} (matmul {flops.matmul}; launch/flops.py); {args.pods} pod-steps a "
          f"step at {steps_per_s} steps/s: {achieved / 1e12} TFLOP/s, {achieved / FP32_PEAK} "
          f"of the fp32 peak (67 TFLOP/s); card {smi_line()}")
    return {"pod_step_flops": flops.total, "pod_step_matmul_flops": flops.matmul,
            "fp32_peak_share": achieved / FP32_PEAK}


def program_args(cfg, progs, name, gen, device):
    """Real inputs at a program's meta shapes (a dense arch): the weights
    drawn from ``gen`` (on its device) in ``cfg``'s dtype, token ids uniform
    in the vocabulary, zero caches with the sentinel positions;
    train_step's stale context is the exchange program's message on the
    same weights and batch, and global_agg's params lead with [1]."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    ids = lambda x: torch.randint(0, cfg.vocab_size, tuple(x.shape), generator=gen,
                                  device=gen.device, dtype=torch.int32).to(device)
    if name == "serve_step":
        meta = progs.entries[name][1][1]
        batch = {"tokens": ids(meta["tokens"])}
        if "caches" in meta:
            batch["caches"] = T.init_decode_caches(cfg, meta["tokens"].shape[0],
                                                   meta["caches"]["kv"][0].shape[2], dt, device)
        return L.init_params(T.model_specs(cfg), gen, dt, device), batch
    params = llm_steps.make_hybrid(cfg).init(gen, dt, device)
    if name == "global_agg":
        return (tree_map(lambda x: x.unsqueeze(0), params),)
    batch = map_structure(ids, progs.entries["exchange"][1][1])
    if name == "exchange":
        return params, batch
    return params, progs.entries["exchange"][0](params, batch), batch


def run_program(cfg, shape_name, name, B, device):
    """One program of gemma3-1b's set at global batch ``B``: traced FLOPs on
    meta tensors, then a warm-up call and a timed one (synchronised wall
    clock) on real tensors, no kernel of the port launching."""
    shape = dataclasses.replace(INPUT_SHAPES[shape_name], global_batch=B)
    progs = llm_steps.build_programs(cfg, shape)
    fn, metas, _ = progs.entries[name]
    flops = traced_flops(fn, *(map_structure(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), a) for a in metas))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    args = program_args(cfg, progs, name, torch.Generator(device=device).manual_seed(0), device)
    reset_launch_counts()
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    check(not any(launch_counts.values()), f"{shape_name} {name}: launches {dict(launch_counts)}")
    # the logits, the loss, the message or the aggregate: not the caches
    # (written in place, and at decode_32k an fp32 view of them is 52 GiB)
    head = {"serve_step": lambda o: o[0] if isinstance(o, tuple) else o,
            "train_step": lambda o: o[1]}.get(name, lambda o: o)(out)
    check(all(bool(torch.isfinite(x).all()) for x in structure_leaves(head)
              if x.is_floating_point()), f"{shape_name} {name}: non-finite output")
    fixed = sum(x.numel() * x.element_size() for x in structure_leaves(args[0]))
    del args, out, head
    return {"ms": ms, "flops": flops.total, "matmul_flops": flops.matmul, "peak_bytes": peak,
            "bytes_before": before, "weight_bytes": fixed}


def check_programs(device):
    """Phase 3y: every program of gemma3-1b's set at its published widths,
    the global batch halved from PROGRAM_BATCH on out-of-memory."""
    cfg = get_config(PROGRAM_ARCH)
    capacity = torch.cuda.get_device_properties(device).total_memory
    summary = {}
    for shape_name, shape in INPUT_SHAPES.items():
        own = shape.global_batch
        for name in llm_steps.build_programs(cfg, shape).entries:
            B, ooms = PROGRAM_BATCH.get((shape_name, name), own), []
            while True:
                try:
                    res = run_program(cfg, shape_name, name, B, device)
                    break
                except torch.cuda.OutOfMemoryError as e:
                    ooms.append([B, str(e).splitlines()[0][:160]])
                torch.cuda.empty_cache()
                check(B > 1, f"{shape_name} {name}: out of memory at batch 1")
                B //= 2
            torch.cuda.empty_cache()
            if shape_name.startswith("decode"):  # the caches alone, exactly
                metas = llm_steps.build_programs(cfg, INPUT_SHAPES[shape_name]).entries[name][1]
                own_bytes = sum(x.numel() * x.element_size()
                                for x in structure_leaves(metas[1]["caches"]))
                how = "the caches alone"
            else:  # the measured peak, its part past the weights scaled to the own batch
                fixed = res["bytes_before"] + res["weight_bytes"]
                own_bytes = fixed + (res["peak_bytes"] - fixed) * own / B
                how = "the measured peak past the weights, scaled"
            tflops = res["flops"] / (res["ms"] / 1e3) / 1e12
            # an out-of-memory at twice the batch, or an own batch past the card
            cut = ("none" if B == own else "memory" if ooms or own_bytes > capacity
                   else "the script's time limit")
            print(f"[programs] {shape_name} {name}: batch {B} of {own}, cut for {cut} (own "
                  f"batch needs {own_bytes} bytes by {how}; the card holds {capacity}; out of "
                  f"memory at {ooms}) seq {INPUT_SHAPES[shape_name].seq_len}: {res['ms']} ms, traced "
                  f"FLOPs {res['flops']} (matmul {res['matmul_flops']}), {tflops} TFLOP/s, "
                  f"{tflops * 1e12 / BF16_PEAK} of the bf16 peak (989 TFLOP/s), peak "
                  f"{res['peak_bytes']} bytes; card {smi_line()}")
            summary[f"{shape_name}/{name}"] = {**res, "global_batch": B, "own_batch": own,
                                               "own_batch_bytes": own_bytes, "ooms": ooms,
                                               "cut_for": cut,
                                               "tflops": tflops,
                                               "bf16_peak_share": tflops * 1e12 / BF16_PEAK}
    return summary


def check_program_parity(device):
    """Phase 4m: each program's outputs at gemma3-1b's smoke widths (fp32),
    the same inputs on the CPU and on the card."""
    cfg = get_config(PROGRAM_ARCH, smoke=True).replace(dtype="float32")
    worst = {}
    for shape_name, (seq, B) in PROGRAM_PARITY.items():
        shape = dataclasses.replace(INPUT_SHAPES[shape_name], seq_len=seq, global_batch=B)
        progs = llm_steps.build_programs(cfg, shape)
        for name, (fn, _, _) in progs.entries.items():
            args = program_args(cfg, progs, name, torch.Generator().manual_seed(0), "cpu")
            card_args = map_structure(lambda t: t.to(device, copy=True), args)
            want, got = structure_leaves(fn(*args)), structure_leaves(fn(*card_args))
            check(len(want) == len(got), f"{shape_name} {name}: output trees differ")
            if name == "train_step":  # (params..., loss)
                rel = abs(float(got[-1]) - float(want[-1])) / abs(float(want[-1]))
                check(rel <= 1e-4, f"{shape_name} train_step: loss differs by {rel} (> 1e-4)")
                want, got = want[:-1], got[:-1]
            tol = {"train_step": 1e-5, "global_agg": 1e-6}.get(name, 1e-4)
            err = 0.0
            for w, g in zip(want, got):
                if not w.is_floating_point():
                    check(torch.equal(w, g.cpu()), f"{shape_name} {name}: integer leaf differs")
                    continue
                scale = max(float(w.abs().max()), 1e-30)
                err = max(err, float((g.cpu() - w).abs().max()) / scale)
            print(f"[parity-programs] {shape_name} {name}: max |card - cpu| / max |cpu| = {err} "
                  f"(tolerance {tol})")
            check(err <= tol, f"{shape_name} {name}: card and CPU differ by {err} (> {tol})")
            worst[f"{shape_name}/{name}"] = err
    return worst


def check_one_rank_mesh(device):
    """Phase 3z: a one-rank NCCL process group and a (1, 1) [data, model]
    mesh; the main path's run on it equals the run without it bit for bit
    (a trivial mesh shards nothing, as in the reference)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = CKPT_DIR.parent / "chip_smoke_nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        plain, = same_start_losses(device)
        meshed, = same_start_losses(device, mesh=mesh)
        chained = chained_losses(device, mesh)
        private_plain = same_start_private_adaptive(device)
        reset_launch_counts()
        private_mesh = same_start_private_adaptive(device, mesh=mesh)
        counts = dict(launch_counts)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    print(f"[mesh] one-rank NCCL mesh {mesh}: losses {meshed.tolist()}, without the mesh "
          f"{plain.tolist()}")
    check(torch.equal(plain, meshed), "the one-rank mesh changed the main path's losses")
    print(f"[mesh] two chained run(rounds=1, mesh=) calls: {chained.tolist()}")
    check(torch.equal(chained, plain), "chained one-round runs on the mesh differ from "
                                       "run(rounds=2)")
    (lp, plans_p), (lm, plans_m) = private_plain, private_mesh
    print(f"[mesh] adaptive with DP (C=1, σ=1) and secure aggregation on the mesh: "
          f"launches={counts} plans={plans_m} losses={lm.tolist()}; without the mesh "
          f"plans={plans_p} losses={lp.tolist()}")
    check(counts.get("fused_compress_dp", 0) == len(plans_m) > 0 and
          not counts.get("fused_compress"),
          f"the private adaptive run on the mesh launched {counts}, expected one DP "
          f"compress a round ({len(plans_m)})")
    check(plans_m == plans_p and torch.equal(lm, lp),
          "the private legs on the one-rank mesh differ from the run without it")
    return {"losses": meshed.tolist(), "chained": chained.tolist(),
            "private_launches": counts}


def chained_losses(device, mesh):
    """``same_start_losses``' run, as PARITY_ROUNDS chained one-round
    ``run(rounds=1, mesh=)`` calls, each taking the state the one before
    returned."""
    args = parse_args(MAIN_ARGV)
    gen = torch.Generator().manual_seed(args.seed)
    model, fed, train, data, w, _ = setup_ehealth(args, device)
    runner, eff_fed = make_runner(args.algorithm, model, fed, train)
    init = model.init(gen)
    parts = torch.stack([F.sample_participants(gen, eff_fed)
                         for _ in range(PARITY_ROUNDS * eff_fed.lam)])
    state = init_state(torch.Generator(), model, eff_fed, data,
                       params=tree_map(lambda t: t.to(device), init))
    out = []
    for r in range(PARITY_ROUNDS):
        state, losses = runner.run(state, data, w, 1, mesh=mesh,
                                   participants=parts[r * eff_fed.lam:(r + 1) * eff_fed.lam])
        out.append(losses.cpu())
    return torch.cat(out)


def same_start_private_adaptive(device, mesh=None):
    """The adaptive run of ``same_start_adaptive`` with the private legs on
    (DP with C = 1, σ = 1 under an ε budget of 25, secure aggregation), on
    ``mesh`` when one is given: (losses, the (P, Q, rung, dp_rung) of each
    round). The DP noise comes from the run's own seeded generator."""
    args = parse_args(MAIN_ARGV)
    gen = torch.Generator().manual_seed(args.seed)
    model, fed, train, data, w, _ = setup_ehealth(args, device)
    runner, eff_fed = make_runner(args.algorithm, model, fed, train)
    init = model.init(gen)
    parts = torch.stack([F.sample_participants(gen, eff_fed)
                         for _ in range(ADAPTIVE_PARITY_STEPS)])
    state = init_state(torch.Generator().manual_seed(args.seed), model, eff_fed, data,
                       params=tree_map(lambda t: t.to(device), init))
    cfg = AdaptiveConfig(total_steps=ADAPTIVE_PARITY_STEPS, init_probe=False,
                         max_interval=args.max_interval, eta_max=max(args.lr * 10, 0.05),
                         ladder=ladder_from(runner.train.compression_k,
                                            runner.train.quantization_bits),
                         dp_clip=1.0, dp_sigma=1.0, privacy_budget=25.0, secure_agg=True)
    res = AdaptiveHSGDRunner(model, fed, runner.train, cfg).run(
        state, data, w, participants=parts, mesh=mesh)
    return (torch.from_numpy(res.losses),
            [(h["P"], h["Q"], h["rung"], h["dp_rung"]) for h in res.history])


def main_path_steps_per_s(device):
    """The main path (phase 3's run: MAIN_ARGV, MAIN_ROUNDS rounds) through
    ``HSGDRunner.run`` on the fused compress kernel and on the legacy sort
    path: a warm-up round of each drained, then SORT_REPS turns of one run
    each from the same start, in alternating order, each timed to a
    ``torch.cuda.synchronize()``. Per path: (best steps/s, the last run's
    losses, launches of its timed runs, executors built)."""
    args = parse_args(MAIN_ARGV + ["--device", "cuda", "--rounds", str(MAIN_ROUNDS)])
    model, fed, train, data, w, _ = setup_ehealth(args, device)
    runner, eff_fed = make_runner(args.algorithm, model, fed, train)
    runners = {fused: dataclasses.replace(runner, fused_compression=fused, _round_cache={})
               for fused in (True, False)}
    fresh = lambda: init_state(torch.Generator().manual_seed(args.seed), model, eff_fed, data)
    for r in runners.values():
        r.run(fresh(), data, w, 1)  # warm-up: builds the bucket's executor
    torch.cuda.synchronize()
    best = {fused: math.inf for fused in runners}
    losses, counts = {}, {fused: {} for fused in runners}
    for rep in range(SORT_REPS):
        for fused in ((True, False) if rep % 2 == 0 else (False, True)):
            state = fresh()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            state, losses[fused] = runners[fused].run(state, data, w, MAIN_ROUNDS)
            torch.cuda.synchronize()
            best[fused] = min(best[fused], time.perf_counter() - t0)
            for key, n in launch_counts.items():
                counts[fused][key] = counts[fused].get(key, 0) + n
    return {fused: (MAIN_ROUNDS * args.p / best[fused], losses[fused].cpu(), counts[fused],
                    len(runners[fused]._round_cache)) for fused in runners}


def check_sort_path(device, bw, flops):
    """Phase 3za: the legacy sort path (``torch.topk`` + a separate quantize,
    leaf by leaf) on the card: the main path trains on it with its losses
    falling and launches no kernel of the port; its steps/s beside the fused
    run's; ``exchange(fused=False)`` refuses DP; and the two timed against
    each other by CUDA events at the main path's message and at the LLM
    shapes."""
    args = parse_args(MAIN_ARGV)
    lam = args.p // args.q
    runs = {}
    for fused, (sps, losses, counts, built) in main_path_steps_per_s(device).items():
        runs["fused" if fused else "sort"] = {"steps_per_s": sps, "launches": counts,
                                              "executors": built}
        first, last = float(losses[:4].mean()), float(losses[-4:].mean())
        tag = "fused" if fused else "sort"
        print(f"[sort-path] main path, {tag}: best of {SORT_REPS} steps/s={sps} "
              f"launches={counts} executors={built} first-4 mean {first} last-4 mean {last}")
        check(all(math.isfinite(float(v)) for v in losses) and last < first,
              f"{tag} main path: loss did not fall ({first} -> {last})")
        check(built == 1, f"{tag} main path built {built} executors, expected 1")
        want = {"fused_compress": SORT_REPS * MAIN_ROUNDS * lam} if fused else {}
        check(counts == want, f"{tag} main path launches {counts}, expected {want}")
    print(f"[sort-path] steps/s fused={runs['fused']['steps_per_s']} "
          f"sort={runs['sort']['steps_per_s']} "
          f"fused/sort={runs['fused']['steps_per_s'] / runs['sort']['steps_per_s']}")

    model, fed, train, data, _, _ = setup_ehealth(args, device)
    runner, eff_fed = make_runner(args.algorithm, model, fed, train)
    state = init_state(torch.Generator().manual_seed(args.seed), model, eff_fed, data)
    one = torch.ones((), device=device)
    try:
        exchange(model, state, data, eff_fed, 0.25, 128, fused=False, dp_clip=one, dp_sigma=one)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("fused" in refused, "exchange(fused=False) took dp_clip")
    print(f"[sort-path] exchange(fused=False, dp_clip=1) raises: {refused}")

    # the main path's message, as each path compresses it
    state = exchange(model, state, data, eff_fed)  # uncompressed
    msg = {"theta0": state.stale["theta0"], "z1": state.stale["z1"], "z2": state.stale["z2"]}
    mat, k_rows, len_rows, _ = stack_rows(tree_leaves(msg), 0.25)
    times = {"message": {
        "shape": list(mat.shape),
        "sort_ms": event_median_ms(lambda: tree_map(
            lambda x: compress_message_sort(x, 0.25, 128), msg)),
        "fused_pytree_ms": event_median_ms(lambda: compress_pytree(msg, 0.25, 128)),
        "kernel_ms": event_median_ms(lambda: fused_compress(mat, k_rows, 128, len_rows))}}
    for rows, n in SORT_LLM_SHAPES:
        g = torch.Generator(device=device).manual_seed(rows + n)
        x = torch.randn((rows, n), generator=g, device=device)
        k = max(1, round(0.25 * n))
        sort_out = compress_message_sort(x, 0.25, 128)
        kernel_out = fused_compress(x, k, 128)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(sort_out).all() and torch.isfinite(kernel_out).all()),
              f"sort path or kernel gave non-finite values at [{rows}, {n}]")
        del sort_out, kernel_out
        sort_ms = event_median_ms(lambda: compress_message_sort(x, 0.25, 128))
        kernel_ms = event_median_ms(lambda: fused_compress(x, k, 128))
        bound, bound_by = compress_bound_ms(x, torch.full((rows,), n), 128, bw, flops)
        times[f"{rows}x{n}"] = {"shape": [rows, n], "sort_ms": sort_ms, "kernel_ms": kernel_ms,
                                "bound_ms": bound, "bound_by": bound_by,
                                "kernel_bound_share": bound / kernel_ms,
                                "kernel_body": kernel_body(n)}
        del x
        torch.cuda.empty_cache()
    for key, t in times.items():
        ratio = t["sort_ms"] / t["kernel_ms"]
        print(f"[sort-path] {key} {t['shape']}: CUDA-event medians of {SORT_LAUNCHES} "
              f"launches: sort path (torch.topk + quantize, two calls) {t['sort_ms']} ms, "
              f"compress kernel {t['kernel_ms']} ms, sort/kernel={ratio} {json.dumps(t)}")
    return {"runs": runs, "times": times}


def check_exact_support(device, bw, flops):
    """Phase 3zb: the compress kernel with ``levels=0``
    (``topk_sparsify_cuda``) keeps a superset of the exact top-k support
    (``kernels/ref.py::topk_exact_ref``, a sort), at most k + 8 survivors a
    row, and equals its plain version bit for bit. These are comparison
    launches. At [2900, 128] it is also timed (CUDA graph replays) beside
    its plain version, its bound and ``torch.topk``'s exact top-k."""
    out = {}
    for rows, n, k in EXACT_CASES:
        g = torch.Generator(device=device).manual_seed(rows * n + k)
        x = torch.randn((rows, n), generator=g, device=device)
        got = topk_sparsify_cuda(x, k)
        plain = kernel_ref.topk_sparsify_ref(x, k)
        exact = kernel_ref.topk_exact_ref(x, k) != 0
        torch.cuda.synchronize()
        kept = got != 0
        check(torch.equal(got, plain), f"[{rows}, {n}] k={k}: kernel differs from plain")
        check(not bool((exact & ~kept).any()), f"[{rows}, {n}] k={k}: an exact top-k entry "
                                               f"was dropped")
        most = int(kept.sum(dim=1).max())
        check(most <= k + 8, f"[{rows}, {n}] k={k}: {most} survivors in a row (> k + 8)")
        out[f"{rows}x{n}:k={k}"] = {"max_survivors": most,
                                    "min_survivors": int(kept.sum(dim=1).min())}
    # the last case is the main path's width: time it, with per-row k and
    # lengths already on the card (a CUDA graph captures no host copy)
    k_rows = torch.full((rows,), k, dtype=torch.int32, device=device)
    len_rows = torch.full((rows,), n, dtype=torch.int32, device=device)
    bound, bound_by = compress_bound_ms(x, len_rows, 0, bw, flops)
    timed = {"shape": [rows, n], "k": k,
             "ms": device_ms(lambda: topk_sparsify_cuda(x, k_rows, row_len=len_rows)),
             "plain_ms": device_ms(lambda: kernel_ref.topk_sparsify_ref(x, k_rows)),
             "exact_topk_ms": device_ms(lambda: kernel_ref.topk_exact_ref(x, k)),
             "bound_ms": bound, "bound_by": bound_by}
    out["timed"] = timed
    print(f"[exact-support] kernel keeps the exact top-k support at {json.dumps(out)}")
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
    vlm_cmps = [check_head_rows(device, bw, flops, dp=False, shape=shape)
                for shape in VLM_HEAD_SHAPES]

    # -- phase 2b: the DP kernel against plain, bit for bit ------------------
    main_dp, max_err_dp = check_dp_kernel(mat, k_rows, len_rows, levels, bw, flops, floor_ms)
    head_dp = check_head_rows(device, bw, flops, dp=True)
    max_err = max(max_err, head_cmp["max_abs_err"], audio_head_cmp["max_abs_err"],
                  *(c["max_abs_err"] for c in vlm_cmps))
    max_err_dp = max(max_err_dp, head_dp["max_abs_err"])

    # -- phase 2c: the flash-attention kernel against plain ------------------
    flash_main, max_err_flash, flash_cases = check_flash_kernel(device, name)

    # -- phase 2d: the scan kernel against plain, bit for bit ------------------
    scan_main, max_err_scan = check_scan_kernel(device, name)

    # -- phase 2e: the scan's backward kernel against plain, bit for bit ------
    scan_bwd_main, max_err_scan_bwd = check_scan_bwd_kernel(device, name)

    # -- phase 2f: the Mamba-1 discretize kernels against the eager chain -----
    discretize_main, discretize_bwd_main = check_discretize_kernels(device, name)

    # -- phase 3: the main path -------------------------------------------
    args = parse_args(MAIN_ARGV + ["--device", "cuda", "--rounds", str(MAIN_ROUNDS)])
    reset_launch_counts()
    with compile_guard(track=r"hsgd_", exact={r"hsgd_round": 1}) as guard:
        metrics, losses = run_ehealth(args)  # one executor for its one bucket
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    lam = args.p // args.q
    print(f"[main] launches={counts} steps/s={metrics['steps'] / metrics['wall_s']} "
          f"executors built={dict(guard.by_name)} metrics={json.dumps(metrics)}")
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
    check(counts_ssm == {"ssm_scan": want, "mamba1_discretize": want},
          f"ssm serving path launches {counts_ssm}, expected {want} scan and {want} discretize "
          f"launches and no other")
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

    # -- phases 3s, 3t, 3u: the MoE family, serving at published widths with
    # its depth cut, training at smoke widths --------------------------------
    moe_serve = check_moe_serving(device)
    print(f"[moe-serve-summary] {json.dumps(moe_serve)}")
    moe_train = check_moe_training(device)
    print(f"[moe-train-summary] {json.dumps(moe_train)}")

    # -- phases 3v, 3w, 3x: the VLM family, serving at published widths with
    # its depth cut, training at smoke widths and one published-width layer --
    vlm_serve = check_vlm_serving(device)
    print(f"[vlm-serve-summary] {json.dumps(vlm_serve)}")
    vlm_train = check_vlm_training(device, bw, flops)
    print(f"[vlm-train-summary] {json.dumps(vlm_train)}")

    # -- phases 3y, 3z: scale-out, the program set and the one-rank mesh ----
    programs = check_programs(device)
    print(f"[programs-summary] {json.dumps(programs)}")
    mesh_summary = check_one_rank_mesh(device)
    print(f"[mesh-summary] {json.dumps(mesh_summary)}")

    # -- phases 3za, 3zb: the legacy sort path, the exact-support property ----
    sort_summary = check_sort_path(device, bw, flops)
    print(f"[sort-path-summary] {json.dumps(sort_summary)}")
    exact_summary = check_exact_support(device, bw, flops)

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

    # -- phase 4k: the card against the CPU on the MoE family ----------------
    for arch in MOE_ARCHS:
        picks = []
        for dev in (torch.device("cpu"), device):
            reset_launch_counts()
            with router_picks() as calls:
                (logits, tokens), = serve_parity(arch, MOE_PARITY_LEN, MOE_PARITY_GEN, dev)
            picks.append((logits, tokens, calls, dict(launch_counts)))
        (lg_cpu, tok_cpu, ids_cpu, _), (lg_card, tok_card, ids_card, card_counts) = picks
        rel = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
        print(f"[parity-serve-{arch}] launches on the card={card_counts} logits max |card - cpu| / "
              f"max |cpu| = {rel} tokens cpu={tok_cpu} cuda={tok_card}")
        check(rel <= 1e-4, f"{arch}: first-step logits differ by {rel} relative (> 1e-4)")
        check(tok_card == tok_cpu, f"{arch}: card and CPU greedy tokens differ")
        flipped = check_router_ids(f"parity-router-{arch}", ids_cpu, ids_card)
        print(f"[parity-router-{arch}] {len(ids_cpu)} router calls, "
              f"{sum(int(i.shape[0]) for _, i in ids_cpu)} token rows, {flipped} near-tie flips")

    # -- phase 4l: the card against the CPU on the VLM family -----------------
    vlm_parity = check_vlm_parity(device)
    print(f"[vlm-parity-summary] {json.dumps(vlm_parity)}")

    # -- phase 4m: the card against the CPU on the program set ---------------
    program_parity = check_program_parity(device)
    print(f"[program-parity-summary] {json.dumps(program_parity)}")

    # -- phase 5: summary ----------------------------------------------------
    kernels = [{
        "name": "fused_compress",
        "route": "cuda",
        "source": "src/repro_torch/csrc/compress.cu",
        "replaces": "src/repro/kernels/compress.py:78",
        "launches": counts["fused_compress"] + audio_train["launches"]["fused_compress"] + sum(
            t["launches"].get("fused_compress", 0) for t in twins.values() if "launches" in t)
        + sum(cell["launches"]["fused_compress"] for cell in moe_train.values())
        + sum(cell["launches"]["fused_compress"] for cell in vlm_train.values()),
        "max_abs_err": max_err,
        "ms": main_cmp["ms"],
        "plain_ms": main_cmp["plain_ms"],
        "bound_ms": main_cmp["bound_ms"],
        "bound_by": main_cmp["bound_by"],
        "library_ms": None,
        # the pre-fusion yardstick: torch.topk + quantize, two calls (phase 3za)
        "sort_path": sort_summary["times"],
        "exact_support": exact_summary,
    }, {
        "name": "fused_compress_dp",
        "route": "cuda",
        "source": "src/repro_torch/csrc/compress.cu",
        "replaces": "src/repro/kernels/compress.py:103",
        "launches": counts_dp["fused_compress_dp"]
        + mesh_summary["private_launches"]["fused_compress_dp"],
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
        "launches": counts_serve["flash_attention"] + sum(
            moe_serve[GROK_ARCH][key]["launches"]["flash_attention"] for key in ("bf16", "spec"))
        + vlm_serve["launches"]["flash_attention"]
        + vlm_serve["spec"]["launches"]["flash_attention"],
        "max_abs_err": max_err_flash,
        "ms": flash_main["ms"],
        "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"],
        "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
        # qwen2-vl-72b's prefill shape (phase 3v's launches)
        "vlm_prefill": {"shape": [128, 4096, 128], **flash_cases[VLM_FLASH_CASE]},
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
    }, {
        "name": "mamba1_discretize",
        "route": "cuda",
        "source": "src/repro_torch/csrc/mamba1_discretize.cu",
        # no TPU kernel: the reference builds a and b in jax.numpy
        "replaces": "jax.numpy in src/repro/models/ssm.py (mamba1_forward's chunk body)",
        "launches": counts_ssm["mamba1_discretize"] + sum(
            cell["launches"].get("mamba1_discretize", 0) for cell in train_summary.values()),
        **discretize_main,
    }, {
        "name": "mamba1_discretize_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/mamba1_discretize.cu",
        # no TPU kernel: the reference takes jax.grad through the chain
        "replaces": "jax.grad through src/repro/models/ssm.py (mamba1_forward's chunk body)",
        "launches": sum(cell["launches"].get("mamba1_discretize_bwd", 0)
                        for cell in train_summary.values()),
        # the second stage that adds the backward's per-block partials of dB and dA
        "sum_launches": sum(cell["launches"].get("mamba1_discretize_sum", 0)
                            for cell in train_summary.values()),
        **discretize_bwd_main,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
