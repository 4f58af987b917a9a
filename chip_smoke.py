#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/kernels/csrc`
with nvcc (sm_90a, one nvcc per source, all started together) and runs,
failing on the first wrong result:

1. each kernel against its plain PyTorch version on the card, byte for
   byte: the chunk shapes of phases 2 and 3 (the CNN's at its own 8-byte
   aligned row stride), ragged L (16-byte aligned views with L mod 16 in
   {1, 7, 15}), n != K, n over one and two row tiles, strided and
   misaligned column views of P and of the output, K = 1, K above the
   mask tile, K = 4,099 (many mask tiles: no kernel bounds K), L = 0.
   The lane-packed kernels for s in {1, 2, 4, 8};
   `gf_matmul_unpacked` for s in {1, 2, 3, 4, 8}, also on bytes >= 2^s;
   `gf2_matmul` on A bytes 0..255 and raw P bytes; at small L all of
   them against the table oracle too;
2. `fednc_round` at the paper CNN's full width (32x32x3 inputs, 10
   classes, K = 10 clients, 2 extra tuples, 20% erasures, s = 8) with the
   `auto` and `auto_seeded` kernels: it must decode and equal
   `fedavg_round` bit for bit;
3. `CodingEngine.round` on a real update size: K = 8 clients of 500,000,000
   symbols (one float32 update of a 125M-parameter model), 2 extra
   tuples, 10% erasures, the default chunk width, materialized and
   seeded: the decoded packets must equal P;
4. `hierarchical_fednc_round` on the same CNN clients: 2 edges, 2 spare
   tuples each, a 2-hop recoding WAN, the `cuda` kernels (the XOR kernel
   at s = 1, the clmul kernel at s = 8), fused and per-edge: each must
   decode and equal `fedavg_round` bit for bit;
5. byzantine rounds on the CNN's packets (s = 8, `cuda`, 3 extra
   tuples, 20% of tuples corrupted, flip / forge / both, verified): the
   fused round must equal the stage-wise oracle, one must be flagged,
   and `rounds_to_recovery` must accept a correct decode;
6. phase 3's payload through the `cuda` kernels behind a 2-hop
   recoding channel (the RowMix path): s = 8 on P, s = 1 on P & 1;
7. Qwen3-4B serving at full width and depth (36 layers, bf16 weights
   from a seed): B = 4 prompts of 2,048 token ids through
   `make_prefill_step` (cache 2,048 + 32), then 32 greedy steps through
   `make_serve_step`.  Each prefill must launch the flash kernel once
   per layer and every logit must be finite.  The first decode step's
   logits must agree with a fresh `forward_hidden` on the grown
   sequence: on the bf16 weights as served within 0.25, the timed serve
   step's first token and log-prob too, and on the same weights in
   float32 within rtol = atol = 1e-3; with the same greedy token
   wherever the fresh top-2 margin is clear of the tolerance;
8. the per-arrival decoder and the decode server (run before phase 7,
   on phase 3's payload): (a) `StreamDecoder` at K = 8, L = 500,000,000:
   10 coded rows of P (`cuda_packed`), a duplicate and a combination,
   10% dropped; 3 pushes, then the rest as one `ingest` block, each one
   launch, materialized and again seeded (`ingest_seeded`, full
   `col_mask`): the decoded packets must equal P and the ranks and
   `decoded_at` the host's own count; (b) the tripwire: a corrupted
   push after rank K under ``detect=True`` must set `tampered`, a byte
   flipped in a dependent arrival of a block must name that arrival in
   `first_inconsistent_at`; (c) `serve_trace` of the port's
   `poisson_multitenant_trace` (24 jobs, K = 10, L = 1,237,160, 6 extra
   packets, 5% duplicates, mixed wire formats), slots 8, g_tick 8,
   batched and sequential: every job complete, each digest equal to its
   true P's and an isolated `StreamDecoder`'s, both modes equal, and
   batched dispatches = ticks = launches of `gf_matmul_packed_batched`;
   (d) the committed fixture `tests/data/serve_trace.json` must give
   its recorded completions;
9. the paper's FL experiment (after phase 7) at the CNN's full width:
   N = 100 clients, 10 a round, 5,000 synthetic 32x32x3 images (test
   1,000), iid, batch 16, adam(2e-3), 2 local epochs, 3 rounds of each
   of six runs through `run_experiment` / `run_async_experiment`:
   FedAvg under the blind box (budget 10), FedNC s = 8 and s = 1 under
   the blind box, FedNC s = 8 behind `MultiHopChannel(eta=100)`, the
   hierarchical round (`cuda`, s = 1: the XOR kernel; 2 edges, 2
   spare tuples each) and the async server (s = 8, budget 18, Pareto
   gaps, compute-coupled by the measured training walls).  (a) every
   decoded round of a coded run equals `fedavg_round` of the same
   cohort and weights bit for bit; (b) every round's loss is finite
   and its accuracy in [0, 1]; (c) each coded run launches its kernel
   (packed, or XOR for the hierarchical run) and FedAvg no GF kernel;
   (d) one `LocalTrainer` SGD step on the card equals the CPU's within
   rtol 1e-4, atol 1e-6 on every leaf; (e) the async rounds consume
   between 10 and 18 arrivals and their coupled clock is at least the
   network's, which is positive.  Per run it prints the decode
   failures beside `error_probability_bound(s, eta)`, the accuracy,
   the mean round wall, local training's share of it and the
   aggregation's synchronized ms, then profiles one FedNC s = 8 round;
10. the scenario grid, the adversary and the network simulator (after
   phase 9): (a) the port's smoke grid (10 cells) through the CLI's
   `main` (`--smoke --device cuda --jobs 1`) into a temporary
   directory: its 4 simulator cells must equal the committed
   `GRID_smoke.json` in every field but `wall_s` and `per_stage`, its 6
   engine cells (`cuda_packed`, `cuda_packed_seeded`; none, eavesdrop,
   byzantine) the same grid on the CPU in every field but the timings
   and `GRID_smoke.json` in the fields that do not depend on the coding
   draws, no byzantine decode may be accepted corrupted, the packed and
   seeded kernels must be launched and `check_grid_smoke` of
   `scripts/check_bench.py` must pass; (b) `hier:2` on `cuda` under
   `eavesdrop:0.5` at s = 8 (the unpacked kernel) and s = 1 (the XOR
   kernel), each equal to its CPU run with the rank wall holding, and
   one `async_compute` cell (Pareto gaps, 2 rounds) whose coupled clock
   dominates and whose consumed count lies in [K, budget]; (c) at the
   CNN's width (K = 10, 2 extra tuples, `cuda_packed_seeded`) the
   `rlnc` function API against the engine, `EavesdropperView` (p = 0.6;
   seed headers and their rows give the same view) and
   `Eavesdropper.attack_encoded` on the round's rows, and
   `replayed_seed_batch(batch, 3)` into `StreamDecoder(detect=True)`:
   3 inconsistent arrivals and a decode equal to P; (d)
   `NetworkSimulator` at `examples/sim_scale.py`'s default scale (10^6
   clients, K = 64, 100 rounds, lognormal and Pareto gaps, the stream
   decoder) must equal `tests/data/sim_scale_reference.json`, the
   reference's summaries: counts and rates exactly, the simulated
   clock's fields within 1e-13 relative (numpy builds differ in the
   last bit of a mean over 10^6 clients); it prints the host wall.
11. FL-LM training (after phase 10, on phase 7's weights cut to their
   first 18 of 36 layers; the rest are freed): (a) at phase 7's
   attention shape (4, 2,048, 32, 8, 128) and at the training run's
   per-client shape (2, 1,024, 32, 8, 128), in bf16 and float32, the
   flash Function's output must equal the kernel's and
   `flash_attention_ref` within the flash tolerance, and its dq, dk, dv
   the float32 autograd through `_attend` on the same values (rtol =
   atol = 2e-4; bf16 rtol 1e-2, atol 1e-3), and one loss through `forward_hidden` of the full-width
   model must give every attention parameter of every layer a finite,
   non-zero gradient; (b) at Qwen3-4B's full width, K = 4 clients of a
   global batch of 8 x 1,024 tokens from `make_token_stream(seed=0)`:
   one per-client gradient stack through `plain`, `fednc_naive` and
   `fednc_blocked` (synchronized ms), each coded mean equal to the
   plain one within the reference's bound (rtol 2e-2, atol 2e-3), then
   3 steps of `fednc_blocked` through `launch.train`'s loop (adamw,
   remat): finite losses and exactly 2 flash launches per layer per
   client per step (the forward and the remat recompute); it prints the
   step walls, tokens/s (all tokens over all steps after the first,
   and each such step's) and `max_memory_allocated`, and profiles one
   more step, timing each flash backward in it with CUDA events; (c) one float32 step of the reduced Qwen3-4B on the card
   and on the CPU: per-client and aggregated gradients within rtol 1e-4
   plus 1e-5 of each leaf's scale; (d) `save_pytree` / `load_pytree` of
   the trained parameters must round-trip bit for bit on the card.
12. the recurrent and windowed families (after phase 11), one model on
   the card at a time, bf16 weights at the reference's scales from a
   seed: (a) xLSTM-125M (12 layers: 10 mLSTM, 2 sLSTM),
   RecurrentGemma-9B (38 layers: 26 RG-LRU, 12 local attention, window
   2,048, hd 256) and StarCoder2-15B (40 layers, window 4,096, hd 128)
   at full width and depth: 4 prompts of 2,048 random ids through
   `make_prefill_step` (cache 2,080; a warm prefill, then the timed one)
   and 32 greedy steps through `make_serve_step` (the first one warm):
   finite logits and states, the flash kernel launched once per layer
   per prefill and per fresh forward for StarCoder2-15B (S <= window)
   and never for the others, and the last step's cached logits equal to
   a fresh `forward_hidden` over the prompt and the 32 fed tokens within
   0.25 (RecurrentGemma's 2,048-slot ring wraps during decode;
   xLSTM-125M's mLSTM normaliser amplifies the rounding of its two
   schedules, so its cache is held on the same weights in float32 within
   1e-2 and its bf16 error is printed); it prints the prefill wall,
   prompt tokens/s, decode ms per step and `max_memory_allocated`, and
   profiles one more prefill; (b) StarCoder2-15B on one prompt of 16,384
   ids with ``window=cfg.window`` given: a 4,096-slot ring, each layer's
   prefill attention one `_attend_chunked` call (above CHUNK_THRESHOLD),
   no flash launch, then 8 serve steps: finite logits; it prints the
   prefill wall and peak memory; (c) FL-LM training of xLSTM-125M at
   full width as `examples/train_fl_lm.py --full` runs it
   (`launch.train`: K = 4, 8 x 128 tokens, `fednc_blocked`, AdamW,
   remat), 3 steps: finite losses, step walls, tokens/s and peak memory,
   then one traced step's device busy share and top kernels; (d) one
   float32 step of the reduced xLSTM-125M and of the reduced
   RecurrentGemma-9B on the card and on the CPU: per-client and
   aggregated gradients within rtol 1e-4 plus 1e-5 of each leaf's scale.
13. cross-attention, encoders and stub frontends (after phase 12), one
   model on the card at a time, bf16 weights at the reference's scales
   from a seed, every xattn gate set to 1.0 after init (at 0, as
   initialised, tanh(0) = 0 would hide the image), memory embeddings
   random from a seed (the frontends are stubs in the reference too):
   (a) Llama-3.2-Vision-90B at full width (d 8,192, 64/8 heads, hd 128,
   d_ff 28,672, vocab 128,256) on 20 of its 100 layers (4 groups of 4
   dense + 1 xattn), 4 prompts of 2,048 ids with 4 x 4,096 projected
   patch embeddings through `make_prefill_step` (cache 2,080; a warm
   prefill, then the timed one) and 32 greedy steps through
   `make_serve_step`; (b) SeamlessM4T-medium at full width and depth (12
   encoder + 12 decoder layers), 4 utterances of 2,048 frame embeddings
   and decoder prompts of 128 ids, then 32 greedy steps.  In each:
   finite logits and caches, the flash kernel launched once per
   self-attention layer per forward (16; 12 + 12) and never for
   cross-attention, the last step's cached logits equal to a fresh
   `forward_hidden` over the grown sequence with the same memory (the
   encoder re-run) within 0.25, and other memory embeddings moving the
   prefill's logits; it prints the prefill wall, prompt tokens/s, decode
   ms per step and `max_memory_allocated` beside the card's name and
   power limit, and profiles the last serve step and one more prefill
   (flash's time a launch);
   (c) the reduced configs in float32 on the same weights, prefill and 4
   decode steps on the card and on the CPU: logits within rtol = atol =
   1e-3.
14. MoE and MLA (after phase 13), one model on the card at a time,
   bf16 weights at the reference's scales from a seed (routers float32):
   (a) Arctic-480B at full width (d 7,168, 56/8 heads, hd 128, 128
   experts top-2 with d_ff 4,864 and a dense residual of 4,864, vocab
   32,000) on 2 of its 35 layers; (b) DeepSeek-V2-236B at full width
   (d 5,120, 128 heads of MLA: latent rank 512, q rank 1,536, nope 128,
   rope 64, v 128; 160 experts top-6 with d_ff 1,536 and 2 shared, the
   dense layer 0 with d_ff 12,288, vocab 102,400) on 6 of its 60 layers.
   Each: 4 prompts of 2,048 ids through `make_prefill_step` (cache
   2,080; a warm prefill, then the timed one) and 32 greedy steps
   through `make_serve_step`: finite logits and caches, flash launched
   once per Arctic layer per forward and never for DeepSeek-V2; then, on
   the same weights with capacity_factor = E / top_k (C = T: no pair is
   dropped), 4 prompts of 256 ids and 8 decode steps whose last logits
   must equal a fresh `forward_hidden` within 0.25; at the published
   factor the same difference is printed and not held (R9: the
   reference routes each decode step as its own group, so a cached step
   drops other pairs than a fresh forward).  It prints the prefill
   wall, prompt tokens/s, decode ms per step and `max_memory_allocated`
   beside the card's name and power limit, profiles the last serve step
   and one more prefill (flash's time a launch); (c) the reduced
   Arctic-480B and DeepSeek-V2-236B (MLA non-absorbed and absorbed) in
   float32 on the same weights, on the card and on the CPU: prefill and
   4 decode steps within rtol = atol = 1e-3, `lm_loss`'s aux within
   1e-6 and every gradient leaf, the routers' included, within rtol 1e-4
   plus 1e-5 of the leaf's scale.
15. the launch tier's plans against the card (after phase 14; planning
   traces on the meta device and launches no kernel): (a)
   `launch.dryrun.run_pair` at full width and depth for the ten configs
   at both decode shapes (decode_32k, long_500k) and Qwen3-4B's
   prefill_32k, the pairs that trace in about a second each (the rest:
   `python -m repro_torch.launch.dryrun --all`, off the card): one line
   each with the bound, its bottleneck, the planned peak and whether it
   fits the card; (b) the plans of the steps
   phases 7, 11, 13 and 14 ran at their depth cuts (Qwen3-4B's prefill
   of 4 x 2,048 ids and a serve step at 36 layers, its training step at
   18, Llama-3.2-Vision-90B at 20 layers, Arctic-480B at 2,
   DeepSeek-V2-236B at 6) against the `max_memory_allocated` those phases
   measured, both counted with the same resident tensors: each serving
   plan within PLAN_TOL (25%) of the measured peak, the training plan
   printed with its difference; (c) each plan's bound (the larger of
   FLOPs at 989.4 TFLOP/s and the floor bytes, arguments read once and
   outputs and cache writes written once, at 3.35 TB/s) at most
   BOUND_SLACK x
   every wall those phases measured for the step; (d)
   `core.dist.make_fednc_mean` at world size 1 on NCCL over 1 GiB of
   phase 11's gradient tree in the naive, blocked and psum modes: equal
   to `launch.steps.aggregate_gradients` given the same A and to the
   plain mean within phase 11 (b)'s tolerance; and one flash call at
   phase 7's shape under the counter on the card: `flash_flops` (137.5
   GFLOP) and one launch.

Phase 1 also holds the packed kernel's batched instance against its
plain version (J = 1, 3, 8; s = 1, 4, 8; 16-, 8-, 4- and 1-byte aligned
rows; strided views; K = 4,099; nothing written outside each output)
and the flash-attention kernel against its plain version
in float32 and bf16: head_dim 32, 64, 128, GQA groups 1 and 4, S = 1,
ragged S (100, 2049), the bf16 kernel's 128-key tile edges (129, 256,
300), non-causal, strided views, views TMA cannot read in place (each
still one launch) and the prefill shapes of phases 7, 11, 13 and 14
(Arctic's GQA ratio of 7).  After the build it prints
ptxas' registers and spills of every kernel instance, the SASS census
of the GF kernels' s = 8 instances and of the XOR kernel's 8-row
instance, whole and of their hottest basic block, the step of a full
tile (LOP3, of them the selects, SHF, IADD3, IMAD, ISETP, and shared
and global loads by width; the selects per word and packet row) and the
count of tensor-core instructions (HGMMA, HMMA) in the flash library.

Each of phases 2-14 (each run of phase 9; phase 11's training run)
drives the main path with every
launch count set to 0 just before it and read just after, and fails if a kernel of that
path was not launched.  Then it traces one round per 500M configuration,
one prefill and one serve step with torch.profiler (device busy share, device time per
kernel), times each GF kernel and its plain version at the chunk shape
(8 x 262,144; beside the operations bound, the share of the bytes
bound; the XOR kernel also at phase 6's leg shapes, 10 x 8 and 8 x 10),
the batched instance at the served tick's shape (8 x (10, 18) x
1,237,160), one batched serve with torch.profiler, and the flash
kernel, its plain version and PyTorch's
`scaled_dot_product_attention` (timing only) at phase 7's shape with
CUDA events, and prints, before its last line, the card's name and
power limit and one JSON object with every kernel's launches (phases
2-14), error, time, plain time and bound.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository's `src/` beside it, it fails before printing a result.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (700 W).  HBM: 3.35 TB/s.  int32: 64 int32
# lanes per SM (Hopper white paper) x 132 SMs x 1.98 GHz, the clock at
# which the data sheet's 67 TFLOP/s float32 (128 lanes x 2 FLOP) holds.
# bf16: the dense tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
BF16_FLOP_PER_S = 989.4e12

# Least int32 operations of the xtime ladder: an xtime is at least 4
# (shift, mask, shift-and-mask, conditional reduce), a bit-select at
# least 1 (one three-input logic op: acc ^= rung & mask).
XTIME_OPS = 4
SELECT_OPS = 1
# One Threefry-2x32-20 word: 2 key adds + 20 x (add, rotate = 3, xor)
# + 5 injections x 3.
THREEFRY_OPS = 2 + 20 * 5 + 5 * 3

CHUNK = (8, 8, 1 << 18)          # (n, K, L) of one phase-3 launch
SLEEP_CYCLES = 100_000_000       # ~50 ms of a busy stream while launches queue
PHASE3_L = 500_000_000
SEED_CLIENTS = 7                 # client perturbations, phase 2
SEED_ROUND = 3                   # coding-row generator, phases 2 and 3
SEED_ERASE2 = 7                  # erasure pattern, phase 2: 11 of 12 arrive
SEED_ERASE3 = 1                  # erasure pattern, phase 3: 9 of 10 arrive
SEED_P = 11                      # the phase-3 payload, drawn on the card
# Phases 4-6 draw their coding rows and channel plans on the host (torch
# CPU generators and numpy), so whether a round reaches rank K does not
# depend on the card.  Over GF(2) it often does not: these seeds were
# checked with the same draws on the CPU to decode at s = 1 and s = 8
# (and, in phase 5, to flag a corrupted round).
SEED_HIER = 1                    # edge coding rows, phase 4
SEED_WAN = 0                     # 2-hop WAN plan, phase 4
SEED_BYZ = 0                     # byzantine plan, phase 5
SEED_BYZ_ROUND = 0               # coding rows, phase 5
SEED_MIX = 0                     # coding rows, phase 6
SEED_HOP = 1                     # 2-hop plan, phase 6
# phase 8: the per-arrival decoder on phase 3's payload, and the decode
# server at the paper CNN's width.  The coding rows, drops and the
# trace are drawn on the host, so a seed that decodes on the CPU
# decodes on the card.
STREAM_CODED = 10                # coded rows of phase 3's P
STREAM_PUSHES = 3                # pushed one at a time, the rest one block
STREAM_DROP = 0.1
SEED_STREAM = 2                  # coding rows and drops, phase 8 (a), (b)
WIDE_SLICE = 1 << 20             # columns of each slice a 500M launch is held on
SERVE_JOBS = 24
SERVE_K = 10
SERVE_L = 1_237_160              # one CNN client's update, as phase 2
SERVE_EXTRA = 6
SERVE_DUP = 0.05
SERVE_SLOTS = 8
SERVE_TICK = 8
SEED_SERVE = 8                   # the served trace, phase 8 (c)
# phase 7: Qwen3-4B serving
QWEN = "qwen3-4b"
QWEN_BATCH = 4
QWEN_PROMPT = 2048
QWEN_DECODE = 32                 # greedy steps; the cache holds prompt + these
SEED_QWEN = 5                    # weights, drawn on the card
SEED_PROMPT = 6                  # prompt token ids
# phase 9: the paper's FL experiment (examples/paper_experiments.py's
# settings at the paper's 32x32 images).  Coding rows and channel plans
# are host draws, so which rounds decode is as on the CPU: s = 1 under
# the blind box 1 of 3, multi-hop 1 of 3 (the relays' composition is
# singular in rounds 0 and 2 at the channel's seed 0), hierarchical 2
# of 3; each coded run therefore launches its kernel.
FL_CLIENTS = 100
FL_PER_ROUND = 10
FL_SAMPLES = 5000                # the synthetic CIFAR stand-in
FL_TEST = 1000
FL_BATCH = 16
FL_EPOCHS = 2
FL_ROUNDS = 3
FL_LR = 2e-3                     # adam
FL_ETA = 100                     # recoding hops of the multi-hop run
SEED_FL = 0                      # rounds' numpy generator and initial CNN
# phase 10: the scenario grid, the adversary and the network simulator.
# (b)'s cells take the smoke grid's K = 32 and base seed; their rows are
# host draws, so which rounds decode is as on the CPU (s = 1: 3 of 4).
GRID_HIER_ROUNDS = 4
GRID_ASYNC_ROUNDS = 2
GRID_TIMINGS = ("wall_s", "per_stage", "wall_s_per_round")
GRID_STRUCTURAL = ("payload_symbols", "seeded", "wire_bytes_per_packet",
                   "wire_bytes_per_round", "wire_overhead_ratio",
                   "leak_probability_closed_form")
ADV_EXTRA = 2                    # (c): tuples beyond K
ADV_P = 0.6                      # (c): per-tuple interception probability
ADV_REPLAYS = 3                  # (c): replayed seed headers
SEED_ADV = 12                    # (c): row seeds, coin flips and replays
SIM_SCALE = ROOT / "tests" / "data" / "sim_scale_reference.json"
# phase 11: FL-LM training (examples/train_fl_lm.py -> launch.train) at
# Qwen3-4B's full width.  Depth is cut to 18 of 36 layers: per parameter
# the step keeps 2 B of bf16 weight, 8 B of float32 Adam moments and
# 2·K = 8 B of the per-client bf16 gradient stack, 79.4 GB at 36 layers
# before any temporary, 46.6 GB at 18 (PERF.md §4)
TRAIN_LAYERS = 18
TRAIN_CLIENTS = 4                # train.py's default K
TRAIN_BATCH = 8                  # global batch, split over the clients
TRAIN_SEQ = 1024
TRAIN_STEPS = 3
TRAIN_AGG = "fednc_blocked"      # train.py's default
TRAIN_LR = 3e-4                  # train.py's default
SEED_MIX = 21                    # host generator of the mixing matrices
SEED_F1 = 3                      # (a): q, k, v and dO
# (b): a coded mean against the plain one, the reference's own bound for
# its aggregation modes (tests/test_system.py:129-134)
AGG_TOL = {"rtol": 2e-2, "atol": 2e-3}
# (c): the card's float32 gradients against the CPU's.  Two float32
# programs that sum in other orders (the card's flash kernel and cuBLAS,
# TF32 off, against the CPU's tiles and BLAS): held as the CPU tests hold
# the port to the reference's float32 gradients (tests/test_torch_train.py
# F32_GRAD, measured there at most 3.1e-6 of a leaf's largest gradient):
# |card - cpu| <= rtol·|cpu| + scale·max|cpu| per leaf
GRAD_TOL = {"rtol": 1e-4, "scale": 1e-5}
REDUCED_BATCH, REDUCED_SEQ = 8, 64
# phase 12: the recurrent and windowed families at full width and depth,
# random weights at the reference's scales, one model on the card at a
# time (StarCoder2-15B: 15.96B bf16 parameters, 31.9 GB)
M3_ARCHS = ("xlstm-125m", "recurrentgemma-9b", "starcoder2-15b")
M3_BATCH = 4
M3_PROMPT = 2048
M3_DECODE = 32                   # greedy steps; the cache holds prompt + these
# (b): StarCoder2-15B's published context length, above the port's
# CHUNK_THRESHOLD (8,192), so its windowed prefill is q-chunked
M3_LONG_PROMPT = 16384
M3_LONG_DECODE = 8
M3_TRAIN_SEQ = 128               # (c): examples/train_fl_lm.py --full
# (a): xLSTM-125M's cached decode is held against a fresh forward on its
# weights in float32.  Its mLSTM divides by max(|n·q|, exp(-m)), which
# amplifies the rounding of the two schedules (chunkwise prefill against
# step-by-step decode): at full width on the CPU (B = 1, 2,052 tokens)
# float32 differs by 1.8e-4 to 9.5e-4 and bf16 by 0.22, and on the card
# bf16 differed by 1.52 (B = 4), so its bf16 error is measured, not held.
# One decode step's state lost, or one fed token changed, moves the
# float32 logits by 5.3 (CPU), far past the tolerance
M3_F32_HELD = ("xlstm-125m",)
M3_F32_TOL = {"rtol": 0.0, "atol": 1e-2}
SEED_M3 = 22                     # weights, drawn on the card
SEED_M3_PROMPT = 23              # prompt token ids
# phase 13: cross-attention, encoders and stub frontends, one model on the
# card at a time, bf16 weights at the reference's scales from a seed.
# Llama-3.2-Vision-90B at full width on 20 of its 100 layers (4 groups of
# 4 dense + 1 xattn: 19.21B parameters, 38.4 GB; all 100 would be 175
# GB); SeamlessM4T-medium at full width and depth.  The frontends are
# stubs in the reference too: the memory is random embeddings from a seed
M5_VISION, M5_SEAMLESS = "llama-3.2-vision-90b", "seamless-m4t-medium"
M5_VISION_LAYERS = 20
M5_BATCH = 4
M5_VISION_PROMPT = 2048
M5_SEAMLESS_FRAMES = 2048        # the audio rule: sequence length = frames
M5_SEAMLESS_PROMPT = 128
M5_DECODE = 32                   # greedy steps; the cache holds prompt + these
# the xattn gates start at 0 (tanh(0) = 0 hides the image): set to 1.0
# (tanh = 0.76) after init, so the image layers add to the residual stream
M5_GATE = 1.0
M5_F32_DECODE = 4                # (c): decode steps of the card-vs-CPU run
SEED_M5 = 24                     # weights, drawn on the card
SEED_M5_PROMPT = 25              # prompt token ids
SEED_M5_MEMORY = 26              # memory embeddings; SEED_M5_MEMORY + 1 the others
# phase 14: MoE and MLA, one model on the card at a time, bf16 weights at
# the reference's scales from a seed.  Arctic-480B at full width on 2 of
# its 35 layers (27.68B parameters, 55.4 GB; 3 layers would be 82.6 GB),
# DeepSeek-V2-236B at full width on 6 of its 60 (the dense prefix layer
# and 5 moe: 21.25B parameters, 42.5 GB)
M4_ARCTIC, M4_DEEPSEEK = "arctic-480b", "deepseek-v2-236b"
M4_LAYERS = {M4_ARCTIC: 2, M4_DEEPSEEK: 6}
M4_BATCH = 4
M4_PROMPT = 2048
M4_DECODE = 32                   # greedy steps; the cache holds prompt + these
# cached vs fresh (R9): the reference routes each decode step's B tokens
# as one group with its own capacity, so at the published capacity factor
# a cached step drops other (token, choice) pairs than a fresh forward
# and the two differ by more than rounding (ROADMAP.md §3 R9).  They are
# held within DECODE_TOL_BF16 on the same weights at capacity_factor =
# E / top_k (C = T: nothing is dropped); at the published factor the
# difference is printed, not held
M4_R9_PROMPT = 256
M4_R9_DECODE = 8
# with MLA the C = T check also runs in float32 on the first layers (the
# dense one and a moe: 5.4B parameters, 21.4 GB beside the bf16 model)
M4_F32_LAYERS = 2
M4_F32_DECODE = 4                # (c): decode steps of the card-vs-CPU run
M4_AUX_TOL = 1e-6                # (c): |aux on the card - aux on the CPU|
SEED_M4 = 27                     # weights, drawn on the card
SEED_M4_PROMPT = 28              # prompt token ids
# (d): counts and rates must equal the fixture exactly.  The simulated
# clock's fields (time_*) are sums of ~300 gaps scaled by slowness
# factors normalized by a mean over 10^6 clients, and numpy builds differ
# in the last bit of such reductions (numpy 2.3.5 on an H100 host against
# the fixture's 2.0.2: at most 8.415e-16 relative), so they are held
# within a few hundred ulps
SIM_CLOCK_RTOL = 1e-13
# (d): one SGD step on the card and on the CPU, both full float32 (the
# trainer turns TF32 off).  At lr 0.1 a weight moves by ~1e-2, so a
# TF32 product (~1e-3 relative) would move it by ~1e-5, far past atol.
STEP_LR = 0.1
STEP_TOL = {"rtol": 1e-4, "atol": 1e-6}
# cached decode vs fresh forward, float32 model: 36 layers of float32
# products summed in other orders (one row against 8,196), far below a
# bf16 step (2^-8) at unit scale, so a wrong slot, position or mask shows
DECODE_TOL = {"rtol": 1e-3, "atol": 1e-3}
# cached decode vs fresh forward, the bf16 model as served: the two differ
# by rounding of two GEMM shapes (M = 4 against M = 8,196) through 36
# layers of a bf16 residual stream, 0.083 on logits up to 4.75 on an H100
# 80GB HBM3 at 700 W; a wrong slot, position or mask moves logits by more
DECODE_TOL_BF16 = 0.25
# flash kernel vs its plain version on the card: both accumulate in
# float32 from the same inputs over the same tiles, and in bf16 both round
# P to bf16 after the same tensor-core sums of q·kᵀ, so in bf16 they
# differ by the output's rounding, at most one bf16 step (2^-7 relative)
# above float32 noise; the CPU tests hold the plain version to the
# reference's `_attend` at 5e-2 in bf16, a different computation
FLASH_TOL = {torch.float32: {"rtol": 2e-4, "atol": 2e-4},
             torch.bfloat16: {"rtol": 1e-2, "atol": 1e-3}}
# phase 11 (a) holds the flash Function's dq, dk, dv to the float32
# gradient of `_attend` on the same input values with the same
# tolerances: in float32 both sum the same products in other orders; in
# bf16 the Function's gradients are that float32 gradient rounded once
KERNEL_SOURCES = ("gf_matmul", "gf2_xor", "flash_attention")  # csrc/<name>.cu
# phase 15: the plans (`launch.dryrun`) of the steps phases 7, 11, 13 and
# 14 ran, against what those phases measured.  A plan counts every tensor
# a step makes, by storage lifetime, on the meta device; what it cannot
# see lies inside the ops (cuBLAS's workspaces, the allocator's 512-byte
# rounding: megabytes against tens of GB), so a plan off by more than
# PLAN_TOL of a prefill's or decode's peak is a fault of the planner
PLAN_TOL = 0.25
# a bound is the least time the card could take for the step's counted
# FLOPs and its floor bytes (`roofline.floor_bytes`): a wall below it
# (past 5% for timing) means the plan counts work the step does not do
BOUND_SLACK = 1.05
DIST_SLICE_BYTES = 1 << 30       # (d): phase 11's gradient tree, 1 GiB of it


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(libs) -> None:
    """Print ptxas' registers and spill bytes of every kernel instance
    of the built libraries (their ``-Xptxas -v`` logs)."""
    from repro_torch.kernels import build

    for lib in libs:
        log = lib.with_name(lib.name + ".log")
        if not log.exists():
            continue
        kernels = build.ptxas_kernels(log.read_text())
        for label, info in sorted(kernels.items()):
            print(f"ptxas: {lib.name}: {label}: {info['registers']} "
                  f"registers, {info['spill_stores']} bytes spill stores, "
                  f"{info['spill_loads']} bytes spill loads")
        spills = sum(i["spill_stores"] + i["spill_loads"]
                     for i in kernels.values())
        print(f"ptxas: {lib.name}: {len(kernels)} kernels, at most "
              f"{max((i['registers'] for i in kernels.values()), default=0)}"
              f" registers, {spills} bytes of spills in all")


# what the SASS census prints of each GF kernel's s = 8 instance and of
# the XOR kernel's 8-row one (LDGSTS: cp.async, global to shared; LDL,
# STL: local memory, where spilled registers go)
SASS_OPS = ("LOP3", "LOP3.select", "SHF", "IADD3", "IMAD", "ISETP",
            "LDS.128", "LDS.32", "LDG.128", "LDG.64", "LDG.32", "LDG.U8",
            "LDGSTS.128", "LDGSTS.64", "LDGSTS.32", "STG.128", "STG.64",
            "STG.32", "STG.U8", "LDL", "STL")


def sass_report(gf_lib: pathlib.Path, xor_lib: pathlib.Path,
                flash_lib: pathlib.Path) -> None:
    """Print the static SASS census of the GF kernels' s = 8 instances
    and of the XOR kernel's 8-row instance (the chunk's), whole and of
    their hottest basic block (the step of a full tile, one packet row:
    selects per word = LOP3.select / words per thread, the third
    template argument of the packed kernels, the second of the
    unpacked; for the XOR kernel selects per row = LOP3.select / 8),
    and the count of tensor-core instructions (HGMMA: wgmma; HMMA:
    mma.sync) in the flash library, from the toolkit's cuobjdump where
    it has one."""
    from repro_torch.kernels import build

    gf = build.sass_census(gf_lib)
    if not gf:
        print(f"sass: no cuobjdump beside {build.nvcc()}: not counted")
        return
    xor = build.sass_census(xor_lib).get("gf2_matmul_kernel<8>")
    check(xor is not None, "sass: no gf2_matmul_kernel<8> in the XOR library")
    for label, (whole, step) in sorted(gf.items()) + [
            ("gf2_matmul_kernel<8>", xor)]:
        if "<8" not in label:
            continue
        args = label.split(", ")
        if label.startswith("gf2_matmul"):
            per, unit = 8, "row"
        else:
            per = int(args[2 if label.startswith("gf_matmul_packed")
                           and "batched" not in label else 1])
            unit = "word"
        print(f"sass: {label}: kernel " + ", ".join(
            f"{whole[op]} {op}" for op in SASS_OPS))
        print(f"sass: {label}: step {step['instructions']} "
              f"instructions, " + ", ".join(
                  f"{step[op]} {op}" for op in SASS_OPS)
              + f"; {step['LOP3.select'] / per:g} selects per {unit} and "
              f"packet row")
    mma = sum((whole for whole, _ in build.sass_census(flash_lib).values()),
              start=Counter())
    print(f"sass: {flash_lib.name}: " + ", ".join(
        f"{mma[op]} {op} instructions" for op in ("HGMMA", "HMMA")))


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def phase1(gk, gx, ref, seeds_mod) -> dict[str, int]:
    """Byte-exact kernel == plain version; returns max |error| per kernel."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # (n, K, L, column offset, extra columns) of a view into a wider P
    # and a wider output, whose width L + off + extra sets the rows'
    # alignment: phase 3's chunk, phase 2's full and last chunks (CNN,
    # K = 10: 1,237,160 = 4 x 2^18 + 188,584) in 16-byte aligned rows and
    # at the CNN's own row stride (8-byte aligned), ragged L, 16-byte
    # aligned views with L mod 16 in {1, 7, 15}, unaligned rows, a
    # misaligned view, an aligned strided view, n over one and several
    # row tiles, K = 1, K above the kernels' 32-row mask tile, K = 4,099
    # (many mask tiles: no kernel bounds K), L = 0
    cnn = 1_237_160
    cases = [(8, 8, 1 << 18, 0, 0), (10, 10, 1 << 18, 0, 0),
             (10, 10, 188584, 0, 0), (3, 5, 4097, 0, 3), (10, 8, 1001, 0, 0),
             (6, 6, 2050, 3, 1), (6, 6, 4096, 4, 4), (19, 7, 1030, 0, 2),
             (5, 1, 13, 0, 0), (4, 4, 0, 0, 0),
             (10, 10, 1 << 18, 1 << 18, cnn - (2 << 18)),
             (10, 10, 188584, cnn - 188584, 0), (8, 8, 4097, 0, 15),
             (5, 6, 2055, 0, 9), (8, 8, 1039, 0, 1), (17, 7, 1030, 0, 2),
             (33, 9, 777, 4, 3), (9, 40, 3001, 16, 7),
             (3, 4099, 517, 0, 11)]
    worst = {"gf_matmul_packed": 0, "gf_matmul_packed_seeded": 0,
             "gf_matmul_unpacked": 0, "gf2_matmul": 0}

    def held(name, a, b, what):
        check(a.shape == b.shape and a.dtype == torch.uint8,
              f"{name} {what}: shape {tuple(a.shape)}")
        err = int((a.int() - b.int()).abs().max()) if a.numel() else 0
        worst[name] = max(worst[name], err)
        check(err == 0, f"{name} {what} differs from its plain version")

    def draw(n, K, L, off, extra, hi):
        wide = torch.randint(0, hi, (K, L + off + extra), generator=g,
                             device=dev, dtype=torch.uint8)
        A = torch.randint(0, hi, (n, K), generator=g, device=dev,
                          dtype=torch.uint8)
        # the result goes into columns of a wider output, as the
        # engine's chunk loop hands them over
        wide_out = torch.zeros((n, L + off + extra), device=dev,
                               dtype=torch.uint8)
        return A, wide[:, off:off + L], wide_out

    def outside_untouched(name, wide_out, off, L, what):
        check(not wide_out[:, :off].any() and
              not wide_out[:, off + L:].any(),
              f"{name} {what} wrote outside its output view")

    for s in (1, 2, 4, 8):
        for n, K, L, off, extra in cases:
            A, P, wide_out = draw(n, K, L, off, extra, 1 << s)
            seeds = torch.randint(0, 1 << 32, (n,), generator=g,
                                  device=dev, dtype=torch.int64)
            got = gk.gf_matmul_packed(A, P, s=s, out=wide_out[:, off:off + L])
            got_s = gk.gf_matmul_packed_seeded(seeds, P, s=s)
            via_rows = gk.gf_matmul_packed(
                seeds_mod.expand_rows(seeds, K, s), P, s=s)
            torch.cuda.synchronize()
            what = f"s={s} (n,K,L,off)={(n, K, L, off)}"
            outside_untouched("gf_matmul_packed", wide_out, off, L, what)
            held("gf_matmul_packed", got, ref.gf_matmul_packed_ref(A, P, s),
                 what)
            held("gf_matmul_packed_seeded", got_s,
                 ref.gf_matmul_packed_seeded_ref(seeds, P, s), what)
            held("gf_matmul_packed_seeded", got_s, via_rows, what)
            if L and L <= 4097:                # independent table oracle
                check(torch.equal(got, ref.gf_matmul_ref(A, P, s)),
                      f"gf_matmul_packed {what} != table oracle")
    # the unpacked kernels: s-bit symbols, then whole bytes (>= 2^s),
    # which the clmul formulation reads unmasked on A's side
    for s in (1, 2, 3, 4, 8):
        for hi in (1 << s, 256):
            for n, K, L, off, extra in cases:
                A, P, wide_out = draw(n, K, L, off, extra, hi)
                got = gk.gf_matmul_unpacked(A, P, s=s,
                                            out=wide_out[:, off:off + L])
                torch.cuda.synchronize()
                what = f"s={s} bytes<{hi} (n,K,L,off)={(n, K, L, off)}"
                outside_untouched("gf_matmul_unpacked", wide_out, off, L,
                                  what)
                held("gf_matmul_unpacked", got,
                     ref.gf_matmul_clmul_ref(A, P, s), what)
                if hi == 1 << s and L and L <= 4097:
                    check(torch.equal(got, ref.gf_matmul_ref(A, P, s)),
                          f"gf_matmul_unpacked {what} != table oracle")
    for n, K, L, off, extra in cases:           # A 0..255, raw P bytes
        A, P, wide_out = draw(n, K, L, off, extra, 256)
        got = gx.gf2_matmul(A, P, out=wide_out[:, off:off + L])
        torch.cuda.synchronize()
        what = f"(n,K,L,off)={(n, K, L, off)}"
        outside_untouched("gf2_matmul", wide_out, off, L, what)
        held("gf2_matmul", got, ref.gf2_matmul_ref(A, P), what)
        if L and L <= 4097:      # each bit-plane is an s = 1 product
            for b in range(8):
                plane = ref.gf_matmul_ref(A & 1, (P >> b) & 1, 1)
                check(torch.equal((got >> b) & 1, plane),
                      f"gf2_matmul {what} bit {b} != table oracle")
    print(f"phase 1: all four kernels == plain versions, "
          f"{len(cases)} shapes each (K up to {max(c[1] for c in cases)}; "
          f"packed s in 1,2,4,8; unpacked s in "
          f"1,2,3,4,8 on s-bit symbols and on bytes >= 2^s; gf2 on A bytes "
          f"0..255), max_abs_err={worst}")
    return worst


def phase1_batched(gk, ref) -> dict[str, int]:
    """The packed kernel's batched instance == a loop of the packed plain
    version, byte for byte; returns its max |error|.  J = 1, 3, 8
    problems; s = 1, 4, 8; rows 16-, 8-, 4- and 1-byte aligned (the
    batch stride too); ragged L; strided views of P and of the output;
    K above the mask tile and 4,099; L = 0; nothing written outside
    each problem's output view."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    # (J, n, K, L, column offset, extra columns): the row stride
    # L + off + extra sets the rows' alignment
    cases = [(1, 8, 8, 4096, 0, 0), (3, 10, 18, 4100, 0, 0),
             (8, 10, 18, 4104, 0, 0), (8, 10, 18, 2051, 4, 5),
             (3, 5, 40, 1030, 3, 1), (2, 3, 4099, 517, 0, 11),
             (8, 10, 18, 1 << 18, 0, 0), (3, 4, 4, 0, 0, 4)]
    worst = 0
    for s in (1, 4, 8):
        for J, n, K, L, off, extra in cases:
            W = L + off + extra
            wide = torch.randint(0, 1 << s, (J, K + 2, W), generator=g,
                                 device=dev, dtype=torch.uint8)
            P = wide[:, 1:1 + K, off:off + L]
            A = torch.randint(0, 1 << s, (J, n, K), generator=g, device=dev,
                              dtype=torch.uint8)
            wide_out = torch.zeros((J, n + 2, W), device=dev,
                                   dtype=torch.uint8)
            got = gk.gf_matmul_packed_batched(
                A, P, s=s, out=wide_out[:, 1:1 + n, off:off + L])
            want = ref.gf_matmul_packed_batched_ref(A, P, s)
            torch.cuda.synchronize()
            what = f"s={s} (J,n,K,L,off,W)={(J, n, K, L, off, W)}"
            err = int((got.int() - want.int()).abs().max()) if L else 0
            worst = max(worst, err)
            check(err == 0, f"gf_matmul_packed_batched {what} differs from "
                            f"its plain version")
            check(not wide_out[:, 0].any() and not wide_out[:, n + 1].any()
                  and not wide_out[:, :, :off].any()
                  and not wide_out[:, :, off + L:].any(),
                  f"gf_matmul_packed_batched {what} wrote outside its "
                  f"output views")
    print(f"phase 1: gf_matmul_packed_batched == plain version (a loop of "
          f"the packed plain version), {len(cases)} shapes x s in 1,4,8 "
          f"(J 1/3/8, K up to 4,099, rows 16/8/4/1-byte aligned, strided "
          f"views), max_abs_err={worst}")
    return {"gf_matmul_packed_batched": worst}


def phase1_flash(fa, ref, attn) -> dict[str, float]:
    """The flash kernel == its plain version on the card within
    FLASH_TOL (and, in float32 at small S, == the plain masked softmax
    `_attend`); returns the max |error| in float32 units."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    # (B, S, H, KV, hd, causal, pad): pad > 0 widens the fused tensor's
    # head to hd + pad, a head stride TMA cannot read in place
    cases = [(2, S, H, KV, hd, True, 0) for hd in (32, 64, 128)
             for H, KV in ((4, 4), (8, 2)) for S in (1, 100, 2049)]
    cases += [(1, 256, 8, 2, 128, False, 0)]
    cases += [(2, S, 8, 2, hd, True, 0) for hd in (32, 64, 128)
              for S in (129, 256, 300)]
    cases += [(2, 300, 8, 2, hd, True, 2) for hd in (32, 128)]
    worst, used = {}, {}       # max |err|, max |err| / (atol + rtol |want|)
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[dtype]
        shapes = cases + ([(QWEN_BATCH, QWEN_PROMPT, 32, 8, 128, True, 0),
                           (TRAIN_BATCH // TRAIN_CLIENTS, TRAIN_SEQ, 32, 8,
                            128, True, 0),
                           # phase 13's prefills: Llama-3.2-Vision-90B's
                           # dense layers, SeamlessM4T-medium's encoder
                           (M5_BATCH, M5_VISION_PROMPT, 64, 8, 128, True, 0),
                           (M5_BATCH, M5_SEAMLESS_FRAMES, 16, 16, 64, True,
                            0),
                           # phase 14's: Arctic-480B's GQA ratio of 7
                           (M4_BATCH, M4_PROMPT, 56, 8, 128, True, 0)]
                          if dtype == torch.bfloat16 else [])
        worst[dtype] = used[dtype] = 0.0
        for B, S, H, KV, hd, causal, pad in shapes:
            # q, k, v as head slices of one fused tensor: strided views
            fused = torch.randn((B, S, H + 2 * KV, hd + pad), generator=g,
                                device=dev).to(dtype)[..., :hd]
            q, k, v = (fused[:, :, :H], fused[:, :, H:H + KV],
                       fused[:, :, H + KV:])
            check(fa.tma_ready(q) == (pad == 0),
                  f"flash_attention: tma_ready wrong at pad {pad}")
            before = fa.flash_attention.launches
            got = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            what = (f"{str(dtype)[6:]} (B,S,H,KV,hd)={(B, S, H, KV, hd)} "
                    f"causal={causal} pad={pad}")
            check(fa.flash_attention.launches == before + 1,
                  f"flash_attention {what}: not one launch")
            check(got.shape == (B, S, H, hd) and got.dtype == dtype,
                  f"flash_attention {what}: {got.dtype} {tuple(got.shape)}")
            want = ref.flash_attention_ref(q, k, v, causal=causal).float()
            diff = (got.float() - want).abs()
            err = float(diff.max())
            worst[dtype] = max(worst[dtype], err)
            used[dtype] = max(used[dtype], float(
                (diff / (tol["atol"] + tol["rtol"] * want.abs())).max()))
            check(torch.allclose(got.float(), want, **tol),
                  f"flash_attention {what} differs from its plain version "
                  f"(max |err| {err}, tolerance {tol})")
            if dtype == torch.float32 and S <= 100:
                groups = H // KV
                plain = attn._attend(q, attn._expand_kv(k, groups),
                                     attn._expand_kv(v, groups),
                                     causal=causal, window=None, q_offset=0)
                check(torch.allclose(got, plain, **tol),
                      f"flash_attention {what} differs from _attend")
    print(f"phase 1: flash_attention == plain version, {len(cases)} shapes "
          f"in each dtype + the phase-7, phase-11, phase-13 and phase-14 "
          f"shapes in bf16 (hd "
          f"32/64/128, groups "
          f"1 and 4, S 1/100/129/256/300/2049, non-causal S=256, strided "
          f"views, views TMA cannot read in place): "
          + "; ".join(f"{str(dt)[6:]} tolerance {FLASH_TOL[dt]}, max_abs_err="
                      f"{worst[dt]}, largest share of the tolerance used "
                      f"{used[dt]:.4f}" for dt in worst))
    return {"flash_attention": max(worst.values())}


# ---------------------------------------------------------------------------
# phase 2: fednc_round at the paper CNN's full width
# ---------------------------------------------------------------------------

def cnn_clients():
    """(base, 10 perturbed CNN clients, weights, FedAvg of them) on the
    card, from seeds."""
    from repro_torch.core import packets as pkt
    from repro_torch.core.fednc import fedavg_round
    from repro_torch.models.cnn import init_cnn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED_CLIENTS)
    base = init_cnn(g, num_classes=10, image_size=32)
    clients = [pkt.tree_map(
        lambda x: x + 0.01 * torch.randn(x.shape, generator=g, device=dev),
        base) for _ in range(10)]
    weights = np.random.default_rng(SEED_CLIENTS).integers(50, 500, 10)
    want = fedavg_round(clients, weights, base).global_params
    return base, clients, weights, want


def same_tree(a, b) -> bool:
    from repro_torch.core import packets as pkt
    return all(torch.equal(x, y) for x, y in zip(
        pkt.tree_flatten(a)[0], pkt.tree_flatten(b)[0], strict=True))


def phase2(base, clients, weights, want) -> None:
    from repro_torch.core import packets as pkt
    from repro_torch.core.channel import ErasureChannel
    from repro_torch.core.fednc import FedNCConfig, fednc_round

    n_bytes = sum(x.numel() * x.element_size()
                  for x in pkt.tree_flatten(base)[0])
    for kernel in ("auto", "auto_seeded"):
        cfg = FedNCConfig(s=8, kernel_impl=kernel, extra_tuples=2)
        res = fednc_round(clients, weights, base, cfg,
                          torch.Generator().manual_seed(SEED_ROUND),
                          channel=ErasureChannel(0.2, seed=SEED_ERASE2),
                          device="cuda")
        torch.cuda.synchronize()
        check(res.decoded, f"phase 2 {kernel}: round did not decode "
                           f"({res.report})")
        check(same_tree(res.global_params, want),
              f"phase 2 {kernel}: FedNC != FedAvg")
        print(f"phase 2: fednc_round kernel={kernel} CNN {n_bytes} bytes/"
              f"client K=10 {res.report}: decoded, == fedavg_round "
              f"bit-exact")


# ---------------------------------------------------------------------------
# phase 3: CodingEngine.round at a real update size
# ---------------------------------------------------------------------------

def phase3(wrappers) -> torch.Tensor:
    from repro_torch.core.channel import ErasureChannel
    from repro_torch.engine import CodingEngine, EngineConfig

    dev = torch.device("cuda")
    K = 8
    P = torch.randint(0, 256, (K, PHASE3_L), device=dev, dtype=torch.uint8,
                      generator=torch.Generator(device=dev).manual_seed(
                          SEED_P))
    torch.cuda.synchronize()
    # in turns (materialized, seeded, seeded, materialized): the first
    # round also pays the allocator's first 4 GB output allocation
    for kernel in ("auto", "auto_seeded", "auto_seeded", "auto"):
        eng = CodingEngine(EngineConfig(s=8, kernel=kernel, extra_tuples=2),
                           device="cuda")
        before = launch_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = eng.round(P, torch.Generator().manual_seed(SEED_ROUND),
                        channel=ErasureChannel(0.1, seed=SEED_ERASE3))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()    # before the check below
        check(out.ok, f"phase 3 {kernel}: round did not decode "
                      f"({out.report})")
        check(torch.equal(out.packets, P), f"phase 3 {kernel}: P_hat != P")
        after = launch_counts(wrappers)
        launches = {k: after[k] - before[k] for k in after}
        print(f"phase 3: CodingEngine.round kernel={eng.kernel_name} "
              f"K={K} L={PHASE3_L} {out.report} chunks="
              f"{-(-PHASE3_L // eng.config.chunk_l)}: P_hat == P; wall "
              f"{wall:.6f} s (synchronized), "
              f"{K * PHASE3_L * 2 / wall / 1e9:.3f} GB/s payload in+out, "
              f"dispatches {eng.dispatch_count}, launches {launches}, "
              f"max_memory_allocated {peak} bytes")
        del out
    return P


# ---------------------------------------------------------------------------
# phase 4: the hierarchical round at the CNN's full width
# ---------------------------------------------------------------------------

def phase4(base, clients, weights, want) -> None:
    from repro_torch.core.channel import MultiHopChannel
    from repro_torch.core.fednc import FedNCConfig
    from repro_torch.core.hierarchy import hierarchical_fednc_round

    for s in (1, 8):
        results = {}
        for fused in (True, False):
            cfg = FedNCConfig(s=s, kernel_impl="cuda")
            t0 = time.perf_counter()
            res = hierarchical_fednc_round(
                clients, weights, base, cfg,
                torch.Generator().manual_seed(SEED_HIER), num_edges=2,
                spare_per_edge=2,
                wan_channel=MultiHopChannel(eta=2, seed=SEED_WAN),
                fused=fused, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            name = "fused" if fused else "per-edge"
            check(res.decoded, f"phase 4 s={s} {name}: round did not "
                               f"decode ({res.report})")
            check(same_tree(res.global_params, want),
                  f"phase 4 s={s} {name}: hierarchical FedNC != FedAvg")
            results[name] = res
            print(f"phase 4: hierarchical_fednc_round s={s} kernel=cuda "
                  f"{name} K=10 edges=2 spare=2 WAN 2-hop {res.report}: "
                  f"decoded, == fedavg_round bit-exact; wall {wall:.6f} s")
        check(same_tree(results["fused"].global_params,
                        results["per-edge"].global_params),
              f"phase 4 s={s}: fused != per-edge")


# ---------------------------------------------------------------------------
# phase 5: byzantine rounds, fused against the stage-wise oracle
# ---------------------------------------------------------------------------

def phase5(clients) -> None:
    from repro_torch.adversary import (MODES, ByzantineChannel,
                                       rounds_to_recovery)
    from repro_torch.engine import CodingEngine, EngineConfig

    eng = CodingEngine(EngineConfig(s=8, kernel="cuda", extra_tuples=3),
                       device="cuda")
    P, _ = eng.packetize(clients)
    K = P.shape[0]
    flags = []
    for mode in MODES:
        chan = ByzantineChannel(0.2, seed=SEED_BYZ, mode=mode)
        out = eng.round(P, torch.Generator().manual_seed(SEED_BYZ_ROUND),
                        chan, verify=True)
        A = eng.coding_matrix(torch.Generator().manual_seed(SEED_BYZ_ROUND),
                              K + 3, K)
        batch, _ = ByzantineChannel(0.2, seed=SEED_BYZ, mode=mode) \
            .transmit_encoded(eng.encode(P, A), 8)
        ok, P_hat, verified = eng.decode_verified(batch)
        torch.cuda.synchronize()
        check(out.ok == ok and out.verified == verified,
              f"phase 5 {mode}: fused (ok={out.ok}, verified="
              f"{out.verified}) != stage-wise (ok={ok}, verified="
              f"{verified})")
        check(not ok or torch.equal(out.packets, P_hat),
              f"phase 5 {mode}: fused packets != stage-wise packets")
        flags.append(out.verified)
        print(f"phase 5: byzantine mode={mode} rate=0.2 K={K} L="
              f"{P.shape[1]} corrupted={chan.corrupted} {out.report}: "
              f"ok={out.ok} verified={out.verified} decoded==P "
              f"{bool(out.ok and torch.equal(out.packets, P))}, == "
              f"stage-wise oracle")
    check(False in flags, "phase 5: no round was flagged by verification")
    rec = rounds_to_recovery(eng, P, torch.Generator().manual_seed(
        SEED_BYZ_ROUND), ByzantineChannel(0.2, seed=SEED_BYZ, mode="both"))
    check(rec["accepted"] and rec["correct"],
          f"phase 5: rounds_to_recovery {rec}")
    print(f"phase 5: rounds_to_recovery mode=both: {rec}")


# ---------------------------------------------------------------------------
# phase 6: the 500M payload through the unpacked kernels, RowMix path
# ---------------------------------------------------------------------------

def mix_engine(s: int):
    from repro_torch.engine import CodingEngine, EngineConfig
    return CodingEngine(EngineConfig(s=s, kernel="cuda", extra_tuples=2),
                        device="cuda")


def mix_channel():
    from repro_torch.core.channel import MultiHopChannel
    return MultiHopChannel(eta=2, seed=SEED_HOP)


def phase6(wrappers, P: torch.Tensor, P1: torch.Tensor) -> None:
    K = P.shape[0]
    for s, X in ((8, P), (1, P1)):
        eng = mix_engine(s)
        before = launch_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = eng.round(X, torch.Generator().manual_seed(SEED_MIX),
                        channel=mix_channel())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(out.ok, f"phase 6 s={s}: round did not decode ({out.report})")
        check(torch.equal(out.packets, X), f"phase 6 s={s}: P_hat != P")
        after = launch_counts(wrappers)
        launches = {k: after[k] - before[k] for k in after}
        print(f"phase 6: CodingEngine.round kernel=cuda s={s} K={K} "
              f"L={X.shape[1]} 2-hop RowMix {out.report}: P_hat == P; wall "
              f"{wall:.6f} s (synchronized), "
              f"{K * X.shape[1] * 2 / wall / 1e9:.3f} GB/s payload in+out, "
              f"dispatches {eng.dispatch_count}, launches {launches}, "
              f"max_memory_allocated {peak} bytes")
        del out


# ---------------------------------------------------------------------------
# phase 8: the per-arrival decoder, its tripwire and the decode server
# ---------------------------------------------------------------------------

def stream_rows(K: int) -> tuple[torch.Tensor, np.ndarray]:
    """(A, kept): 10 coded rows with a duplicate and a combination of two
    of them among them (12 rows, on the host), and the rows that survive
    10% erasure, in arrival order."""
    from repro_torch.core.gf import get_field

    A = get_field(8).random_elements(
        torch.Generator().manual_seed(SEED_STREAM), (STREAM_CODED, K))
    # arrival 5 duplicates arrival 3, arrival 8 combines arrivals 1 and 2
    A = torch.cat([A[:4], A[2:3], A[4:6], A[0:1] ^ A[1:2], A[6:]])
    keep = np.random.default_rng(SEED_STREAM).random(len(A)) >= STREAM_DROP
    return A, np.nonzero(keep)[0]


def host_count(K: int, rows: torch.Tensor) -> tuple[list[int], int]:
    """The rank trajectory and decoded_at of `rows` counted on the host:
    a rank-only decoder, the same pushes and block."""
    from repro_torch.engine import StreamDecoder

    dec = StreamDecoder(K=K)
    ranks = [dec.push(rows[i]) for i in range(STREAM_PUSHES)]
    ranks += dec.ingest(rows[STREAM_PUSHES:]).tolist()
    return ranks, dec.decoded_at


def held_wide_launches(ref, seen: list):
    """Point the stream decoder's packed launches at a wrapper that holds
    each launch's output against the packed plain version, on slices of
    WIDE_SLICE columns at the start, the middle and the end of its rows,
    inside the call (the decoder swaps and reuses its buffers).  Appends
    (rows in, rows out, the farthest byte offset the kernel reads from
    its P pointer, max |error|) per launch; returns the undo."""
    import repro_torch.engine.stream as stream

    launch = stream.gf_matmul_packed

    def checked(A, P, *, s, out):
        got = launch(A, P, s=s, out=out)
        L = P.shape[1]
        err = 0
        for c0 in (0, (L - WIDE_SLICE) // 2, L - WIDE_SLICE):
            cols = slice(max(c0, 0), min(max(c0, 0) + WIDE_SLICE, L))
            want = ref.gf_matmul_packed_ref(A, P[:, cols], s)
            err = max(err, int((got[:, cols].int() - want.int()).abs().max()))
        far = (P.shape[0] - 1) * P.stride(0) + L - 1
        seen.append((P.shape[0], got.shape[0], far, err))
        return got

    stream.gf_matmul_packed = checked
    return lambda: setattr(stream, "gf_matmul_packed", launch)


def run_stream(gk, K: int, L: int, push_rows, block_rows, C, ingest,
               detect: bool = False) -> tuple[object, list[int], dict]:
    """Push STREAM_PUSHES arrivals, then ingest the rest as one block;
    returns the decoder, its rank trajectory and the synchronized
    times and launches of each step."""
    from repro_torch.engine import StreamDecoder

    dec = StreamDecoder(K=K, L=L, device="cuda", detect=detect)
    ranks, steps = [], {}
    for i in range(STREAM_PUSHES):
        before = gk.gf_matmul_packed.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ranks.append(dec.push(push_rows[i], C[i]))
        torch.cuda.synchronize()
        steps[f"push {i}"] = (time.perf_counter() - t0,
                              gk.gf_matmul_packed.launches - before)
    before = gk.gf_matmul_packed.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks += ingest(dec, block_rows, C[STREAM_PUSHES:]).tolist()
    torch.cuda.synchronize()
    steps["ingest"] = (time.perf_counter() - t0,
                       gk.gf_matmul_packed.launches - before)
    return dec, ranks, steps


def phase8_stream(gk, ref, P: torch.Tensor) -> int:
    """(a) StreamDecoder on phase 3's payload, materialized then seeded;
    (b) the tripwire in a block and under detect=True, each launch of (b)
    held against the packed plain version on column slices.  Returns
    the max |error| of those launches."""
    from repro_torch.core import seeds as seedlib
    from repro_torch.core.rlnc import EncodedBatch
    from repro_torch.engine import CodingEngine, EngineConfig

    K, L = P.shape
    eng = CodingEngine(EngineConfig(s=8, kernel="cuda_packed"),
                       device="cuda")
    A, kept = stream_rows(K)
    torch.cuda.reset_peak_memory_stats()
    C = eng.encode(P, A).C[torch.as_tensor(kept, device="cuda")]
    rows = A[kept]
    want_ranks, want_at = host_count(K, rows)
    dec, ranks, steps = run_stream(
        gk, K, L, rows, rows[STREAM_PUSHES:], C,
        lambda d, r, c: d.ingest(r, c), detect=True)
    ok, P_hat = dec.decode()
    check(ok and torch.equal(P_hat, P), "phase 8 (a): decoded packets != P")
    check(ranks == want_ranks and dec.decoded_at == want_at,
          f"phase 8 (a): ranks {ranks} / decoded_at {dec.decoded_at} != "
          f"the host's {want_ranks} / {want_at}")
    check(not dec.tampered, "phase 8 (a): an honest stream was flagged")
    g = len(rows) - STREAM_PUSHES
    d = g - (want_ranks[-1] - want_ranks[STREAM_PUSHES - 1])
    for name, (sec, launched) in steps.items():
        n_in, n_out = (K + 1, K) if name.startswith("push") else (K + g,
                                                                   K + d)
        b_ms, b_by, n_bytes, ops = bound_ms(n_out, n_in, L, 8, "ladder")
        print(f"phase 8 (a): {name} K={K} L={L}: {launched} launch(es), "
              f"{sec * 1e3:.6f} ms synchronized, bound {b_ms:.6f} ms by "
              f"{b_by} ({n_out} x {n_in} rows: {n_bytes} bytes, {ops} int32 "
              f"ops), {100 * b_ms / (sec * 1e3):.2f}% of it")
        check(launched == 1, f"phase 8 (a): {name} launched {launched} "
                             f"times, not once")
    print(f"phase 8 (a): StreamDecoder materialized, {len(A)} coded rows "
          f"(one duplicate, one combination), {len(rows)} arrive: ranks "
          f"{ranks} == host count, decoded_at {dec.decoded_at}, "
          f"P_hat == P")
    # (b) the tripwire: a corrupted arrival after rank K, detect=True
    bad = C[0].clone()
    bad[L // 2] ^= 0x5A
    before = gk.gf_matmul_packed.launches
    held = []
    undo = held_wide_launches(ref, held)
    dec.push(rows[0], bad)
    check(dec.tampered and dec.first_inconsistent_at == dec.arrivals,
          "phase 8 (b): a corrupted push after rank K was not flagged")
    check(gk.gf_matmul_packed.launches == before + 1 and
          torch.equal(dec.decode()[1], P),
          "phase 8 (b): the detect push did not launch once or moved Y")
    del dec, bad, P_hat
    # (b) the tripwire inside a block: flip a byte of a dependent arrival
    block = rows[STREAM_PUSHES:]
    dep = [i for i in range(g) if want_ranks[STREAM_PUSHES + i]
           == want_ranks[STREAM_PUSHES + i - 1]]
    check(len(dep) > 0, "phase 8 (b): the block holds no dependent arrival")
    flip = STREAM_PUSHES + dep[0]
    C[flip, L // 3] ^= 0x01
    try:
        dec, _, _ = run_stream(gk, K, L, rows, block, C,
                               lambda d, r, c: d.ingest(r, c))
    finally:
        undo()
    C[flip, L // 3] ^= 0x01
    check(dec.first_inconsistent_at == flip + 1 and dec.inconsistent == 1,
          f"phase 8 (b): first_inconsistent_at {dec.first_inconsistent_at}"
          f" != the flipped arrival {flip + 1}")
    check(torch.equal(dec.decode()[1], P),
          "phase 8 (b): the flipped dependent arrival changed P_hat")
    print(f"phase 8 (b): tripwire: a corrupted push after rank K sets "
          f"tampered (one launch of its tripwire row, P_hat kept); a byte "
          f"flipped in dependent arrival {flip + 1} of a block: "
          f"first_inconsistent_at {dec.first_inconsistent_at}, "
          f"inconsistent {dec.inconsistent}")
    wide_err = max(e for *_, e in held)
    far = max(f for _, _, f, _ in held)
    check(wide_err == 0, f"phase 8 (b): a packed launch at L={L} differs "
                         f"from its plain version: {held}")
    check(far >= 1 << 32, f"phase 8 (b): the held launches read no byte "
                          f"past 2^32 of their P ({far})")
    print(f"phase 8 (b): {len(held)} packed launches at L={L} "
          f"((rows in, rows out) {[h[:2] for h in held]}) == the packed "
          f"plain version on {WIDE_SLICE} columns at the start, middle and "
          f"end of their rows (farthest byte read {far} from P, past "
          f"2^32), max_abs_err={wide_err}")
    del dec
    # the yardstick: the engine's batch decode of the same arrivals
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok, P_batch = eng.decode(EncodedBatch(A=rows, C=C))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    check(ok and torch.equal(P_batch, P), "phase 8 (a): batch decode != P")
    del P_batch, C
    # (a) again through the seeded wire format, full col_mask
    seeds = seedlib.draw_seeds(torch.Generator().manual_seed(SEED_STREAM),
                               STREAM_CODED)
    seeds = torch.cat([seeds, seeds[2:3]])                  # a duplicate
    keep = np.random.default_rng(SEED_STREAM + 1).random(len(seeds)) \
        >= STREAM_DROP
    seeds = seeds[torch.as_tensor(np.nonzero(keep)[0])]
    C = eng.encode_seeded(P, seeds).C
    want_ranks, want_at = host_count(K, seedlib.expand_rows(seeds, K, 8))
    mask = np.ones((K,), bool)
    dec, ranks, steps = run_stream(
        gk, K, L, [int(x) for x in seeds], seeds[STREAM_PUSHES:], C,
        lambda d, r, c: d.ingest_seeded(r, c, col_mask=mask))
    ok, P_hat = dec.decode()
    check(ok and torch.equal(P_hat, P),
          "phase 8 (a): seeded decoded packets != P")
    check(ranks == want_ranks and dec.decoded_at == want_at,
          f"phase 8 (a): seeded ranks {ranks} != the host's {want_ranks}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 8 (a): StreamDecoder seeded + col_mask, {len(seeds)} "
          f"arrivals: ranks {ranks} == host count, decoded_at "
          f"{dec.decoded_at}, P_hat == P; push "
          f"{steps['push 0'][0] * 1e3:.6f} ms, ingest "
          f"{steps['ingest'][0] * 1e3:.6f} ms synchronized; the engine's "
          f"batch decode of the materialized arrivals {batch_s * 1e3:.6f} "
          f"ms; max_memory_allocated {peak} bytes")
    del dec, P_hat, C
    return wide_err


def phase8_serve(gk, fixture: pathlib.Path) -> dict:
    """(c) the decode server at the CNN's width, batched and sequential;
    (d) the committed fixture.  Returns the measurements."""
    from repro_torch.core.seeds import expand_rows
    from repro_torch.engine import StreamDecoder
    from repro_torch.serve import (ServeTrace, job_packets, payload_digest,
                                   poisson_multitenant_trace, serve_trace)

    t0 = time.perf_counter()
    trace = poisson_multitenant_trace(
        SERVE_JOBS, K=SERVE_K, L=SERVE_L, s=8, extra_packets=SERVE_EXTRA,
        duplicate_rate=SERVE_DUP, seeded="mixed", seed=SEED_SERVE,
        device="cuda")
    gen_s = time.perf_counter() - t0
    reports = {}
    for batched in (True, False, True):        # in turns; the first warms
        before = gk.gf_matmul_packed_batched.launches
        rep = serve_trace(trace, slots=SERVE_SLOTS, g_tick=SERVE_TICK,
                          batched=batched, device="cuda")
        launched = gk.gf_matmul_packed_batched.launches - before
        if batched:
            check(rep.dispatches == rep.ticks == launched,
                  f"phase 8 (c): dispatches {rep.dispatches}, ticks "
                  f"{rep.ticks}, batched launches {launched} differ")
        reports.setdefault(batched, []).append(rep)
    sig = {b: [(c.job, c.arrivals, c.payload_sha) for c in r[-1].completions]
           for b, r in reports.items()}
    check(sig[True] == sig[False],
          "phase 8 (c): batched and sequential completions differ")
    rep = reports[True][-1]
    check(rep.completed == SERVE_JOBS,
          f"phase 8 (c): {rep.completed} of {SERVE_JOBS} jobs complete")
    for c in rep.completions:
        meta = trace.jobs[c.job]
        idx = trace.packet_indices(c.job)
        dec = StreamDecoder(K=meta.K, L=meta.L, device="cuda")
        rows = (trace.row_seeds[idx] if meta.seeded else
                expand_rows(trace.row_seeds[idx], meta.K, 8))
        dec.ingest(rows, trace.payloads[idx, :meta.L])
        truth = payload_digest(job_packets(SEED_SERVE, c.job, meta.K,
                                           meta.L))
        check(c.payload_sha == truth == payload_digest(dec.decode()[1]) and
              c.arrivals == dec.decoded_at,
              f"phase 8 (c): job {c.job} differs from its true P or from "
              f"an isolated StreamDecoder")
    seq = reports[False][-1]
    p50, p99 = rep.latency_percentiles()
    print(f"phase 8 (c): serve_trace {SERVE_JOBS} jobs K={SERVE_K} "
          f"L={SERVE_L} extra {SERVE_EXTRA} dup {SERVE_DUP} mixed formats, "
          f"slots {SERVE_SLOTS} g_tick {SERVE_TICK} (trace generated in "
          f"{gen_s:.3f} s): every job complete, == its true P and an "
          f"isolated StreamDecoder, batched == sequential; batched: "
          f"{rep.packets_ingested} packets, {rep.ticks} ticks = dispatches "
          f"= launches, wall {rep.wall_s:.6f} s ({reports[True][0].wall_s:.6f}"
          f" s cold), {rep.packets_per_s:.1f} packets/s, p50 "
          f"{p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms; sequential: "
          f"{seq.dispatches} dispatches, wall {seq.wall_s:.6f} s, "
          f"{seq.packets_per_s:.1f} packets/s; batched / sequential wall "
          f"{rep.wall_s / seq.wall_s:.4f}")
    out = []
    device_profile("serve batched", lambda: out.append(serve_trace(
        trace, slots=SERVE_SLOTS, g_tick=SERVE_TICK, batched=True,
        device="cuda")))
    check(out[0].completed == SERVE_JOBS, "phase 8 (c): traced serve")
    del trace, out
    # (d) the committed fixture: the reference's own completions
    fix = ServeTrace.load(fixture)
    expected = fix.extra["expected"]
    for g_tick in (1, 4, 8):
        r = serve_trace(fix, slots=4, g_tick=g_tick, device="cuda")
        got = {str(c.job): {"arrivals": c.arrivals,
                            "payload_sha": c.payload_sha}
               for c in r.completions}
        check(got == expected, f"phase 8 (d): fixture g_tick={g_tick} != "
                               f"its expected completions")
    print(f"phase 8 (d): {fixture.name}: {len(expected)} jobs, arrivals and "
          f"payload_sha == the fixture's expected completions at g_tick 1, "
          f"4, 8")
    return {"packets_per_s": rep.packets_per_s, "wall_s": rep.wall_s}


def phase8(gk, ref, P: torch.Tensor) -> int:
    """Phase 8; returns the max |error| of the 500M launches held."""
    wide_err = phase8_stream(gk, ref, P)
    phase8_serve(gk, ROOT / "tests" / "data" / "serve_trace.json")
    return wide_err


def time_batched(gk, ref) -> dict:
    """The batched instance at the served tick's shape: 8 slots x (10,
    18) over the CNN's 1,237,160 symbols, held byte for byte against its
    plain version there, then timed in turns plain, kernel, kernel,
    plain; bound: 8 times the packed ladder's least work."""
    J, n, K, L = SERVE_SLOTS, SERVE_K, SERVE_K + SERVE_TICK, SERVE_L
    g = torch.Generator(device="cuda").manual_seed(4)
    A = torch.randint(0, 256, (J, n, K), generator=g, device="cuda",
                      dtype=torch.uint8)
    Ps = [torch.randint(0, 256, (J, K, L), generator=g, device="cuda",
                        dtype=torch.uint8) for _ in range(2)]
    got = gk.gf_matmul_packed_batched(A, Ps[0], s=8)
    want = ref.gf_matmul_packed_batched_ref(A, Ps[0], 8)
    err = int((got.int() - want.int()).abs().max())
    check(err == 0, f"gf_matmul_packed_batched at the served tick's shape "
                    f"{(J, n, K, L)} differs from its plain version")
    del got, want
    plain_a = time_launches(lambda X: ref.gf_matmul_packed_batched_ref(
        A, X, 8), Ps, 2)
    ms = time_launches(lambda X: gk.gf_matmul_packed_batched(A, X, s=8), Ps,
                       200)
    ms_b = time_launches(lambda X: gk.gf_matmul_packed_batched(A, X, s=8),
                         Ps, 200)
    plain_b = time_launches(lambda X: ref.gf_matmul_packed_batched_ref(
        A, X, 8), Ps, 2)
    b_ms, b_by, n_bytes, ops = bound_ms(n, K, L, 8, "ladder")
    b_ms, n_bytes, ops = J * b_ms, J * n_bytes, J * ops
    kernel_ms = min(ms, ms_b)
    print(f"timing gf_matmul_packed_batched at (J,n,K,L)=({J},{n},{K},{L}) "
          f"s=8: kernel {ms:.6f} / {ms_b:.6f} ms, plain {plain_a:.6f} / "
          f"{plain_b:.6f} ms, bound {b_ms:.6f} ms by {b_by} ({n_bytes} "
          f"bytes, {ops} int32 ops), {ops / kernel_ms / 1e9:.3f} T int32 "
          f"op/s, {100 * b_ms / kernel_ms:.2f}% of the {b_by} bound; "
          f"== its plain version there, max_abs_err={err}")
    return {"ms": kernel_ms, "plain_ms": min(plain_a, plain_b),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 7: Qwen3-4B serving at full width and depth
# ---------------------------------------------------------------------------

def qwen_model(cfg, device="cuda"):
    """(params, prompt): bf16 weights at the reference's scales and
    B x S prompt token ids, both drawn from seeds on `device`."""
    from repro_torch.models import transformer as tf

    params = tf.init_lm(torch.Generator(device=device).manual_seed(SEED_QWEN),
                        cfg, device=device)
    prompt = torch.randint(
        0, cfg.vocab_size, (QWEN_BATCH, QWEN_PROMPT), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED_PROMPT))
    return params, prompt


def greedy(logits: torch.Tensor, cfg) -> torch.Tensor:
    """The first generated token: argmax over the real vocabulary."""
    return logits[..., :cfg.vocab_size].float().argmax(dim=-1)


def decode_vs_fresh(fa, cfg, params, prompt, once_per_layer):
    """One decode step after the prompt through the cache, and a fresh
    forward pass over the grown sequence: (cached logits, fresh logits,
    the first generated token), logits float32 at the last position."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tf

    step = make_prefill_step(cfg, cache_len=QWEN_PROMPT + QWEN_DECODE)
    logits, cache = once_per_layer(
        "prefill", lambda: step(params, {"tokens": prompt}))
    check(bool(torch.isfinite(logits).all()), "phase 7: non-finite logits")
    first = greedy(logits, cfg)
    dec, cache = tf.decode_step(params, first, cache, cfg)
    del cache
    h, _ = once_per_layer("forward_hidden", lambda: tf.forward_hidden(
        params, torch.cat([prompt, first], dim=1), cfg))
    fresh = tf._lm_logits(params, h[:, -1:], cfg).float()
    dec = dec.float()
    check(bool(torch.isfinite(dec).all()) and
          bool(torch.isfinite(fresh).all()), "phase 7: non-finite logits")
    return dec, fresh, first


def clear_margin(fresh: torch.Tensor, cfg, tol: dict) -> torch.Tensor:
    """(B, 1) bool: requests whose fresh top-2 margin exceeds twice the
    logits' tolerance, where logits within it cannot change the argmax."""
    top2 = fresh[..., :cfg.vocab_size].topk(2, dim=-1).values
    bound = tol["atol"] + tol["rtol"] * top2.abs().amax(dim=-1)
    return (top2[..., 0] - top2[..., 1]) > 2 * bound


def held_to_fresh(dec, fresh, cfg, tol: dict, what: str,
                  phase: str = "phase 7") -> tuple[float, int]:
    """Cached-decode logits == fresh ones within `tol`, and the same
    greedy token wherever the margin is clear; (max |err|, requests with
    a clear margin)."""
    err = float((dec - fresh).abs().max())
    check(torch.allclose(dec, fresh, **tol),
          f"{phase}: {what} cached decode logits differ from a fresh "
          f"forward (max |err| {err}, tolerance {tol})")
    clear = clear_margin(fresh, cfg, tol)
    check(torch.equal(greedy(dec, cfg)[clear], greedy(fresh, cfg)[clear]),
          f"{phase}: {what} cached and fresh greedy tokens differ at a "
          f"clear margin")
    return err, int(clear.sum())


def phase7(fa, cfg, params, prompt) -> dict:
    """Prefill + greedy decode through the serving steps; checks the
    kernel's launches per prefill and finite logits, and holds the
    cached decode against a fresh forward: in bf16 as served
    (DECODE_TOL_BF16, also the timed serve step's first token and
    log-prob) and on the same weights in float32 (DECODE_TOL).  Returns
    the measurements."""
    from repro_torch.core import packets as pkt
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cache_len = QWEN_PROMPT + QWEN_DECODE
    prefill_step = make_prefill_step(cfg, cache_len=cache_len)
    serve_step = make_serve_step(cfg)

    def once_per_layer(what, run):
        before = fa.flash_attention.launches
        out = run()
        launched = fa.flash_attention.launches - before
        check(launched == cfg.num_layers,
              f"phase 7 {what}: flash_attention launched {launched} times, "
              f"not once per layer ({cfg.num_layers})")
        return out

    # bf16, also the warm-up: cached decode vs fresh forward
    tol16 = {"rtol": 0.0, "atol": DECODE_TOL_BF16}
    dec, fresh, first = decode_vs_fresh(fa, cfg, params, prompt,
                                        once_per_layer)
    bf16_err, bf16_clear = held_to_fresh(dec, fresh, cfg, tol16, "bf16")
    bf16_scale = float(fresh.abs().max())
    del dec

    # the serving run: prefill, then greedy decode through the serve step
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    logits, cache = once_per_layer(
        "prefill", lambda: prefill_step(params, {"tokens": prompt}))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = greedy(logits, cfg)
    tokens, logps = [tok], []
    t0 = time.perf_counter()
    for _ in range(QWEN_DECODE):
        tok, lp, cache = serve_step(params, cache, tok)
        tokens.append(tok)
        logps.append(lp)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    logps = torch.cat(logps, dim=1)
    check(bool(torch.isfinite(logits).all()) and
          bool(torch.isfinite(logps).all()),
          "phase 7: non-finite logits or log-probs")
    check(all(c["pos"] == cache_len for c in cache),
          "phase 7: the caches do not hold prompt + decoded tokens")
    del cache, logits

    # the timed run's first serve step against the same fresh forward,
    # where its prompt token is the warm-up's: through what the step
    # returns, its token (at a clear margin) and its log-prob (a
    # log-softmax moves by at most twice the logits' largest change)
    same = tokens[0] == first
    fresh_lp = torch.log_softmax(fresh[..., :cfg.vocab_size], dim=-1)
    want_lp = fresh_lp.gather(-1, tokens[1][..., None].long())[..., 0]
    lp_err = float((logps[:, :1] - want_lp)[same].abs().max()) \
        if bool(same.any()) else 0.0
    check(lp_err <= 2 * DECODE_TOL_BF16,
          f"phase 7: the timed serve step's log-prob differs from the fresh "
          f"forward's by {lp_err} (limit {2 * DECODE_TOL_BF16})")
    sure = same & clear_margin(fresh, cfg, tol16)
    check(torch.equal(tokens[1][sure].long(), greedy(fresh, cfg)[sure]),
          "phase 7: the timed serve step's token differs from the fresh "
          "forward's at a clear margin")
    n_same, n_sure = int(same.sum()), int(sure.sum())
    del fresh, fresh_lp

    # the same weights in float32: cached decode == fresh forward
    cfg32 = cfg.with_overrides(dtype=torch.float32)
    params32 = pkt.tree_map(lambda t: t.float(), params)
    dec, fresh, _ = decode_vs_fresh(fa, cfg32, params32, prompt,
                                    once_per_layer)
    del params32
    f32_err, f32_clear = held_to_fresh(dec, fresh, cfg, DECODE_TOL,
                                       "float32")
    del dec, fresh
    out = {"prefill_s": prefill_s, "decode_ms": decode_s / QWEN_DECODE * 1e3,
           "peak": peak, "base": base,
           "resident": tree_bytes(params) + tree_bytes(prompt)}
    print(f"phase 7: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads} hd="
          f"{cfg.resolved_head_dim} bf16, B={QWEN_BATCH} prompt "
          f"{QWEN_PROMPT} cache {cache_len}: prefill {prefill_s:.6f} s "
          f"(synchronized), {QWEN_BATCH * QWEN_PROMPT / prefill_s:.1f} prompt "
          f"tokens/s; {QWEN_DECODE} greedy serve steps "
          f"{out['decode_ms']:.3f} ms/step, "
          f"{QWEN_BATCH * 1e3 / out['decode_ms']:.1f} tokens/s; "
          f"max_memory_allocated {peak} bytes; tokens of request 0: "
          f"{torch.cat(tokens, 1)[0, :8].tolist()}...; mean log-prob "
          f"{float(logps.mean()):.4f}")
    print(f"phase 7: first decode step vs fresh forward_hidden on the grown "
          f"sequence (held): bf16 max |err| {bf16_err} on logits up to "
          f"{bf16_scale} (tolerance {tol16}), greedy tokens compared in "
          f"{bf16_clear} of {QWEN_BATCH} requests (clear margin); timed "
          f"serve step: prompt token as the warm-up's in {n_same}, log-prob "
          f"max |err| {lp_err} (limit {2 * DECODE_TOL_BF16}), token compared "
          f"in {n_sure}; float32 max |err| {f32_err} (tolerance "
          f"{DECODE_TOL}), tokens compared in {f32_clear}")
    return out


def trace_serving(cfg, params, prompt) -> None:
    """Profile one prefill (device busy share, the flash kernel's share
    of device time) and one greedy serve step after it."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    step = make_prefill_step(cfg, cache_len=QWEN_PROMPT + QWEN_DECODE)
    out = []
    per_name = device_profile("prefill", lambda: out.append(step(
        params, {"tokens": prompt})))
    total = sum(per_name.values())
    flash = sum(t for name, t in per_name.items()
                if "flash_attention_kernel" in name)
    check(flash > 0, "trace prefill: no flash_attention_kernel on the card")
    print(f"trace prefill: flash_attention_kernel {flash:.1f} us of "
          f"{total:.1f} us device time ({100 * flash / total:.2f}%)")
    logits, cache = out.pop()
    serve_step = make_serve_step(cfg)
    tok, _, cache = serve_step(params, cache, greedy(logits, cfg))  # warm
    device_profile("serve step", lambda: serve_step(params, cache, tok))


# ---------------------------------------------------------------------------
# phase 9: the paper's FL experiment at full width
# ---------------------------------------------------------------------------

GF_KERNELS = ("gf_matmul_packed", "gf_matmul_packed_seeded",
              "gf_matmul_unpacked", "gf2_matmul", "gf_matmul_packed_batched")


class Cohorts:
    """A strategy that keeps each round's cohort, weights and result,
    and the synchronized wall of each aggregation."""

    def __init__(self, strategy):
        self.strategy = strategy
        self.rounds: list = []

    def aggregate(self, client_params, weights, prev_global, rng, **kw):
        from repro_torch.obs import device_sync

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = self.strategy.aggregate(client_params, weights, prev_global,
                                      rng, **kw)
        device_sync(res.global_params)
        ms = (time.perf_counter() - t0) * 1e3
        self.rounds.append((client_params, weights, res, ms))
        return res


class TimedTrainer:
    """A LocalTrainer whose `train` calls are timed synchronized."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.local_epochs = trainer.local_epochs
        self.seconds = 0.0

    def train(self, params, batch_iter):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.trainer.train(params, batch_iter)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return out


def fl_setting():
    """Phase 9's data (numpy, from seeds), partitions and initial CNN."""
    from repro_torch.data import (iid_partition, make_image_dataset)
    from repro_torch.models.cnn import init_cnn

    ds = make_image_dataset(FL_SAMPLES, seed=0, size=32, noise=1.0)
    test = make_image_dataset(FL_TEST, seed=99, size=32, noise=1.0)
    parts = iid_partition(ds.labels, FL_CLIENTS, seed=1)
    init = init_cnn(torch.Generator("cuda").manual_seed(SEED_FL),
                    image_size=32)
    return ds, test, parts, init


def fl_experiment(setting, strategy, optimizer=None):
    from repro_torch.federation import FLExperiment, LocalTrainer
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, merge_bn_stats
    from repro_torch.optim import adam

    ds, test, parts, _ = setting
    trainer = LocalTrainer(loss_fn=lambda p, b: cnn_loss(p, b, train=True),
                           optimizer=optimizer or adam(FL_LR),
                           local_epochs=FL_EPOCHS,
                           state_merge=merge_bn_stats, device="cuda")
    return FLExperiment(trainer=TimedTrainer(trainer),
                        strategy=Cohorts(strategy), partitions=parts,
                        dataset=ds, test_set=test, eval_fn=cnn_accuracy,
                        clients_per_round=FL_PER_ROUND,
                        batch_size=FL_BATCH, seed=SEED_FL)


def fl_strategies() -> dict:
    """The six runs: (strategy, coded, η of its error bound, s)."""
    from repro_torch.core.channel import BlindBoxChannel, MultiHopChannel
    from repro_torch.core.fednc import FedNCConfig
    from repro_torch.federation import (AsyncFedNCStrategy, FedAvgStrategy,
                                        FedNCStrategy,
                                        HierarchicalFedNCStrategy,
                                        blind_box_schedule)
    from repro_torch.sim import STRAGGLER_PROFILES

    box = BlindBoxChannel(budget=FL_PER_ROUND)
    return {
        "fedavg blind box": (FedAvgStrategy(channel=box), False, 1, 0),
        "fednc s=8 blind box": (FedNCStrategy(
            config=FedNCConfig(s=8), channel=box, device="cuda"), True, 1, 8),
        "fednc s=1 blind box": (FedNCStrategy(
            config=FedNCConfig(s=1), channel=box, device="cuda"), True, 1, 1),
        f"fednc s=8 multi-hop eta={FL_ETA}": (FedNCStrategy(
            config=FedNCConfig(s=8), channel=MultiHopChannel(eta=FL_ETA),
            device="cuda"), True, FL_ETA, 8),
        "hierarchical s=1 cuda": (HierarchicalFedNCStrategy(
            config=FedNCConfig(s=1, kernel_impl="cuda"), num_edges=2,
            spare_per_edge=2, device="cuda"), True, 1, 1),
        "async s=8 pareto": (AsyncFedNCStrategy(
            config=FedNCConfig(s=8), budget=FL_PER_ROUND + 8,
            schedule_fn=blind_box_schedule(STRAGGLER_PROFILES["pareto"]),
            device="cuda"), True, 1, 8),
    }


def fl_run(name: str, setting, strategy, coded: bool, eta: int, s: int):
    """One run of `FL_ROUNDS` rounds with checks (a), (b) and (e);
    returns (logs, experiment)."""
    from repro_torch.core.fednc import fedavg_round
    from repro_torch.core.security import error_probability_bound
    from repro_torch.federation import run_async_experiment, run_experiment
    from repro_torch.federation.rounds import final_accuracy
    from repro_torch.sim import ComputeModel

    exp = fl_experiment(setting, strategy)
    t0 = time.perf_counter()
    if name.startswith("async"):
        logs = run_async_experiment(exp, setting[3], FL_ROUNDS,
                                    compute=ComputeModel(measured_scale=1.0))
    else:
        logs = run_experiment(exp, setting[3], FL_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for log in logs:                                               # (b)
        check(np.isfinite(log.train_loss) and 0.0 <= log.test_acc <= 1.0,
              f"phase 9 {name}: round {log.round} loss {log.train_loss} "
              f"accuracy {log.test_acc}")
    exact = 0
    for t, (cohort, weights, res, _) in enumerate(exp.strategy.rounds):
        if coded and res.decoded:                                  # (a)
            want = fedavg_round(cohort, weights, None).global_params
            check(same_tree(res.global_params, want),
                  f"phase 9 {name}: round {t} aggregate != fedavg_round "
                  f"of the same cohort")
            exact += 1
    if name.startswith("async"):                                   # (e)
        for log in logs:
            check(FL_PER_ROUND <= log.consumed <= FL_PER_ROUND + 8
                  and log.sim_time >= log.sim_time_network > 0,
                  f"phase 9 {name}: round {log.round} consumed "
                  f"{log.consumed} sim_time {log.sim_time} network "
                  f"{log.sim_time_network}")
        print(f"phase 9 {name}: consumed {[l.consumed for l in logs]}, "
              f"sim_time {[l.sim_time for l in logs]}, network "
              f"{[l.sim_time_network for l in logs]}")
    fails = sum(not log.decoded for log in logs)
    walls = [log.wall_s for log in logs]
    agg_ms = [ms for *_, ms in exp.strategy.rounds]
    coding = (f"decode failed {fails}/{len(logs)} (error_probability_bound"
              f"(s={s}, eta={eta}) = {error_probability_bound(s, eta):.6f}),"
              f" == fedavg_round bit-exact in {exact} decoded rounds"
              if coded else "uncoded")
    print(f"phase 9 {name}: {FL_ROUNDS} rounds in {wall:.3f} s, {coding}; "
          f"loss {[round(log.train_loss, 6) for log in logs]}, accuracy "
          f"{[log.test_acc for log in logs]} (final_accuracy "
          f"{final_accuracy(logs):.4f}), mean round wall "
          f"{sum(walls) / len(walls):.6f} s, local training "
          f"{100 * exp.trainer.seconds / sum(walls):.2f}% of it, aggregate "
          f"{sum(agg_ms) / len(agg_ms):.3f} ms mean "
          f"({', '.join(f'{ms:.3f}' for ms in agg_ms)})")
    return logs, exp


def fl_step_card_vs_cpu(setting) -> float:
    """(d): one `LocalTrainer` SGD step on the same parameters and batch,
    on the card and on the CPU; returns the largest difference."""
    from repro_torch.core import packets as pkt
    from repro_torch.federation import LocalTrainer
    from repro_torch.models.cnn import cnn_loss, merge_bn_stats
    from repro_torch.optim import sgd

    ds, _, _, init = setting
    batch = (ds.images[:FL_BATCH], ds.labels[:FL_BATCH])
    outs = {}
    for dev in ("cuda", "cpu"):
        trainer = LocalTrainer(loss_fn=lambda p, b: cnn_loss(p, b, train=True),
                               optimizer=sgd(STEP_LR), local_epochs=1,
                               state_merge=merge_bn_stats, device=dev)
        params = pkt.tree_map(lambda x, d=dev: x.to(d), init)
        outs[dev], _ = trainer.train(params, iter([batch]))
    worst = 0.0
    for a, b in zip(pkt.tree_flatten(outs["cuda"])[0],
                    pkt.tree_flatten(outs["cpu"])[0], strict=True):
        a = a.cpu()
        check(torch.allclose(a, b, **STEP_TOL),
              f"phase 9 (d): a card SGD step differs from the CPU's by "
              f"{(a - b).abs().max().item()} ({STEP_TOL})")
        worst = max(worst, (a - b).abs().max().item())
    print(f"phase 9 (d): one LocalTrainer sgd({STEP_LR}) step, card vs "
          f"CPU: every leaf within {STEP_TOL}, max |diff| {worst}")
    return worst


def phase9(wrappers, runs: list) -> None:
    """The six runs, each a main path of its own (launch counts set to 0
    before it and read after, appended to `runs`), then (d) and one
    profiled FedNC s = 8 round."""
    from repro_torch.federation import run_experiment

    t0 = time.perf_counter()
    setting = fl_setting()
    packed = ("gf_matmul_packed",)
    for name, (strategy, coded, eta, s) in fl_strategies().items():
        needs = (("gf2_matmul",) if "hierarchical" in name else packed
                 ) if coded else ()
        counts, _ = main_path(f"phase 9 {name}", wrappers, needs,
                              lambda: fl_run(name, setting, strategy, coded,
                                             eta, s))
        if not coded:                                              # (c)
            check(all(counts[k] == 0 for k in GF_KERNELS),
                  f"phase 9 {name}: a GF kernel was launched: {counts}")
        runs.append((counts, None))
    fl_step_card_vs_cpu(setting)
    strategy = fl_strategies()["fednc s=8 blind box"][0]
    exp = fl_experiment(setting, strategy)
    run_experiment(exp, setting[3], 1)                  # warm, untraced
    device_profile("fl round fednc s=8 blind box",
                   lambda: run_experiment(exp, setting[3], 1))
    print(f"phase 9: {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 10: the scenario grid, the adversary and the network simulator
# ---------------------------------------------------------------------------

def load_check_bench():
    """`scripts/check_bench.py` (standard library only), loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_bench", ROOT / "scripts" / "check_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def without(entry: dict, keys) -> dict:
    return {k: v for k, v in entry.items() if k not in keys}


def launched(wrappers, before: dict) -> dict[str, int]:
    """Launches of each kernel since `before` (a `launch_counts`)."""
    return {k: v - before[k] for k, v in launch_counts(wrappers).items()}


def phase10_grid(wrappers) -> None:
    """(a): the smoke grid through the CLI on the card, against the same
    grid on the CPU and the committed `GRID_smoke.json`."""
    import tempfile

    from repro_torch.grid import __main__ as grid_cli
    from repro_torch.grid import run_grid

    t0 = time.perf_counter()
    before = launch_counts(wrappers)
    with tempfile.TemporaryDirectory() as tmp:
        check(grid_cli.main(["--smoke", "--device", "cuda", "--jobs", "1",
                             "--outdir", tmp]) == 0, "phase 10: grid CLI")
        doc = json.loads((pathlib.Path(tmp) / "GRID_torch_smoke.json")
                         .read_text())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launched(wrappers, before)
    cells = doc["scenarios"]
    committed = json.loads((ROOT / "GRID_smoke.json").read_text())[
        "scenarios"]
    cpu = run_grid(grid_cli.smoke_axes().expand(), jobs=1, device="cpu")
    check(len(cells) == len(committed) == 10,
          f"phase 10 (a): {len(cells)} cells, GRID_smoke.json has "
          f"{len(committed)}")
    for (name, got), ref_name in zip(cells.items(), committed, strict=True):
        want = committed[ref_name]
        if got["axes"]["strategy"] != "engine":
            check(name == ref_name and without(got, GRID_TIMINGS)
                  == without(want, GRID_TIMINGS),
                  f"phase 10 (a): {name} != GRID_smoke.json's {ref_name}")
            continue
        check(without(got, GRID_TIMINGS) == without(cpu[name],
                                                    GRID_TIMINGS),
              f"phase 10 (a): {name} on the card != on the CPU")
        for key in GRID_STRUCTURAL:
            check(got.get(key) == want.get(key),
                  f"phase 10 (a): {name} {key} {got.get(key)} != "
                  f"GRID_smoke.json's {want.get(key)}")
        check(got.get("undetected_bad_decodes", 0) == 0,
              f"phase 10 (a): {name} accepted a corrupted decode")
        print(f"phase 10 (a): {name}: decode_rate {got['decode_rate']} "
              f"wall/round {got['wall_s_per_round'] * 1e3:.3f} ms"
              + "".join(f" {k} {got[k]}" for k in (
                  "eavesdrop_rank_mean", "full_leak_rate",
                  "detection_rate", "rounds_to_recovery_mean") if k in got))
    for k in ("gf_matmul_packed", "gf_matmul_packed_seeded"):
        check(counts[k] > 0, f"phase 10 (a): {k} was not launched")
    errors = load_check_bench().check_grid_smoke("GRID_torch_smoke.json",
                                                 doc)
    check(not errors, f"phase 10 (a): check_grid_smoke: {errors}")
    print(f"phase 10 (a): smoke grid 10 cells on the card in {wall:.3f} s "
          f"(CLI, jobs 1): 4 simulator cells == GRID_smoke.json, 6 engine "
          f"cells == the CPU's and structurally == GRID_smoke.json, "
          f"check_grid_smoke ok; launches {counts}")


def phase10_cells(wrappers) -> None:
    """(b): `hier:2` with `cuda` under `eavesdrop:0.5` at s = 8 and s = 1,
    and one `async_compute` cell, through `run_scenario`."""
    from repro_torch.grid import GridAxes, run_scenario

    for s, kernel in ((8, "gf_matmul_unpacked"), (1, "gf2_matmul")):
        spec = GridAxes(strategy=("hier:2",), kernel=("cuda",),
                        adversary=("eavesdrop:0.5",), clients_per_round=32,
                        rounds=GRID_HIER_ROUNDS, s=s, base_seed=7
                        ).expand()[0]
        before = launch_counts(wrappers)
        got = run_scenario(spec, device="cuda")
        torch.cuda.synchronize()
        counts = launched(wrappers, before)
        want = run_scenario(spec, device="cpu")
        check(without(got, GRID_TIMINGS) == without(want, GRID_TIMINGS),
              f"phase 10 (b): {spec.name} s={s} on the card != on the CPU")
        check(got["rank_wall_holds"] is True,
              f"phase 10 (b): {spec.name} s={s}: the rank wall broke")
        check(got["decode_rate"] > 0 and counts[kernel] > 0,
              f"phase 10 (b): {spec.name} s={s} launched no {kernel}")
        print(f"phase 10 (b): {spec.name} s={s}: decode_rate "
              f"{got['decode_rate']} (== CPU), rank_wall_holds, tapped "
              f"{got['tapped_edges_mean']} of 2 edges, attacker rank "
              f"{got['eavesdrop_rank_mean']} of 32, wall/round "
              f"{got['wall_s_per_round'] * 1e3:.3f} ms; {kernel} "
              f"launches {counts[kernel]}")
    spec = GridAxes(strategy=("async_compute",), straggler=("pareto",),
                    clients_per_round=32, rounds=GRID_ASYNC_ROUNDS,
                    base_seed=7).expand()[0]
    got = run_scenario(spec, device="cuda")
    K = min(spec.clients_per_round, 8)
    check(got["compute_dominates"] is True,
          f"phase 10 (b): {spec.name}: the coupled clock does not dominate")
    check(K <= got["consumed_mean"] <= got["budget"],
          f"phase 10 (b): {spec.name}: consumed {got['consumed_mean']} "
          f"outside [{K}, {got['budget']}]")
    print(f"phase 10 (b): {spec.name}: decode_rate {got['decode_rate']} "
          f"consumed {got['consumed_mean']} of {got['budget']}, sim_time "
          f"{got['sim_time_mean']:.3f} > network {got['sim_time_network_mean']:.3f}"
          f", loss {got['final_train_loss']:.4f}, wall {got['wall_s']:.3f} s")


def phase10_adversary(clients) -> None:
    """(c): the eavesdroppers and the replay attack on one seeded round
    of the CNN clients."""
    from repro_torch.adversary import EavesdropperView, replayed_seed_batch
    from repro_torch.core import rlnc
    from repro_torch.core.channel import Eavesdropper
    from repro_torch.engine import CodingEngine, EngineConfig
    from repro_torch.engine.stream import StreamDecoder

    eng = CodingEngine(EngineConfig(s=8, kernel="cuda_packed_seeded",
                                    extra_tuples=ADV_EXTRA), device="cuda")
    P, _ = eng.packetize(clients)
    K, L = P.shape
    seeds = eng.coding_seeds(torch.Generator().manual_seed(SEED_ADV),
                             K + ADV_EXTRA)
    batch = eng.encode_seeded(P, seeds)
    check(torch.equal(rlnc.encode_seeded(P, seeds, 8).C, batch.C),
          "phase 10 (c): rlnc.encode_seeded != the engine's encode")
    ok, sel = rlnc.select_rows(batch.expand(8), 8)
    dec_ok, P_hat = rlnc.decode(sel, 8)
    check(ok and dec_ok and torch.equal(P_hat, P),
          "phase 10 (c): rlnc.decode of the round != P")
    view = EavesdropperView(K=K, s=8, seed=SEED_ADV, p_intercept=ADV_P)
    view.intercept(batch.seeds)
    rows_view = EavesdropperView(K=K, s=8, seed=SEED_ADV, p_intercept=ADV_P)
    rows_view.intercept(eng.expand_seeds(seeds, K))
    check(view.report() == rows_view.report(),
          "phase 10 (c): seed headers and rows gave different views")
    one_shot = Eavesdropper(ADV_P, seed=SEED_ADV).attack_encoded(
        batch.expand(8), 8)
    print(f"phase 10 (c): K={K} L={L} {K + ADV_EXTRA} seeded tuples, "
          f"p={ADV_P}: EavesdropperView {view.report()}; Eavesdropper "
          f"{one_shot}")
    attacked = replayed_seed_batch(batch, ADV_REPLAYS, s=8, seed=SEED_ADV)
    dec = StreamDecoder(K, L, s=8, detect=True, device="cuda")
    dec.ingest(attacked.seeds, attacked.C)
    ok, P_hat = dec.decode()
    torch.cuda.synchronize()
    check(dec.inconsistent == ADV_REPLAYS,
          f"phase 10 (c): {dec.inconsistent} inconsistent arrivals, "
          f"{ADV_REPLAYS} replayed")
    check(ok and torch.equal(P_hat, P),
          "phase 10 (c): the replayed stream's decode != P")
    print(f"phase 10 (c): {ADV_REPLAYS} replayed seed headers: "
          f"inconsistent {dec.inconsistent}, first at "
          f"{dec.first_inconsistent_at}, decoded at {dec.decoded_at}, "
          f"decode == P")


def phase10_sim() -> None:
    """(d): `NetworkSimulator` at `examples/sim_scale.py`'s default scale
    against the reference's summaries (host work: a rank-only decoder)."""
    from repro_torch.sim import (STRAGGLER_PROFILES, NetworkSimulator,
                                 PopulationConfig, SimConfig)

    fixture = json.loads(SIM_SCALE.read_text())
    scale = fixture["config"]
    for straggler, want in fixture["summaries"].items():
        cfg = SimConfig(population=PopulationConfig(
            n_clients=scale["n_clients"]),
            clients_per_round=scale["clients_per_round"],
            gap=STRAGGLER_PROFILES[straggler], decoder="stream",
            seed=scale["seed"])
        t0 = time.perf_counter()
        got = NetworkSimulator(cfg).run(scale["rounds"]).summary()
        wall = time.perf_counter() - t0
        check(got.keys() == want.keys() and all(
            got[k] == want[k] for k in want if not k.startswith("time_")),
            f"phase 10 (d): {straggler}: {got} != the reference's {want}")
        rel = max(abs(got[k] - want[k]) / abs(want[k])
                  for k in want if k.startswith("time_"))
        check(rel <= SIM_CLOCK_RTOL,
              f"phase 10 (d): {straggler}: clock fields {rel:.3e} "
              f"from the reference's: {got} != {want}")
        print(f"phase 10 (d): NetworkSimulator {scale['n_clients']} "
              f"clients K={scale['clients_per_round']} "
              f"{scale['rounds']} rounds {straggler}: == "
              f"{SIM_SCALE.name} (clock fields within {rel:.3e}, numpy "
              f"{np.__version__}); "
              f"draw_ratio {got['draw_ratio']:.4f} "
              f"time_speedup {got['time_speedup']:.4f}; host wall "
              f"{wall:.3f} s")


def phase10(wrappers, clients) -> None:
    t0 = time.perf_counter()
    phase10_grid(wrappers)
    phase10_cells(wrappers)
    phase10_adversary(clients)
    phase10_sim()
    print(f"phase 10: {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 11: FL-LM training at Qwen3-4B's full width
# ---------------------------------------------------------------------------

def leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


def phase11_flash(fa, attn, shape: tuple[int, ...]) -> float:
    """(a) at the attention shape (B, S, H, KV, hd), bf16 and float32:
    the Function's output == the kernel's and == `flash_attention_ref`
    within FLASH_TOL, and its dq, dk, dv == autograd through `_attend`
    (K and V expanded) in float32 on the same values within FLASH_TOL;
    times the backward and PyTorch's fused attention's.  Returns the
    largest gradient error."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import attention_backward

    B, S, H, KV, hd = shape
    g = torch.Generator(device="cuda").manual_seed(SEED_F1)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn((B, S, n, hd), generator=g,
                                   device="cuda").to(dtype)
                       for n in (H, KV, KV, H))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = fa.flash_attention.launches
        out = fa.flash_attention(*leaves)
        check(fa.flash_attention.launches == before + 1,
              "phase 11 (a): the Function did not launch the kernel once")
        check(torch.equal(out, fa._launch(q, k, v, True)),
              f"phase 11 (a): {dtype} Function output != the kernel's")
        tol = FLASH_TOL[dtype]
        want_out = ref.flash_attention_ref(q, k, v, causal=True).float()
        fwd_err = leaf_err(out, want_out)
        check(torch.allclose(out.float(), want_out, **tol),
              f"phase 11 (a): {dtype} {shape} forward differs from "
              f"flash_attention_ref (max |err| {fwd_err}, tolerance {tol})")
        del want_out
        got = torch.autograd.grad(out, leaves, do)
        del out, leaves
        ref32 = [x.float().requires_grad_() for x in (q, k, v)]
        o = attn._attend(ref32[0], attn._expand_kv(ref32[1], H // KV),
                         attn._expand_kv(ref32[2], H // KV), causal=True,
                         window=None, q_offset=0)
        want = torch.autograd.grad(o, ref32, do.float())
        del o, ref32
        errs = []
        for name, a, b in zip("qkv", got, want, strict=True):
            check(a.dtype == dtype and bool(torch.isfinite(a).all()),
                  f"phase 11 (a): d{name} {a.dtype} or not finite")
            errs.append(leaf_err(a, b))
            check(torch.allclose(a.float(), b, **tol),
                  f"phase 11 (a): {dtype} d{name} differs from autograd "
                  f"through _attend (max |err| {errs[-1]}, tolerance {tol})")
        worst = max(worst, *errs)
        del got, want
        # the backward's time, and the library's fused backward's
        bwd_ms = time_launches(
            lambda x: attention_backward(*x, causal=True), [(q, k, v, do)],
            3)
        lib = [x.transpose(1, 2).repeat_interleave(H // x.shape[2], dim=1)
               .contiguous().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib, is_causal=True)
        lib_do = do.transpose(1, 2).contiguous()
        lib_ms = time_launches(lambda x: torch.autograd.grad(
            lib_out, lib, x, retain_graph=True), [lib_do], 5)
        del lib, lib_out, lib_do
        print(f"phase 11 (a): {str(dtype)[6:]} (B,S,H,KV,hd)="
              f"{(B, S, H, KV, hd)} causal: Function output == the "
              f"kernel's, == flash_attention_ref (max |err| {fwd_err}); "
              f"dq, dk, dv == autograd through _attend in "
              f"float32 (max |err| {errs[0]} / {errs[1]} / {errs[2]}, "
              f"tolerance {tol}); backward (plain PyTorch, float32) "
              f"{bwd_ms:.3f} ms, scaled_dot_product_attention's backward "
              f"{lib_ms:.3f} ms")
    return worst


def phase11_attention_grads(cfg, params, batch) -> None:
    """(a) one loss through `forward_hidden` of the full-width model
    gives every attention parameter of every layer a finite, non-zero
    gradient."""
    from repro_torch.core.packets import tree_flatten, tree_unflatten
    from repro_torch.models import transformer as tf

    leaves, treedef = tree_flatten(params)
    live = [t.detach().requires_grad_() for t in leaves]
    tree = tree_unflatten(treedef, live)
    shard = {k: x[:1] for k, x in batch.items()}
    h, _ = tf.forward_hidden(tree, shard["tokens"], cfg)
    h.float().square().mean().backward()
    names = ("wq", "wk", "wv", "wo", "qnorm", "knorm")
    n = 0
    for i, layer in enumerate(tree["decoder"]):
        for name in names:
            for t in tree_flatten(layer["attn"][name])[0]:
                ok = (t.grad is not None and bool(torch.isfinite(t.grad).all())
                      and float(t.grad.abs().max()) > 0)
                check(ok, f"phase 11 (a): layer {i} {name} has no finite "
                          f"non-zero gradient")
                n += 1
    print(f"phase 11 (a): a loss through forward_hidden ({cfg.num_layers} "
          f"layers, d={cfg.d_model}, 1 x {TRAIN_SEQ} tokens) gives all {n} "
          f"attention parameters ({', '.join(names)}) a finite non-zero "
          f"gradient")


def phase11_aggregation(cfg, params, batch) -> dict:
    """(b) one per-client gradient stack at full width through each
    aggregation mode (synchronized ms); every coded mean == the plain
    one within AGG_TOL.  Returns the ms and client 0's gradients of the
    first leaves, at most DIST_SLICE_BYTES, as (1, ...) host tensors."""
    from repro_torch.core.dist import mix_matrix
    from repro_torch.core.packets import tree_flatten
    from repro_torch.launch.steps import (aggregate_gradients,
                                          client_gradients)

    K = TRAIN_CLIENTS
    losses, stack = client_gradients(params, batch, cfg, K)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(losses).all()),
          f"phase 11 (b): non-finite client losses {losses.tolist()}")
    A = mix_matrix(torch.Generator().manual_seed(SEED_MIX), K)
    plain, ms = None, {}
    for mode in ("plain", "fednc_naive", "fednc_blocked"):
        aggregate_gradients(stack, None, K, mode, A=A)          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean = aggregate_gradients(stack, None, K, mode, A=A)
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) * 1e3
        if plain is None:
            plain = tree_flatten(mean)[0]
            continue
        errs = []
        for a, b in zip(tree_flatten(mean)[0], plain, strict=True):
            check(bool(torch.allclose(a.float(), b.float(), **AGG_TOL)),
                  f"phase 11 (b): {mode} mean differs from plain's "
                  f"(max |err| {leaf_err(a, b)}, tolerance {AGG_TOL})")
            errs.append(leaf_err(a, b) / max(float(b.float().abs().max()),
                                             1e-30))
        del mean
        print(f"phase 11 (b): {mode} == plain mean within {AGG_TOL} on "
              f"every leaf (largest |err| / leaf scale {max(errs):.3e})")
    n = sum(t.numel() for t in plain)
    print(f"phase 11 (b): aggregation of K={K} per-client gradients of "
          f"{n} bf16 parameters ({2 * K * n} bytes), synchronized: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; client losses {[round(x, 4) for x in losses.tolist()]}")
    # phase 15 (d) codes client 0's gradients of the first leaves, up to
    # DIST_SLICE_BYTES, again: kept on the host until then
    grads, total = {}, 0
    for i, leaf in enumerate(tree_flatten(stack)[0]):
        if total + leaf[0].numel() * leaf.element_size() > DIST_SLICE_BYTES:
            break
        grads[f"leaf{i}"] = leaf[:1].cpu()
        total += leaf[0].numel() * leaf.element_size()
    return ms, grads


def train_launches(cfg) -> int:
    """The flash launches of phase 11's training run: each client's
    forward and its remat recompute, per layer, per step."""
    return 2 * cfg.num_layers * TRAIN_CLIENTS * TRAIN_STEPS


def phase11_train(cfg, holder: dict):
    """(b) TRAIN_STEPS steps of `fednc_blocked` through `launch.train`'s
    loop on `holder["params"]`, which it takes (so that only the run
    holds the weights a step replaces): finite losses; returns the
    run."""
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.train import train

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    resident = tree_bytes(holder["params"])
    run = train(cfg, holder.pop("params"), steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, clients=TRAIN_CLIENTS, agg=TRAIN_AGG,
                lr=TRAIN_LR, log_every=1,
                log=lambda line: print(f"phase 11 (b): {line}"))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(run.losses)),
          f"phase 11 (b): non-finite losses {run.losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    timed = run.step_s[1:]
    print(f"phase 11 (b): {cfg.name} {cfg.num_layers} of 36 layers d="
          f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} hd="
          f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab {cfg.vocab_size} "
          f"bf16, K={TRAIN_CLIENTS}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a "
          f"step, adamw, remat, {TRAIN_AGG}: losses {run.losses}; step "
          f"walls (synchronized) {run.step_s} s; after the first step "
          f"{tokens * len(timed) / sum(timed):.1f} tokens/s ({len(timed)} "
          f"steps: {[round(tokens / t, 1) for t in timed]}); "
          f"max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB)")
    return run, {"peak": peak, "base": base, "resident": resident,
                 "step_s": list(run.step_s)}


def phase11_trace(fa, cfg, run) -> None:
    """(b) one more step under torch.profiler: device busy, top kernels,
    the flash forward's share, and the plain backward's: each of its
    calls in the step is bracketed by CUDA events, whose elapsed times
    are the stream time the backward held."""
    from repro_torch.data.tokens import make_token_stream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw, linear_warmup_cosine

    step = make_train_step(cfg, adamw(linear_warmup_cosine(
        TRAIN_LR, 10, TRAIN_STEPS)), num_clients=TRAIN_CLIENTS,
        agg_mode=TRAIN_AGG)
    b = make_token_stream(cfg.vocab_size, seed=1).batch(TRAIN_BATCH,
                                                        TRAIN_SEQ)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in b.items()}
    gen = torch.Generator().manual_seed(SEED_MIX)
    backward, marks = fa.attention_backward, []

    def timed_backward(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        grads = backward(*args, **kw)
        stop.record()
        marks.append((start, stop))
        return grads

    out = []

    def traced_step():
        t0 = time.perf_counter()
        out.append(step(run.params, run.opt_state, batch, gen))
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)

    fa.attention_backward = timed_backward
    try:
        per_name = device_profile("train step", traced_step)
    finally:
        fa.attention_backward = backward
    wall_ms = out.pop()
    run.params, run.opt_state, _ = out.pop()
    busy = sum(per_name.values())
    flash = sum(t for n, t in per_name.items()
                if "flash_attention_kernel" in n)
    check(flash > 0, "trace train step: no flash_attention_kernel")
    calls = cfg.num_layers * TRAIN_CLIENTS
    check(len(marks) == calls, f"trace train step: {len(marks)} flash "
                               f"backward calls, not {calls}")
    bwd_ms = sum(a.elapsed_time(z) for a, z in marks)
    print(f"trace train step: flash_attention_kernel {flash:.1f} us of "
          f"{busy:.1f} us summed kernel time ({100 * flash / busy:.2f}%); "
          f"the plain backward's {calls} calls held the stream "
          f"{bwd_ms:.3f} ms (CUDA events in the traced step; "
          f"{100 * bwd_ms / wall_ms:.2f}% of the step's {wall_ms:.3f} ms "
          f"synchronized wall under the profiler)")


def phase11_card_vs_cpu(arch: str, label: str = "phase 11 (c)") -> None:
    """(c) one float32 step of the reduced `arch` on the card and on the
    CPU from the same weights, batch and mixing matrix: per-client and
    aggregated gradients within GRAD_TOL, the same loss."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.dist import mix_matrix
    from repro_torch.core.packets import tree_flatten, tree_map
    from repro_torch.data.tokens import make_token_stream
    from repro_torch.launch.steps import (aggregate_gradients,
                                          client_gradients)
    from repro_torch.models import transformer as tf

    cfg = reduced_config(arch).with_overrides(dtype=torch.float32)
    K = TRAIN_CLIENTS
    params = tf.init_lm(torch.Generator().manual_seed(SEED_QWEN), cfg,
                        device="cpu")
    b = make_token_stream(cfg.vocab_size, seed=0).batch(REDUCED_BATCH,
                                                        REDUCED_SEQ)
    A = mix_matrix(torch.Generator().manual_seed(SEED_MIX), K)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t, dev=dev: t.to(dev), params)
        batch = {k: torch.from_numpy(v).long().to(dev) for k, v in b.items()}
        losses, stack = client_gradients(p, batch, cfg, K)
        mean = aggregate_gradients(stack, None, K, TRAIN_AGG, A=A)
        outs[dev] = (losses.cpu(), [t.cpu() for t in tree_flatten(stack)[0]],
                     [t.cpu() for t in tree_flatten(mean)[0]])
    worst = 0.0
    for what, i in (("per-client", 1), ("aggregated", 2)):
        for j, (a, b_) in enumerate(zip(outs["cuda"][i], outs["cpu"][i],
                                        strict=True)):
            bound = (GRAD_TOL["rtol"] * b_.abs()
                     + GRAD_TOL["scale"] * b_.abs().max())
            diff = (a - b_).abs()
            check(bool((diff <= bound).all()),
                  f"{label}: {what} gradient leaf {j} differs from the "
                  f"CPU's (max |err| {float(diff.max())}, {GRAD_TOL})")
            worst = max(worst, float(diff.max() / b_.abs().max()))
    check(torch.allclose(outs["cuda"][0], outs["cpu"][0], rtol=1e-5,
                         atol=0), f"{label}: client losses differ")
    print(f"{label}: reduced {arch} float32, K={K}, {REDUCED_BATCH} x "
          f"{REDUCED_SEQ} tokens, {TRAIN_AGG}: per-client and aggregated "
          f"gradients on the card == the CPU's within {GRAD_TOL} (largest "
          f"|err| / leaf scale {worst:.3e}); losses "
          f"{outs['cuda'][0].tolist()} / {outs['cpu'][0].tolist()}")


def phase11_checkpoint(params) -> None:
    """(d) save_pytree / load_pytree of the trained parameters round-trip
    bit for bit on the card."""
    import shutil

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.core.packets import tree_flatten

    where = ROOT / "build" / "phase11_ckpt"
    where.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        save_pytree(str(where / "params"), params,
                    metadata={"phase": 11, "steps": TRAIN_STEPS})
        save_s = time.perf_counter() - t0
        size = (where / "params.npz").stat().st_size
        t0 = time.perf_counter()
        back = load_pytree(str(where / "params"), params, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        pairs = list(zip(tree_flatten(back)[0], tree_flatten(params)[0],
                         strict=True))
        check(all(a.device == b.device and a.dtype == b.dtype
                  and torch.equal(a, b) for a, b in pairs),
              "phase 11 (d): the loaded parameters differ from the saved")
        keys = json.loads((where / "params.manifest.json").read_text())
        print(f"phase 11 (d): save_pytree / load_pytree of {len(pairs)} "
              f"trained leaves ({size} bytes of npz, bf16 widened) "
              f"round-trip bit for bit on the card (save {save_s:.3f} s, "
              f"load {load_s:.3f} s; manifest of {len(keys['keys'])} keys)")
    finally:
        shutil.rmtree(where, ignore_errors=True)


def phase11(fa, attn, wrappers, cfg, holder: dict) -> dict:
    """Phase 11; `holder["params"]` (phase 7's weights cut to
    TRAIN_LAYERS) is taken, so that only the training run holds them.
    Returns the training run's launch counts and, for phase 15, its
    measurements and a 1-GiB slice of a client's gradients (on the
    host)."""
    from repro_torch.core.packets import tree_flatten
    from repro_torch.data.tokens import make_token_stream

    t0 = time.perf_counter()
    cfg = cfg.with_overrides(num_layers=TRAIN_LAYERS)
    params = holder.pop("params")
    b = make_token_stream(cfg.vocab_size, seed=0).batch(TRAIN_BATCH,
                                                        TRAIN_SEQ)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in b.items()}
    # phase 7's prefill shape and the training run's per-client shape
    grad_err = max(phase11_flash(fa, attn, shape) for shape in (
        (QWEN_BATCH, QWEN_PROMPT, 32, 8, 128),
        (TRAIN_BATCH // TRAIN_CLIENTS, TRAIN_SEQ, 32, 8, 128)))
    phase11_attention_grads(cfg, params, batch)
    torch.cuda.reset_peak_memory_stats()
    _, grads = phase11_aggregation(cfg, params, batch)
    print(f"phase 11 (b): max_memory_allocated of the aggregation check "
          f"{torch.cuda.max_memory_allocated()} bytes")
    del batch
    # the first remat call (the aggregation check's) imports torch's
    # compiler stack, which leaves its callers' frames, and with them a
    # gradient stack, in a reference cycle: collect it before training
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 11 (b): memory_allocated before the training run "
          f"{torch.cuda.memory_allocated()} bytes (the weights "
          f"{sum(t.numel() * t.element_size() for t in tree_flatten(params)[0])})")
    holder["params"] = params
    del params
    counts, (run, measured) = main_path(
        "phase 11", wrappers, ("flash_attention",),
        lambda: phase11_train(cfg, holder))
    want = train_launches(cfg)
    check(counts["flash_attention"] == want,
          f"phase 11 (b): flash_attention launched "
          f"{counts['flash_attention']} times, not {want} (forward and "
          f"remat recompute, per layer, per client, per step)")
    phase11_trace(fa, cfg, run)
    phase11_card_vs_cpu(QWEN)
    phase11_checkpoint(run.params)
    print(f"phase 11: {time.perf_counter() - t0:.3f} s; flash launches of "
          f"the training run {counts['flash_attention']} == 2 x "
          f"{cfg.num_layers} layers x {TRAIN_CLIENTS} clients x "
          f"{TRAIN_STEPS} steps; largest flash gradient error {grad_err}")
    return counts, {"train": measured, "grads": grads}


# ---------------------------------------------------------------------------
# phase 12: the recurrent and windowed families at full width
# ---------------------------------------------------------------------------

def m3_model(cfg, batch: int, prompt_len: int):
    """(params, prompt): bf16 weights at the reference's scales and
    batch x prompt_len token ids, both drawn from seeds on the card."""
    from repro_torch.models import transformer as tf

    params = tf.init_lm(torch.Generator(device="cuda").manual_seed(SEED_M3),
                        cfg, device="cuda")
    prompt = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED_M3_PROMPT))
    return params, prompt


def flash_counted(fa, what: str, want: int, run, phase: str = "phase 12"):
    """`run()`, checking that it launched the flash kernel `want` times."""
    before = fa.flash_attention.launches
    out = run()
    n = fa.flash_attention.launches - before
    check(n == want, f"{phase} {what}: flash_attention launched {n} times, "
                     f"not {want}")
    return out


def finite_state(cache) -> bool:
    """Every tensor of a decode cache (a list of KV caches, recurrent
    states and cross caches, nested dicts; "pos" ints skipped) is
    finite; a recurrent state's m starts at -1e30, which is finite."""
    if isinstance(cache, dict):
        cache = list(cache.values())
    if isinstance(cache, list):
        return all(finite_state(c) for c in cache)
    return not isinstance(cache, torch.Tensor) or bool(
        torch.isfinite(cache).all())


def phase12_serve(fa, arch: str):
    """(a) M3_BATCH prompts of M3_PROMPT ids through `make_prefill_step`
    (cache prompt + M3_DECODE; one warm prefill, then the timed one) and
    M3_DECODE greedy steps through `make_serve_step` (the first one warm,
    the rest timed): finite logits and states, flash launched once per
    layer per prefill for StarCoder2-15B (S <= window, hd 128) and never
    for the others, and the last step's cached logits == a fresh
    `forward_hidden` over prompt + the fed tokens within
    DECODE_TOL_BF16 (xLSTM-125M: on its weights in float32 within
    M3_F32_TOL, its bf16 error measured); then profiles one more
    prefill.  Returns (params, measurements)."""
    from repro_torch.configs import get_config
    from repro_torch.core.packets import tree_flatten
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tf

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params, prompt = m3_model(cfg, M3_BATCH, M3_PROMPT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    flash = cfg.num_layers if arch == "starcoder2-15b" else 0
    cache_len = M3_PROMPT + M3_DECODE
    prefill_step = make_prefill_step(cfg, cache_len=cache_len)
    serve_step = make_serve_step(cfg)
    batch = {"tokens": prompt}
    flash_counted(fa, f"{arch} warm prefill", flash,
                  lambda: prefill_step(params, batch))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = flash_counted(fa, f"{arch} prefill", flash,
                                  lambda: prefill_step(params, batch))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()),
          f"phase 12 (a): {arch} non-finite prefill logits")
    tokens, logps, kept = [greedy(logits, cfg)], [], []
    del logits
    decode_step = tf.decode_step

    def keeping(*args, **kw):       # the serve step's logits, kept
        out = decode_step(*args, **kw)
        kept[:] = [out[0]]
        return out

    tf.decode_step = keeping
    try:
        tok, lp, cache = serve_step(params, cache, tokens[-1])   # warm
        tokens.append(tok)
        logps.append(lp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(M3_DECODE - 1):
            tok, lp, cache = serve_step(params, cache, tok)
            tokens.append(tok)
            logps.append(lp)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / (M3_DECODE - 1) * 1e3
    finally:
        tf.decode_step = decode_step
    peak = torch.cuda.max_memory_allocated()
    logps = torch.cat(logps, dim=1)
    check(bool(torch.isfinite(logps).all()) and finite_state(cache),
          f"phase 12 (a): {arch} non-finite log-probs or decode state")
    check(all(c["pos"] == cache_len for c in cache if "pos" in c),
          f"phase 12 (a): {arch} KV caches do not hold prompt + decoded "
          f"tokens")
    n_kv = sum("pos" in c for c in cache)
    del cache
    dec = kept.pop().float()
    # the last step fed tokens[-2]: the fresh forward runs over the
    # prompt and every token fed, prompt + M3_DECODE in all
    seq = torch.cat([prompt] + [t.long() for t in tokens[:-1]], dim=1)
    h, _ = flash_counted(fa, f"{arch} forward_hidden", flash,
                         lambda: tf.forward_hidden(params, seq, cfg))
    fresh = tf._lm_logits(params, h[:, -1:], cfg).float()
    del h
    tol16 = {"rtol": 0.0, "atol": DECODE_TOL_BF16}
    scale = float(fresh.abs().max())
    if arch in M3_F32_HELD:
        err = float((dec - fresh).abs().max())
        del dec, fresh
        f32_err = m3_decode_f32(cfg, params, prompt, tokens[:-1])
        held = (f"bf16 max |err| {err} (measured, not held), float32 "
                f"(the same weights) max |err| {f32_err} (held: "
                f"{M3_F32_TOL})")
    else:
        err, clear = held_to_fresh(dec, fresh, cfg, tol16, arch,
                                   phase="phase 12 (a)")
        del dec, fresh
        held = (f"max |err| {err} (tolerance {tol16}), greedy tokens "
                f"compared in {clear} of {M3_BATCH} requests (clear margin)")
    kinds = Counter(tf.layer_kinds(cfg))
    out = {"prefill_s": prefill_s, "decode_ms": decode_ms, "peak": peak,
           "err": err}
    print(f"phase 12 (a): {arch} {cfg.num_layers} layers "
          f"({', '.join(f'{n} {k}' for k, n in kinds.items())}) d="
          f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} hd="
          f"{cfg.resolved_head_dim} window {cfg.window} vocab "
          f"{cfg.vocab_size} bf16 ({n_params} parameters, drawn in "
          f"{init_s:.3f} s), B={M3_BATCH} prompt {M3_PROMPT} cache "
          f"{cache_len} ({n_kv} KV caches): prefill {prefill_s:.6f} s "
          f"(synchronized, after a warm one), "
          f"{M3_BATCH * M3_PROMPT / prefill_s:.1f} prompt tokens/s; "
          f"{M3_DECODE} greedy serve steps, {M3_DECODE - 1} timed after a "
          f"warm one: {decode_ms:.3f} ms/step, "
          f"{M3_BATCH * 1e3 / decode_ms:.1f} tokens/s; "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB); "
          f"flash launches a prefill {flash}; tokens of request 0: "
          f"{torch.cat(tokens, 1)[0, :8].tolist()}...; mean log-prob "
          f"{float(logps.mean()):.4f}")
    print(f"phase 12 (a): {arch} last decode step vs fresh forward_hidden "
          f"over {seq.shape[1]} tokens, logits up to {scale}: {held}")
    flash_counted(fa, f"{arch} traced prefill", flash, lambda: device_profile(
        f"phase 12 (a) {arch} prefill", lambda: prefill_step(params, batch)))
    return params, out


def m3_decode_f32(cfg, params, prompt, fed: list) -> float:
    """(a) on `params` cast to float32: prefill the prompt, decode the
    fed tokens one at a time, and hold the last step's logits against a
    fresh forward over the prompt and all of them within M3_F32_TOL;
    returns the max |err|."""
    from repro_torch.core.packets import tree_map
    from repro_torch.models import transformer as tf

    cfg32 = cfg.with_overrides(dtype=torch.float32)
    params32 = tree_map(lambda t: t.float(), params)
    _, cache = tf.prefill(params32, prompt, cfg32,
                          cache_len=prompt.shape[1] + len(fed))
    for tok in fed:
        dec, cache = tf.decode_step(params32, tok, cache, cfg32)
    del cache
    seq = torch.cat([prompt] + [t.long() for t in fed], dim=1)
    h, _ = tf.forward_hidden(params32, seq, cfg32)
    fresh = tf._lm_logits(params32, h[:, -1:], cfg32)
    del h, params32
    err = float((dec - fresh).abs().max())
    check(torch.allclose(dec, fresh, **M3_F32_TOL),
          f"phase 12 (a): {cfg.name} float32 cached decode logits differ "
          f"from a fresh forward (max |err| {err}, tolerance {M3_F32_TOL})")
    return err


def phase12_long(fa, attn, params) -> dict:
    """(b) StarCoder2-15B, one prompt of M3_LONG_PROMPT ids with
    window=cfg.window given, so the cache is a ring of cfg.window slots
    and each layer's prefill attention is `_attend_chunked` (S above
    CHUNK_THRESHOLD and the window): no flash launch, one chunked call a
    layer; then M3_LONG_DECODE serve steps; finite logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg = get_config("starcoder2-15b")
    prompt = torch.randint(
        0, cfg.vocab_size, (1, M3_LONG_PROMPT), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED_M3_PROMPT))
    cache_len = M3_LONG_PROMPT + M3_LONG_DECODE
    prefill_step = make_prefill_step(cfg, cache_len=cache_len,
                                     window=cfg.window)
    serve_step = make_serve_step(cfg, window=cfg.window)
    chunked, calls = attn._attend_chunked, []

    def counting(*args, **kw):
        calls.append(args[0].shape[1])
        return chunked(*args, **kw)

    attn._attend_chunked = counting
    try:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = flash_counted(
            fa, "long prefill", 0,
            lambda: prefill_step(params, {"tokens": prompt}))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    finally:
        attn._attend_chunked = chunked
    check(calls == [M3_LONG_PROMPT] * cfg.num_layers,
          f"phase 12 (b): _attend_chunked called for {calls}, not once per "
          f"layer ({cfg.num_layers}) at {M3_LONG_PROMPT} tokens")
    check(all(c["k"].shape[1] == cfg.window for c in cache),
          "phase 12 (b): the caches are not rings of the window")
    check(bool(torch.isfinite(logits).all()),
          "phase 12 (b): non-finite prefill logits")
    tok, lps = greedy(logits, cfg), []
    t0 = time.perf_counter()
    for _ in range(M3_LONG_DECODE):
        tok, lp, cache = serve_step(params, cache, tok)
        lps.append(lp)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / M3_LONG_DECODE * 1e3
    peak = torch.cuda.max_memory_allocated()
    lps = torch.cat(lps, dim=1)
    check(bool(torch.isfinite(lps).all()) and finite_state(cache),
          "phase 12 (b): non-finite log-probs or cache")
    check(all(c["pos"] == cache_len for c in cache),
          "phase 12 (b): the caches do not count prompt + decoded tokens")
    del cache
    # q·kᵀ and P·V of every 512-query chunk against all S keys, per layer
    flops = 4 * cfg.num_heads * cfg.resolved_head_dim * M3_LONG_PROMPT ** 2
    print(f"phase 12 (b): {cfg.name} one prompt of {M3_LONG_PROMPT} tokens, "
          f"window {cfg.window} given (a {cfg.window}-slot ring): prefill "
          f"{prefill_s:.6f} s (synchronized; _attend_chunked once a layer, "
          f"{flops / 1e12:.3f} TFLOP of float32 scores a layer, "
          f"{cfg.num_layers * flops / prefill_s / 1e12:.3f} TFLOP/s of them "
          f"over the whole prefill), {M3_LONG_PROMPT / prefill_s:.1f} "
          f"prompt tokens/s; {M3_LONG_DECODE} serve steps {decode_ms:.3f} "
          f"ms/step; max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB); log-probs {lps[0].tolist()}")
    return {"prefill_s": prefill_s, "decode_ms": decode_ms, "peak": peak}


def phase12_train() -> None:
    """(c) xLSTM-125M at full width as `examples/train_fl_lm.py --full`
    runs it: `launch.train` with its defaults (K = 4, 8 x 128 tokens,
    fednc_blocked, AdamW, remat), TRAIN_STEPS steps: finite losses, step
    walls and tokens/s; then one more step under the profiler (device
    busy share)."""
    from repro_torch.configs import get_config
    from repro_torch.core.packets import tree_flatten
    from repro_torch.data.tokens import make_token_stream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw, linear_warmup_cosine

    cfg = get_config("xlstm-125m")
    params = tf.init_lm(torch.Generator(device="cuda").manual_seed(SEED_M3),
                        cfg, device="cuda")
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    torch.cuda.reset_peak_memory_stats()
    run = train(cfg, params, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                seq=M3_TRAIN_SEQ, clients=TRAIN_CLIENTS, agg=TRAIN_AGG,
                lr=TRAIN_LR, log_every=1,
                log=lambda line: print(f"phase 12 (c): {line}"))
    del params
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(run.losses)),
          f"phase 12 (c): non-finite losses {run.losses}")
    tokens = TRAIN_BATCH * M3_TRAIN_SEQ
    timed = run.step_s[1:]
    print(f"phase 12 (c): {cfg.name} {cfg.num_layers} layers d="
          f"{cfg.d_model} heads {cfg.num_heads} vocab {cfg.vocab_size} bf16 "
          f"({n_params} parameters), K={TRAIN_CLIENTS}, {TRAIN_BATCH} x "
          f"{M3_TRAIN_SEQ} tokens a step, adamw, remat, {TRAIN_AGG}: losses "
          f"{run.losses}; step walls (synchronized) {run.step_s} s; after "
          f"the first step {tokens * len(timed) / sum(timed):.1f} tokens/s "
          f"({len(timed)} steps: {[round(tokens / t, 1) for t in timed]}); "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    step = make_train_step(cfg, adamw(linear_warmup_cosine(
        TRAIN_LR, 10, TRAIN_STEPS)), num_clients=TRAIN_CLIENTS,
        agg_mode=TRAIN_AGG)
    b = make_token_stream(cfg.vocab_size, seed=1).batch(TRAIN_BATCH,
                                                        M3_TRAIN_SEQ)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in b.items()}
    gen = torch.Generator().manual_seed(SEED_MIX)
    out = []
    device_profile("phase 12 (c) train step", lambda: out.append(
        step(run.params, run.opt_state, batch, gen)))
    check(bool(torch.isfinite(out[0][2])),
          "phase 12 (c): the traced step's loss is not finite")


def phase12(fa, attn) -> None:
    """Phase 12 (a)-(d), one model on the card at a time."""
    t0 = time.perf_counter()
    for arch in M3_ARCHS:
        params, _ = phase12_serve(fa, arch)
        if arch == "starcoder2-15b":
            phase12_long(fa, attn, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    phase12_train()
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ("xlstm-125m", "recurrentgemma-9b"):
        phase11_card_vs_cpu(arch, label="phase 12 (d)")
    print(f"phase 12: {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 13: cross-attention, encoders and stub frontends
# ---------------------------------------------------------------------------

def open_gates(params: dict) -> int:
    """Set every xattn layer's gate_attn and gate_mlp to M5_GATE;
    returns the number of gates set."""
    n = 0
    for layer in params["decoder"]:
        for key in ("gate_attn", "gate_mlp"):
            if key in layer:
                layer[key].fill_(M5_GATE)
                n += 1
    return n


def m5_inputs(cfg, batch: int, prompt_len: int, mem_len: int, device,
              seed_memory: int = SEED_M5_MEMORY):
    """(prompt ids, memory embeddings (batch, mem_len, d) in cfg.dtype),
    drawn from seeds on `device`."""
    prompt = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED_M5_PROMPT))
    memory = torch.randn(
        (batch, mem_len, cfg.d_model), device=device,
        generator=torch.Generator(device=device).manual_seed(seed_memory)
    ).to(cfg.dtype)
    return prompt, memory


def phase13_serve(fa, arch: str, card: str) -> dict:
    """(a)/(b) M5_BATCH prompts with their memory through
    `make_prefill_step` (cache prompt + M5_DECODE; a warm prefill, then
    the timed one) and M5_DECODE greedy steps through `make_serve_step`
    (the first one warm, the last one profiled): finite logits and
    caches, flash launched once
    per self-attention layer per forward and never for cross-attention,
    the last step's cached logits == a fresh `forward_hidden` over the
    prompt and the fed tokens with the same memory (the encoder re-run)
    within DECODE_TOL_BF16, and the prefill's logits moved by other
    memory embeddings; then profiles one more prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.packets import tree_flatten
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tf

    label = "phase 13 (a)" if arch == M5_VISION else "phase 13 (b)"
    cfg = get_config(arch)
    if arch == M5_VISION:
        cfg = cfg.with_overrides(num_layers=M5_VISION_LAYERS)
    kinds = tf.layer_kinds(cfg)
    prompt_len, mem_len = ((M5_VISION_PROMPT, cfg.num_frontend_tokens)
                           if arch == M5_VISION
                           else (M5_SEAMLESS_PROMPT, M5_SEAMLESS_FRAMES))
    t0 = time.perf_counter()
    params = tf.init_lm(torch.Generator(device="cuda").manual_seed(SEED_M5),
                        cfg, device="cuda")
    gates = open_gates(params)
    prompt, memory = m5_inputs(cfg, M5_BATCH, prompt_len, mem_len, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    # the flash kernel runs every self-attention layer of one forward:
    # the decoder's dense and dec layers and the encoder's layers
    flash = sum(k in ("dense", "dec") for k in kinds) + cfg.encoder_layers
    cache_len = prompt_len + M5_DECODE
    prefill_step = make_prefill_step(cfg, cache_len=cache_len)
    serve_step = make_serve_step(cfg)
    batch = {"tokens": prompt, "memory": memory}

    def counted(what, run):
        return flash_counted(fa, f"{arch} {what}", flash, run, phase=label)

    warm, cache = counted("warm prefill", lambda: prefill_step(params, batch))
    del cache
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    resident = tree_bytes(params) + tree_bytes(batch)
    t0 = time.perf_counter()
    logits, cache = counted("prefill", lambda: prefill_step(params, batch))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()),
          f"{label}: {arch} non-finite prefill logits")
    same = float((warm.float() - logits.float()).abs().max())
    first = logits.float()
    tokens, logps, kept = [greedy(logits, cfg)], [], []
    del logits, warm
    decode_step = tf.decode_step

    def keeping(*args, **kw):       # the serve step's logits, kept
        out = decode_step(*args, **kw)
        kept[:] = [out[0]]
        return out

    tf.decode_step = keeping
    try:
        tok, lp, cache = serve_step(params, cache, tokens[-1])   # warm
        tokens.append(tok)
        logps.append(lp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(M5_DECODE - 2):
            tok, lp, cache = serve_step(params, cache, tok)
            tokens.append(tok)
            logps.append(lp)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / (M5_DECODE - 2) * 1e3
        traced = []                 # the last step, under the profiler
        device_profile(f"{label} {arch} serve step", lambda: traced.append(
            serve_step(params, cache, tok)))
        tok, lp, cache = traced.pop()
        tokens.append(tok)
        logps.append(lp)
    finally:
        tf.decode_step = decode_step
    peak = torch.cuda.max_memory_allocated()
    logps = torch.cat(logps, dim=1)
    check(bool(torch.isfinite(logps).all()) and finite_state(cache),
          f"{label}: {arch} non-finite log-probs or decode cache")
    selfs = [c.get("self", c) for c, k in zip(cache, kinds)
             if k in ("dense", "dec")]
    crosses = [c.get("cross", c) for c, k in zip(cache, kinds)
               if k in ("xattn", "dec")]
    check(len(selfs) == flash - cfg.encoder_layers and
          all(c["pos"] == cache_len for c in selfs),
          f"{label}: {arch} self-attention caches do not hold prompt + "
          f"decoded tokens")
    check(len(crosses) == sum(k in ("xattn", "dec") for k in kinds) > 0 and
          all(c["k"].shape[1] == mem_len for c in crosses),
          f"{label}: {arch} cross caches do not hold the memory's "
          f"{mem_len} positions")
    del cache
    dec = kept.pop().float()
    # the last step fed tokens[-2]: the fresh forward runs over the prompt
    # and every token fed, prompt + M5_DECODE in all, with the same memory
    seq = torch.cat([prompt] + [t.long() for t in tokens[:-1]], dim=1)
    h, _ = counted("fresh forward_hidden", lambda: tf.forward_hidden(
        params, seq, cfg, memory=tf._memory_states(params, batch, cfg)))
    fresh = tf._lm_logits(params, h[:, -1:], cfg).float()
    del h
    tol16 = {"rtol": 0.0, "atol": DECODE_TOL_BF16}
    scale = float(fresh.abs().max())
    err, clear = held_to_fresh(dec, fresh, cfg, tol16, arch, phase=label)
    del dec, fresh
    # other memory embeddings: the prefill's logits must move by more
    # than the same prefill's own repeat does (4x, and at least 1e-3)
    _, other = m5_inputs(cfg, M5_BATCH, prompt_len, mem_len, "cuda",
                         seed_memory=SEED_M5_MEMORY + 1)
    moved_logits, cache = counted("prefill with other memory", lambda:
                                  prefill_step(params, {"tokens": prompt,
                                                        "memory": other}))
    del cache, other
    moved = float((moved_logits.float() - first).abs().max())
    del moved_logits
    check(moved > max(4 * same, 1e-3),
          f"{label}: {arch} other memory moved the prefill logits by only "
          f"{moved} (the same memory twice: {same})")
    kinds = Counter(kinds)
    tokens_s = M5_BATCH * prompt_len / prefill_s
    print(f"{label}: {arch} {cfg.num_layers} decoder layers ("
          f"{', '.join(f'{n} {k}' for k, n in kinds.items())}) + "
          f"{cfg.encoder_layers} encoder layers, d={cfg.d_model} heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.resolved_head_dim} "
          f"d_ff {cfg.d_ff} vocab {cfg.vocab_size} bf16 ({n_params} "
          f"parameters, drawn in {init_s:.3f} s; {gates} gates set to "
          f"{M5_GATE}), B={M5_BATCH} prompt {prompt_len} ids, memory "
          f"{mem_len} x {cfg.d_model} embeddings a request, cache "
          f"{cache_len}: prefill {prefill_s:.6f} s (synchronized, after a "
          f"warm one), {tokens_s:.1f} prompt tokens/s"
          + (f", {M5_BATCH * mem_len / prefill_s:.1f} frames/s"
             if cfg.encoder_layers else "")
          + f"; {M5_DECODE} greedy serve steps, {M5_DECODE - 2} timed after "
          f"a warm one (the last one traced): {decode_ms:.3f} ms/step, "
          f"{M5_BATCH * 1e3 / decode_ms:.1f} tokens/s; max_memory_allocated "
          f"{peak} bytes ({peak / 2**30:.2f} GiB); flash launches a forward "
          f"{flash} (never for cross-attention); mean log-prob "
          f"{float(logps.mean()):.4f}; on {card}")
    print(f"{label}: {arch} last decode step vs fresh forward_hidden over "
          f"{seq.shape[1]} tokens with the same memory, logits up to "
          f"{scale}: max |err| {err} (tolerance {tol16}), greedy tokens "
          f"compared in {clear} of {M5_BATCH} requests (clear margin); "
          f"other memory moved the prefill logits by {moved} (the same "
          f"memory twice: {same})")
    per_name = counted("traced prefill", lambda: device_profile(
        f"{label} {arch} prefill", lambda: prefill_step(params, batch)))
    flash_us = sum(us for name, us in per_name.items()
                   if "flash_attention" in name)
    print(f"{label}: {arch} flash in the traced prefill: {flash_us:.1f} us "
          f"in {flash} launches, {flash_us / flash / 1e3:.6f} ms a launch "
          f"(profiler)")
    del params, batch, prompt, memory
    return {"prefill_s": prefill_s, "decode_ms": decode_ms, "peak": peak,
            "base": base, "resident": resident, "err": err,
            "flash_ms": flash_us / flash / 1e3}


def phase13_card_vs_cpu() -> None:
    """(c) the reduced Llama-3.2-Vision-90B and SeamlessM4T-medium in
    float32 on the same weights (gates M5_GATE) and inputs: prefill with
    memory and M5_F32_DECODE greedy steps on the card (the flash kernel)
    and on the CPU (its plain version); every step's logits within
    DECODE_TOL."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.packets import tree_map
    from repro_torch.models import transformer as tf

    for arch in (M5_VISION, M5_SEAMLESS):
        cfg = reduced_config(arch).with_overrides(dtype=torch.float32)
        params = tf.init_lm(torch.Generator().manual_seed(SEED_M5), cfg,
                            device="cpu")
        open_gates(params)
        prompt, memory = m5_inputs(cfg, M5_BATCH, 2 * cfg.num_frontend_tokens,
                                   cfg.num_frontend_tokens, "cpu")
        outs, fed = {}, []
        for dev in ("cpu", "cuda"):     # both fed the CPU's greedy tokens
            p = tree_map(lambda t, dev=dev: t.to(dev), params)
            logits, cache = tf.prefill(
                p, prompt.to(dev), cfg, memory=memory.to(dev),
                cache_len=prompt.shape[1] + M5_F32_DECODE)
            steps = [logits.cpu()]
            for i in range(M5_F32_DECODE):
                if dev == "cpu":
                    fed.append(greedy(steps[-1], cfg))
                logits, cache = tf.decode_step(p, fed[i].to(dev), cache, cfg)
                steps.append(logits.cpu())
            outs[dev] = steps
            del p, cache
        errs = []
        for i, (a, b_) in enumerate(zip(outs["cuda"], outs["cpu"],
                                        strict=True)):
            errs.append(float((a - b_).abs().max()))
            check(torch.allclose(a, b_, **DECODE_TOL),
                  f"phase 13 (c): reduced {arch} float32 step {i} logits on "
                  f"the card differ from the CPU's (max |err| {errs[-1]}, "
                  f"tolerance {DECODE_TOL})")
        print(f"phase 13 (c): reduced {arch} float32 (gates {M5_GATE}), "
              f"B={M5_BATCH} prompt {prompt.shape[1]} memory "
              f"{memory.shape[1]}: prefill + {M5_F32_DECODE} decode steps on "
              f"the card == the CPU's within {DECODE_TOL}, max |err| per "
              f"step {errs}")


def phase13(fa) -> dict:
    """Phase 13 (a)-(c), one model on the card at a time."""
    t0 = time.perf_counter()
    card = card_line()
    out = {}
    for arch in (M5_VISION, M5_SEAMLESS):
        out[arch] = phase13_serve(fa, arch, card)
        gc.collect()
        torch.cuda.empty_cache()
    phase13_card_vs_cpu()
    print(f"phase 13: {time.perf_counter() - t0:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: MoE and MLA
# ---------------------------------------------------------------------------

def m4_flash(cfg) -> int:
    """Flash launches of one forward: one per self-attention layer that
    takes the kernel (GQA at a head dim it has); MLA never does."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.models import transformer as tf

    if cfg.mla is not None or cfg.resolved_head_dim not in HEAD_DIMS:
        return 0
    return len(tf.layer_kinds(cfg))


def no_drop(cfg):
    """`cfg` with capacity_factor = E / top_k: every expert has C = T
    slots in every group, so no (token, choice) pair is dropped."""
    import dataclasses

    mc = cfg.moe
    return cfg.with_overrides(moe=dataclasses.replace(
        mc, capacity_factor=mc.num_experts / mc.top_k))


def routed(run):
    """`run()` with the MoE routing recorded: (its result, the top-k
    experts of every routed group, in call order)."""
    from repro_torch.models import moe

    seen, route = [], moe._route

    def spy(p, xt, cfg):
        out = route(p, xt, cfg)
        seen.append(out[2])
        return out

    moe._route = spy
    try:
        return run(), seen
    finally:
        moe._route = route


def m4_cached_vs_fresh(fa, cfg, params, prompt, label: str):
    """Prefill `prompt`, M4_R9_DECODE greedy decode steps, and a fresh
    `forward_hidden` over the prompt and the fed tokens: (the last step's
    cached logits, the fresh ones, both float32; (B,) bool: requests
    whose last token took another set of experts in some MoE layer in
    the last step than in the fresh forward)."""
    from repro_torch.models import transformer as tf

    flash = m4_flash(cfg)
    logits, cache = flash_counted(fa, f"{label} prefill", flash, lambda:
                                  tf.prefill(params, prompt, cfg, cache_len=(
                                      prompt.shape[1] + M4_R9_DECODE)),
                                  phase="phase 14")
    fed = []
    for _ in range(M4_R9_DECODE):
        fed.append(greedy(logits, cfg))
        (logits, cache), dec_route = routed(
            lambda: tf.decode_step(params, fed[-1], cache, cfg))
    del cache
    seq = torch.cat([prompt] + fed, dim=1)
    B, S = seq.shape
    (h, _), fresh_route = routed(lambda: flash_counted(
        fa, f"{label} fresh forward_hidden", flash,
        lambda: tf.forward_hidden(params, seq, cfg), phase="phase 14"))
    fresh = tf._lm_logits(params, h[:, -1:], cfg).float()
    del h
    dec = logits.float()
    check(bool(torch.isfinite(dec).all()) and
          bool(torch.isfinite(fresh).all()),
          f"phase 14: {label} non-finite logits")
    # one group a layer in both (B·S <= TARGET_GROUP), batch-major
    check(len(dec_route) == len(fresh_route) ==
          sum(k.startswith("moe") for k in tf.layer_kinds(cfg)),
          f"phase 14: {label} not one routing group per MoE layer")
    flipped = torch.zeros(B, dtype=torch.bool, device=dec.device)
    for d_idx, f_idx in zip(dec_route, fresh_route, strict=True):
        last = f_idx.reshape(B, S, -1)[:, -1]
        flipped |= (d_idx.sort(-1).values != last.sort(-1).values).any(-1)
    return dec, fresh, flipped


def phase14_serve(fa, arch: str, card: str) -> dict:
    """(a)/(b) M4_BATCH prompts of M4_PROMPT ids through
    `make_prefill_step` (cache prompt + M4_DECODE; a warm prefill, then
    the timed one) and M4_DECODE greedy steps through `make_serve_step`
    (the first one warm, the last one profiled): finite logits and
    caches, flash launched once per layer per forward for Arctic and
    never for DeepSeek-V2 (MLA); cached vs fresh at capacity_factor =
    E / top_k within DECODE_TOL_BF16 (R9: at the published factor
    printed, not held); then profiles one more prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.packets import tree_flatten, tree_map
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tf

    label = "phase 14 (a)" if arch == M4_ARCTIC else "phase 14 (b)"
    cfg = get_config(arch).with_overrides(num_layers=M4_LAYERS[arch])
    kinds = tf.layer_kinds(cfg)
    t0 = time.perf_counter()
    params = tf.init_lm(torch.Generator(device="cuda").manual_seed(SEED_M4),
                        cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED_M4_PROMPT)
    prompt = torch.randint(0, cfg.vocab_size, (M4_BATCH, M4_PROMPT),
                           device="cuda", generator=gen)
    r9_prompt = torch.randint(0, cfg.vocab_size, (M4_BATCH, M4_R9_PROMPT),
                              device="cuda", generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_flatten(params)[0]
    n_params = sum(t.numel() for t in leaves)
    routers = [layer["moe"]["router"]["w"] for layer in params["decoder"]
               if "moe" in layer]
    check(len(routers) == sum(k.startswith("moe") for k in kinds) and
          all(w.dtype == torch.float32 for w in routers),
          f"{label}: {arch} routers are not float32")
    flash = m4_flash(cfg)
    cache_len = M4_PROMPT + M4_DECODE
    prefill_step = make_prefill_step(cfg, cache_len=cache_len)
    serve_step = make_serve_step(cfg)
    batch = {"tokens": prompt}

    def counted(what, run):
        return flash_counted(fa, f"{arch} {what}", flash, run, phase=label)

    _, cache = counted("warm prefill", lambda: prefill_step(params, batch))
    del cache
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    resident = tree_bytes(params) + tree_bytes(batch)
    t0 = time.perf_counter()
    logits, cache = counted("prefill", lambda: prefill_step(params, batch))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()),
          f"{label}: {arch} non-finite prefill logits")
    tok = greedy(logits, cfg)
    del logits
    logps = []
    tok, lp, cache = serve_step(params, cache, tok)             # warm
    logps.append(lp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(M4_DECODE - 2):
        tok, lp, cache = serve_step(params, cache, tok)
        logps.append(lp)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / (M4_DECODE - 2) * 1e3
    traced = []                     # the last step, under the profiler
    device_profile(f"{label} {arch} serve step", lambda: traced.append(
        serve_step(params, cache, tok)))
    tok, lp, cache = traced.pop()
    logps.append(lp)
    peak = torch.cuda.max_memory_allocated()
    logps = torch.cat(logps, dim=1)
    check(bool(torch.isfinite(logps).all()) and finite_state(cache),
          f"{label}: {arch} non-finite log-probs or decode cache")
    check(len(cache) == cfg.num_layers and
          all(c["pos"] == cache_len for c in cache),
          f"{label}: {arch} caches do not hold prompt + decoded tokens")
    if cfg.mla is not None:
        check(all(sorted(c) == ["ckv", "krope", "pos"] and
                  c["ckv"].shape == (M4_BATCH, cache_len,
                                     cfg.mla.kv_lora_rank) for c in cache),
              f"{label}: {arch} MLA caches are not the latent cache")
    del cache

    tokens_s = M4_BATCH * M4_PROMPT / prefill_s
    mc = cfg.moe
    print(f"{label}: {arch} {cfg.num_layers} of "
          f"{get_config(arch).num_layers} layers ("
          f"{', '.join(f'{n} {k}' for k, n in Counter(kinds).items())}), "
          f"d={cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} "
          + (f"MLA r {cfg.mla.kv_lora_rank} q {cfg.mla.q_lora_rank} nope "
             f"{cfg.mla.nope_head_dim} rope {cfg.mla.rope_head_dim} v "
             f"{cfg.mla.v_head_dim}" if cfg.mla is not None
             else f"hd={cfg.resolved_head_dim}")
          + f", {mc.num_experts} experts top-{mc.top_k} d_ff "
          f"{mc.d_ff_expert} (shared {mc.num_shared_experts}, dense "
          f"residual {mc.dense_residual}), vocab {cfg.vocab_size} bf16 "
          f"({n_params} parameters, drawn in {init_s:.3f} s; routers "
          f"float32), B={M4_BATCH} prompt {M4_PROMPT} ids, cache "
          f"{cache_len}: prefill {prefill_s:.6f} s (synchronized, after a "
          f"warm one), {tokens_s:.1f} prompt tokens/s; {M4_DECODE} greedy "
          f"serve steps, {M4_DECODE - 2} timed after a warm one (the last "
          f"one traced): {decode_ms:.3f} ms/step, "
          f"{M4_BATCH * 1e3 / decode_ms:.1f} tokens/s; max_memory_allocated "
          f"{peak} bytes ({peak / 2**30:.2f} GiB); flash launches a forward "
          f"{flash}; mean log-prob {float(logps.mean()):.4f}; on {card}",
          flush=True)

    # cached vs fresh where nothing can drop (held), and at the published
    # capacity factor (R9: printed, not held).  In bf16 the last token's
    # router input differs by rounding between a one-token decode step and
    # a forward over the grown sequence, and a near tie between the k-th
    # and (k+1)-th expert can then go either way: a request whose last
    # token took another set of experts in any layer changes by a whole
    # expert's output (R9), so the bf16 hold covers the others, and with
    # MLA the same check runs in float32 on the model's first
    # M4_F32_LAYERS layers, every request held
    tol16 = {"rtol": 0.0, "atol": DECODE_TOL_BF16}
    dec, fresh, flipped = m4_cached_vs_fresh(fa, no_drop(cfg), params,
                                             r9_prompt, f"{arch} C = T")
    scale = float(fresh.abs().max())
    err_all = float((dec - fresh).abs().max())
    check(not bool(flipped.all()),
          f"{label}: {arch} C = T: every request's routing differs between "
          f"the cached step and the fresh forward; nothing left to hold")
    err, clear = held_to_fresh(dec[~flipped], fresh[~flipped], cfg, tol16,
                               f"{arch} C = T", phase=label)
    held = (f"at capacity_factor = E / top_k = "
            f"{mc.num_experts / mc.top_k} (C = T) {int(flipped.sum())} of "
            f"{M4_BATCH} requests took another expert set in some layer "
            f"(max |err| over all {err_all}); the others max |err| {err} on "
            f"logits up to {scale} (tolerance {tol16}), greedy tokens "
            f"compared in {clear} (clear margin)")
    del dec, fresh
    if cfg.mla is not None:
        cfg32 = no_drop(cfg).with_overrides(num_layers=M4_F32_LAYERS,
                                            dtype=torch.float32)
        params32 = {k: (v[:M4_F32_LAYERS] if k == "decoder" else v)
                    for k, v in params.items()}
        params32 = tree_map(lambda t: t.float(), params32)
        dec, fresh, flip32 = m4_cached_vs_fresh(
            fa, cfg32, params32, r9_prompt, f"{arch} C = T float32")
        del params32
        err32, clear32 = held_to_fresh(dec, fresh, cfg, DECODE_TOL,
                                       f"{arch} C = T float32", phase=label)
        held += (f"; float32 on the first {M4_F32_LAYERS} layers (same "
                 f"weights): max |err| {err32} (tolerance {DECODE_TOL}), "
                 f"{int(flip32.sum())} requests with another expert set, "
                 f"greedy tokens compared in {clear32}")
        del dec, fresh
    gc.collect()
    torch.cuda.empty_cache()
    dec, fresh, flipped = m4_cached_vs_fresh(fa, cfg, params, r9_prompt,
                                             f"{arch} published factor")
    r9 = float((dec - fresh).abs().max())
    del dec, fresh
    print(f"{label}: {arch} last of {M4_R9_DECODE} decode steps after "
          f"{M4_BATCH} x {M4_R9_PROMPT} ids vs fresh forward_hidden: {held}; "
          f"R9: not gated: at the published {mc.capacity_factor} max |err| "
          f"{r9} ({int(flipped.sum())} requests with another expert set)",
          flush=True)
    per_name = counted("traced prefill", lambda: device_profile(
        f"{label} {arch} prefill", lambda: prefill_step(params, batch)))
    flash_us = sum(us for name, us in per_name.items()
                   if "flash_attention" in name)
    if flash:
        print(f"{label}: {arch} flash in the traced prefill: {flash_us:.1f} "
              f"us in {flash} launches, {flash_us / flash / 1e3:.6f} ms a "
              f"launch (profiler)")
    del params, batch, prompt, leaves, routers
    return {"prefill_s": prefill_s, "decode_ms": decode_ms, "peak": peak,
            "base": base, "resident": resident, "err": err, "r9": r9,
            "flash_ms": flash_us / flash / 1e3 if flash else None}


def phase14_card_vs_cpu() -> None:
    """(c) the reduced Arctic-480B and DeepSeek-V2-236B (absorbed False
    and True) in float32 on the same weights and inputs, on the card
    (the flash kernel where the reduced Arctic's attention takes it) and
    on the CPU (its plain version): prefill and M4_F32_DECODE greedy
    steps, logits within DECODE_TOL; `lm_loss` (remat) aux within
    M4_AUX_TOL, xent within DECODE_TOL and every gradient leaf, the
    routers' included, within GRAD_TOL."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.packets import (tree_flatten, tree_map,
                                          tree_unflatten)
    from repro_torch.data.tokens import make_token_stream
    from repro_torch.models import transformer as tf

    cases = [(M4_ARCTIC, None), (M4_DEEPSEEK, False), (M4_DEEPSEEK, True)]
    for arch, absorbed in cases:
        cfg = reduced_config(arch).with_overrides(dtype=torch.float32)
        if absorbed is not None:
            cfg = cfg.with_overrides(mla=dataclasses.replace(
                cfg.mla, absorbed=absorbed))
        what = arch + ("" if absorbed is None else f" absorbed={absorbed}")
        params = tf.init_lm(torch.Generator().manual_seed(SEED_M4), cfg,
                            device="cpu")
        prompt = torch.randint(0, cfg.vocab_size, (M4_BATCH, 64),
                               generator=torch.Generator().manual_seed(
                                   SEED_M4_PROMPT))
        b = make_token_stream(cfg.vocab_size, seed=0).batch(REDUCED_BATCH,
                                                            REDUCED_SEQ)
        outs, fed = {}, []
        for dev in ("cpu", "cuda"):     # both fed the CPU's greedy tokens
            p = tree_map(lambda t, dev=dev: t.to(dev), params)
            logits, cache = tf.prefill(p, prompt.to(dev), cfg,
                                       cache_len=64 + M4_F32_DECODE)
            steps = [logits.cpu()]
            for i in range(M4_F32_DECODE):
                if dev == "cpu":
                    fed.append(greedy(steps[-1], cfg))
                logits, cache = tf.decode_step(p, fed[i].to(dev), cache, cfg)
                steps.append(logits.cpu())
            del cache
            leaves, treedef = tree_flatten(p)
            live = [t.detach().requires_grad_() for t in leaves]
            batch = {k: torch.from_numpy(v).long().to(dev)
                     for k, v in b.items()}
            loss, parts = tf.lm_loss(tree_unflatten(treedef, live), batch,
                                     cfg)
            grads = torch.autograd.grad(loss, live)
            outs[dev] = (steps, float(parts["xent"].detach()),
                         float(parts["aux"].detach()),
                         [g.cpu() for g in grads])
            del p, live, grads
        errs = [float((a - b_).abs().max()) for a, b_ in
                zip(outs["cuda"][0], outs["cpu"][0], strict=True)]
        for i, (a, b_) in enumerate(zip(outs["cuda"][0], outs["cpu"][0],
                                        strict=True)):
            check(torch.allclose(a, b_, **DECODE_TOL),
                  f"phase 14 (c): reduced {what} float32 step {i} logits on "
                  f"the card differ from the CPU's (max |err| {errs[i]}, "
                  f"tolerance {DECODE_TOL})")
        (_, xent_c, aux_c, g_c), (_, xent_h, aux_h, g_h) = (outs["cuda"],
                                                           outs["cpu"])
        check(aux_h > 0 and abs(aux_c - aux_h) <= M4_AUX_TOL,
              f"phase 14 (c): reduced {what} aux {aux_c} on the card, "
              f"{aux_h} on the CPU (tolerance {M4_AUX_TOL})")
        check(abs(xent_c - xent_h) <= DECODE_TOL["atol"] + DECODE_TOL[
            "rtol"] * abs(xent_h), f"phase 14 (c): reduced {what} xent "
              f"{xent_c} on the card, {xent_h} on the CPU")
        worst = 0.0
        for j, (a, b_) in enumerate(zip(g_c, g_h, strict=True)):
            bound = (GRAD_TOL["rtol"] * b_.abs()
                     + GRAD_TOL["scale"] * b_.abs().max())
            diff = (a - b_).abs()
            check(bool((diff <= bound).all()),
                  f"phase 14 (c): reduced {what} gradient leaf {j} differs "
                  f"from the CPU's (max |err| {float(diff.max())}, "
                  f"{GRAD_TOL})")
            worst = max(worst, float(diff.max() / b_.abs().max().clamp(
                min=1e-30)))
        print(f"phase 14 (c): reduced {what} float32, B={M4_BATCH} prompt "
              f"64: prefill + {M4_F32_DECODE} decode steps on the card == "
              f"the CPU's within {DECODE_TOL}, max |err| per step {errs}; "
              f"lm_loss over {REDUCED_BATCH} x {REDUCED_SEQ} tokens: xent "
              f"{xent_c} / {xent_h}, aux {aux_c} / {aux_h} (|err| "
              f"{abs(aux_c - aux_h)}, tolerance {M4_AUX_TOL}), every "
              f"gradient leaf (routers included) within {GRAD_TOL} "
              f"(largest |err| / leaf scale {worst:.3e})")


def phase14(fa) -> dict:
    """Phase 14 (a)-(c), one model on the card at a time."""
    t0 = time.perf_counter()
    card = card_line()
    out = {}
    for arch in (M4_ARCTIC, M4_DEEPSEEK):
        out[arch] = phase14_serve(fa, arch, card)
        gc.collect()
        torch.cuda.empty_cache()
    phase14_card_vs_cpu()
    print(f"phase 14: {time.perf_counter() - t0:.3f} s")
    return out

# ---------------------------------------------------------------------------
# phase 15: the launch tier's plans against the card
# ---------------------------------------------------------------------------

def phase15_pairs() -> int:
    """(a) `run_pair` at full width and depth for every config at both
    decode shapes and for Qwen3-4B's prefill_32k: one line per pair
    (bound, bottleneck, planned peak, fits).  Returns the count."""
    from repro_torch.configs import ARCHITECTURES
    from repro_torch.launch import dryrun

    pairs = [(a, s) for s in ("decode_32k", "long_500k")
             for a in ARCHITECTURES] + [("qwen3_4b", "prefill_32k")]
    t0 = time.perf_counter()
    for arch, shape in pairs:
        rec = dryrun.run_pair(arch, shape)
        check(rec["status"] == "ok", f"phase 15 (a): {arch} x {shape} "
              f"was not planned: {rec}")
        print(f"phase 15 (a): {arch} x {shape}: {dryrun.summary(rec)} "
              f"(traced in {rec['trace_s']} s)", flush=True)
    print(f"phase 15 (a): {len(pairs)} pairs planned in "
          f"{time.perf_counter() - t0:.3f} s (all 40: python -m "
          f"repro_torch.launch.dryrun --all)")
    return len(pairs)


def phase15_held(label: str, measured: dict, steps: list, card: str,
                 hold_peak: bool = True) -> None:
    """(b) the plans of one phase's steps against the peak it measured,
    both counted with the same resident tensors: the measured peak above
    what was resident at its reset, plus the plan's own arguments that
    were resident then; the plan's peak is its steps' largest, each with
    the bytes the phase kept beside the step's arguments.  (c) each
    step's bound against every wall the phase measured for it.  `steps`:
    (name, plan, extra resident bytes, walls in s)."""
    from repro_torch.launch.dryrun import bound_s

    want = measured["peak"] - measured["base"] + measured["resident"]
    plan = max(p["memory_plan"]["peak_bytes"] + extra
               for _, p, extra, _ in steps)
    rel = plan / want - 1.0
    if hold_peak:
        check(abs(rel) <= PLAN_TOL,
              f"phase 15 (b): {label}: planned peak {plan} bytes, measured "
              f"{want} ({rel:+.2%}, limit {PLAN_TOL:.0%})")
    print(f"phase 15 (b): {label}: planned peak {plan} bytes "
          f"({plan / 2**30:.2f} GiB), measured {want} ({want / 2**30:.2f} "
          f"GiB: max_memory_allocated {measured['peak']} - resident at "
          f"reset {measured['base']} + the plan's arguments "
          f"{measured['resident']}), {rel:+.2%}"
          + ("" if hold_peak else " (printed, not held)") + f"; on {card}")
    for name, p, _, walls in steps:
        b = bound_s(p)
        r = p["roofline"]
        for w in walls:
            check(b <= BOUND_SLACK * w,
                  f"phase 15 (c): {label} {name}: bound {b} s above "
                  f"{BOUND_SLACK} x the measured wall {w} s")
        print(f"phase 15 (c): {label} {name}: bound {b * 1e3:.3f} ms "
              f"({r['bottleneck']}; compute {r['compute_s'] * 1e3:.3f} ms, "
              f"memory {r['memory_s'] * 1e3:.3f} ms: "
              f"{p['trace_analysis']['flops_per_device']:.6e} FLOP, "
              f"{p['trace_analysis']['floor_bytes_per_device']:.6e} floor "
              f"bytes; eager bytes "
              f"{p['trace_analysis']['eager_bytes_per_device']:.6e}, "
              f"{r['eager_memory_s'] * 1e3:.3f} ms) "
              f"against walls {[round(w * 1e3, 3) for w in walls]} ms: "
              f"{100 * b / min(walls):.1f}% of the shortest")


def serve_plans(cfg, batch: int, prompt: int, decode: int,
                mem_len: int = 0) -> list:
    """The plans of a serving phase's prefill (batch x prompt ids, cache
    prompt + decode) and of one serve step against that cache, the
    prompt (and memory) still resident beside it."""
    from repro_torch.launch import dryrun

    params = dryrun.init_params(cfg)
    kw = {"cache_len": prompt + decode, "mem_len": mem_len}
    pre = dryrun.plan_step(cfg, params, "prefill", batch, prompt, **kw)
    dec = dryrun.plan_step(cfg, params, "decode", batch, prompt, **kw)
    return [("prefill", pre, 0), ("decode step", dec,
                                  pre["memory_plan"]["input_bytes"])]


def phase15_flash_count(wrappers) -> None:
    """The counter sees one flash call on the card as on meta and the
    CPU: `flash_flops` at phase 7's shape (137.5 GFLOP, the bound of
    PERF.md §6), with the kernel launched once."""
    from repro_torch.kernels.flash_attention import flash_flops
    from repro_torch.launch.roofline import analyze_step

    flash = next(fn for fn in wrappers if fn.__name__ == "flash_attention")
    g = torch.Generator(device="cuda").manual_seed(SEED_F1)
    q, k, v = (torch.randn((QWEN_BATCH, QWEN_PROMPT, h, 128), device="cuda",
                           generator=g).to(torch.bfloat16)
               for h in (32, 8, 8))
    before = flash.launches
    ana, out = analyze_step(lambda: flash(q, k, v), "cuda")
    torch.cuda.synchronize()
    want = flash_flops(QWEN_BATCH, QWEN_PROMPT, 32, 128, True)
    check(ana.flops == want and flash.launches - before == 1 and
          bool(torch.isfinite(out).all()),
          f"phase 15: the counter saw {ana.flops} FLOP in "
          f"{flash.launches - before} flash launches, not {want} in one")
    print(f"phase 15: flash at (4, 2,048, 32/8, 128) bf16 on the card: "
          f"{ana.flops:.0f} FLOP counted (flash_flops {want}), "
          f"{ana.n_ops} op, 1 launch")


def phase15_dist(grads: dict) -> None:
    """(d) `core.dist.make_fednc_mean` at world size 1 on NCCL over a
    slice of phase 11's gradient tree, in each mode: equal to
    `aggregate_gradients` given the same A and to the plain mean (the
    client's own gradient, K = 1) within AGG_TOL."""
    import torch.distributed as dist

    from repro_torch.core import dist as cdist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import aggregate_gradients

    mesh = mesh_mod.make_production_mesh()
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"phase 15 (d): a {dist.get_backend()} group of "
              f"{dist.get_world_size()}, not NCCL at world size 1")
        tree = {k: v.cuda() for k, v in grads.items()}
        n = sum(t.numel() * t.element_size() for t in tree.values())
        A = cdist.mix_matrix(torch.Generator().manual_seed(SEED_MIX), 1)
        for mode, agg in (("naive", "fednc_naive"),
                          ("blocked", "fednc_blocked"), ("psum", "plain")):
            f = cdist.make_fednc_mean(mesh, axis="data", mode=mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = f(tree, A=A)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want = aggregate_gradients(tree, None, 1, agg, A=A)
            errs = []
            for k, x in tree.items():
                g = got[k][0].float()
                for ref_, what in ((want[k].float(), "aggregate_gradients"),
                                   (x[0].float(), "the plain mean")):
                    check(bool(torch.allclose(g, ref_, **AGG_TOL)),
                          f"phase 15 (d): {mode} coded mean differs from "
                          f"{what} on {k} (max |err| {leaf_err(g, ref_)}, "
                          f"tolerance {AGG_TOL})")
                errs.append(max(leaf_err(g, want[k].float()),
                                leaf_err(g, x[0].float())))
            del got, want
            print(f"phase 15 (d): {mode} on NCCL, world size 1, "
                  f"{len(tree)} leaves of phase 11's gradients ({n} bytes): "
                  f"== aggregate_gradients({agg!r}, same A) and the plain "
                  f"mean within {AGG_TOL}, max |err| {max(errs)}; "
                  f"{ms:.3f} ms (synchronized)")
    finally:
        mesh_mod.destroy_production_mesh()


def phase15(wrappers, m7: dict, m11: dict, m13: dict, m14: dict) -> None:
    """Phase 15: (a) full-size plans, (b) the plans of phases 7, 11, 13
    and 14's steps against their measured peaks, (c) their bounds
    against the measured walls, (d) the coded mean on NCCL.  Planning
    traces on the meta device and must launch no kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    card = card_line()
    before = launch_counts(wrappers)
    phase15_pairs()

    cfg = get_config(QWEN)
    phase15_held(f"phase 7 {QWEN} {cfg.num_layers} layers", m7,
                 [(n, p, x, [m7["prefill_s"] if n == "prefill"
                             else m7["decode_ms"] / 1e3])
                  for n, p, x in serve_plans(cfg, QWEN_BATCH, QWEN_PROMPT,
                                             QWEN_DECODE)], card)
    cfg = cfg.with_overrides(num_layers=TRAIN_LAYERS)
    train = dryrun.plan_step(cfg, dryrun.init_params(cfg), "train",
                             TRAIN_BATCH, TRAIN_SEQ, clients=TRAIN_CLIENTS,
                             agg_mode=TRAIN_AGG, state_dtype=torch.float32)
    phase15_held(f"phase 11 {QWEN} {TRAIN_LAYERS} layers",
                 m11["train"], [("train step", train, 0,
                                 m11["train"]["step_s"])], card,
                 hold_peak=False)
    print("phase 15 (b): the training plan cannot see the checkpointed "
          "recompute's autograd bookkeeping nor the allocator's and "
          "cuBLAS's workspaces; it is printed, not held")
    for label, arch, layers, m, mem_len, batch, prompt, decode in (
            ("phase 13 (a)", M5_VISION, M5_VISION_LAYERS, m13, None,
             M5_BATCH, M5_VISION_PROMPT, M5_DECODE),
            ("phase 14 (a)", M4_ARCTIC, M4_LAYERS[M4_ARCTIC], m14, 0,
             M4_BATCH, M4_PROMPT, M4_DECODE),
            ("phase 14 (b)", M4_DEEPSEEK, M4_LAYERS[M4_DEEPSEEK], m14, 0,
             M4_BATCH, M4_PROMPT, M4_DECODE)):
        cfg = get_config(arch).with_overrides(num_layers=layers)
        measured = m[arch]
        plans = serve_plans(cfg, batch, prompt, decode,
                            cfg.num_frontend_tokens if mem_len is None
                            else mem_len)
        phase15_held(f"{label} {arch} {layers} layers", measured,
                     [(n, p, x, [measured["prefill_s"] if n == "prefill"
                                 else measured["decode_ms"] / 1e3])
                      for n, p, x in plans], card)
    check(launch_counts(wrappers) == before,
          f"phase 15: planning launched a kernel ({before} -> "
          f"{launch_counts(wrappers)})")
    phase15_flash_count(wrappers)
    phase15_dist(m11["grads"])
    print(f"phase 15: {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# where a round's time goes: one traced round per 500M configuration
# ---------------------------------------------------------------------------

def device_profile(label: str, run) -> dict[str, float]:
    """Profile `run()`: device busy time (the union of device activity),
    its share of the traced wall time, and the device time per kernel
    name; returns the device time (us) per full kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    check(len(spans) > 0, "the profiler recorded no device activity")
    busy, (lo, hi) = 0.0, spans[0][:2]
    per_name: dict[str, list[float]] = {}
    for s, e, name in spans:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
        per_name.setdefault(name, []).append(e - s)
    busy += hi - lo
    print(f"trace {label}: traced wall {wall_us:.1f} us, device busy "
          f"{busy:.1f} us ({100 * busy / wall_us:.2f}% of the wall, "
          f"idle {100 - 100 * busy / wall_us:.2f}%), "
          f"{len(spans)} device activities")
    ranked = sorted(per_name.items(), key=lambda x: -sum(x[1]))
    for name, d in ranked[:12]:
        print(f"trace {label}:   {sum(d):.1f} us in {len(d)} x "
              f"{name[:72]} (mean {sum(d) / len(d):.3f} us)")
    return {name: sum(d) for name, d in per_name.items()}


def trace_round(label: str, eng, P: torch.Tensor, seed: int,
                make_channel) -> None:
    """Profile one round (`device_profile`) and check its decode."""
    out = []
    device_profile(label, lambda: out.append(eng.round(
        P, torch.Generator().manual_seed(seed), channel=make_channel())))
    check(out[0].ok and torch.equal(out[0].packets, P),
          f"traced round {label}: P_hat != P")


def trace_rounds(P: torch.Tensor, P1: torch.Tensor) -> None:
    from repro_torch.core.channel import ErasureChannel
    from repro_torch.engine import CodingEngine, EngineConfig

    for kernel in ("auto", "auto_seeded"):
        eng = CodingEngine(EngineConfig(s=8, kernel=kernel, extra_tuples=2),
                           device="cuda")
        trace_round(kernel, eng, P, SEED_ROUND,
                    lambda: ErasureChannel(0.1, seed=SEED_ERASE3))
    for s, X in ((8, P), (1, P1)):
        trace_round(f"cuda s={s} 2-hop", mix_engine(s), X, SEED_MIX,
                    mix_channel)


# ---------------------------------------------------------------------------
# timing at the chunk shape
# ---------------------------------------------------------------------------

def bound_ms(n: int, K: int, L: int, s: int, kind: str
             ) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, int32 ops) for one launch of a
    kernel of `kind`: "ladder" (the GF(2^s) product, counted as the
    packed ladder's least work, whatever the formulation), "seeded"
    (the same plus Threefry) or "xor" (the GF(2) masked XOR on bytes:
    one AND and one XOR per row, packet row and 4-byte word)."""
    words = -(-L // 4)
    row_bytes = 8 * n if kind == "seeded" else n * K
    n_bytes = K * L + n * L + row_bytes
    if kind == "xor":
        ops = 2 * n * K * words
    else:
        ops = words * (XTIME_OPS * K * (s - 1) + SELECT_OPS * n * K * s)
    if kind == "seeded":
        ops += n * -(-K // 4) * THREEFRY_OPS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops > t_bytes
            else "bytes", n_bytes, ops)


def clmul_ops(n: int, K: int, L: int) -> int:
    """int32 operations of the unpacked kernel's own formulation, the
    once-per-output reduction not counted: per 4 symbols, row and packet
    row, 16 selects (one LOP3 each, the masks read from shared memory);
    per 4 symbols and packet row, the two masked rungs (3) and 14
    shifts."""
    words = -(-L // 4)
    return words * K * (n * 16 + 3 + 14)


def time_launches(fn, inputs, reps: int) -> float:
    """Mean device ms per call over `reps` calls cycling through `inputs`.

    The stream is held busy (`torch.cuda._sleep`) while the calls are
    queued, so the events time the card running them back to back, not
    the host's launch rate."""
    for x in inputs[:3]:
        fn(x)                                       # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_kernels(gk, gx, ref, P: torch.Tensor) -> dict:
    n, K, L = CHUNK
    s = 8
    g = torch.Generator(device="cuda").manual_seed(1)
    A = torch.randint(0, 256, (n, K), generator=g, device="cuda",
                      dtype=torch.uint8)
    seeds = torch.randint(0, 1 << 32, (n,), generator=g, device="cuda",
                          dtype=torch.int64)
    # distinct chunk views of the phase-3 payload, 2 MB each, 400 MB in
    # all: every launch reads its chunk from HBM, as in the round.  The
    # payload is raw bytes, which is what the XOR kernel combines.
    chunks = [P[:, c * L:(c + 1) * L] for c in range(200)]
    out = {}
    for name, kern, plain, rows, kind in (
            ("gf_matmul_packed", gk.gf_matmul_packed,
             ref.gf_matmul_packed_ref, A, "ladder"),
            ("gf_matmul_packed_seeded", gk.gf_matmul_packed_seeded,
             ref.gf_matmul_packed_seeded_ref, seeds, "seeded"),
            ("gf_matmul_unpacked", gk.gf_matmul_unpacked,
             ref.gf_matmul_clmul_ref, A, "ladder"),
            ("gf2_matmul", gx.gf2_matmul,
             lambda M, X, s: ref.gf2_matmul_ref(M, X), A, "xor")):
        ks = 1 if kind == "xor" else s

        def run_plain(X, plain=plain, rows=rows, ks=ks):
            return plain(rows, X, ks)

        def run_kernel(X, kern=kern, rows=rows, ks=ks):
            return kern(rows, X, s=ks)

        # in turns: plain, kernel, kernel, plain
        plain_a = time_launches(run_plain, chunks, 2)
        ms = time_launches(run_kernel, chunks, 400)
        ms_b = time_launches(run_kernel, chunks, 400)
        plain_b = time_launches(run_plain, chunks, 2)
        b_ms, b_by, n_bytes, ops = bound_ms(n, K, L, ks, kind)
        kernel_ms = min(ms, ms_b)
        plain_ms = min(plain_a, plain_b)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        own = (f"; the clmul formulation's own count {clmul_ops(n, K, L)} "
               f"int32 ops, {clmul_ops(n, K, L) / kernel_ms / 1e9:.3f} "
               f"T op/s" if name == "gf_matmul_unpacked" else "")
        print(f"timing {name} at (n,K,L)=({n},{K},{L}) s={ks}: kernel "
              f"{ms:.6f} / {ms_b:.6f} ms, plain {plain_a:.6f} / "
              f"{plain_b:.6f} ms, bound {b_ms:.6f} ms by {b_by} "
              f"({n_bytes} bytes, {ops} int32 ops), "
              f"{n_bytes / kernel_ms / 1e6:.3f} GB/s, "
              f"{ops / kernel_ms / 1e9:.3f} T int32 op/s, "
              f"{100 * b_ms / kernel_ms:.2f}% of the {b_by} bound"
              + (f", {100 * bytes_ms / kernel_ms:.2f}% of the bytes bound "
                 f"({bytes_ms:.6f} ms)" if b_by != "bytes" else "")
              + own)
    # the XOR kernel at phase 6's RowMix legs: encode (10, 8), then A_post
    # (8, 10) on the 10 delivered rows, here 10-row views of the payload
    P10 = P.view(-1)[:10 * len(chunks) * L].view(10, len(chunks) * L)
    for n_leg, K_leg, X in ((10, 8, P), (8, 10, P10)):
        rows = torch.randint(0, 256, (n_leg, K_leg), generator=g,
                             device="cuda", dtype=torch.uint8)
        views = [X[:, c * L:(c + 1) * L] for c in range(len(chunks))]
        ms, ms_b = (time_launches(lambda V, rows=rows: gx.gf2_matmul(rows, V),
                                  views, 400) for _ in range(2))
        b_ms, b_by, n_bytes, ops = bound_ms(n_leg, K_leg, L, 1, "xor")
        kernel_ms = min(ms, ms_b)
        print(f"timing gf2_matmul at phase 6's leg (n,K,L)=({n_leg},{K_leg},"
              f"{L}) s=1: kernel {ms:.6f} / {ms_b:.6f} ms, bound {b_ms:.6f} "
              f"ms by {b_by} ({n_bytes} bytes, {ops} int32 ops), "
              f"{n_bytes / kernel_ms / 1e6:.3f} GB/s, "
              f"{100 * b_ms / kernel_ms:.2f}% of the {b_by} bound")
    return out


def flash_bound_ms(B: int, S: int, H: int, KV: int, hd: int,
                   itemsize: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, FLOPs) of causal attention: the
    two products over the S(S+1)/2 live (query, key) pairs of each head
    at the bf16 tensor-core rate, or q, k, v read and o written once."""
    flops = 4 * hd * B * H * S * (S + 1) / 2
    n_bytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * itemsize
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes
            else "bytes", n_bytes, flops)


def time_flash(fa, ref) -> dict:
    """The flash kernel, its plain version and PyTorch's fused attention
    (the yardstick; the port never calls it) at phase 7's shape, bf16."""
    import torch.nn.functional as F

    B, S, H, KV, hd = QWEN_BATCH, QWEN_PROMPT, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = [torch.randn((B, S, n, hd), generator=g, device="cuda").to(
        torch.bfloat16) for n in (H, KV, KV)]
    # the library call takes (B, H, S, hd) with K and V expanded; the
    # layout change is made once, outside the timing
    lib_in = [x.transpose(1, 2).repeat_interleave(H // x.shape[2], dim=1)
              .contiguous() for x in qkv]
    got = fa.flash_attention(*qkv)
    lib = F.scaled_dot_product_attention(*lib_in, is_causal=True)
    torch.cuda.synchronize()
    lib_err = float((got.float() - lib.transpose(1, 2).float()).abs().max())
    del got, lib

    def run_kernel(x):
        return fa.flash_attention(*x)

    def run_plain(x):
        return ref.flash_attention_ref(*x)

    def run_lib(x):
        return F.scaled_dot_product_attention(*x, is_causal=True)

    # in turns: plain, kernel, library, library, kernel, plain
    plain_a = time_launches(run_plain, [qkv], 2)
    ms = time_launches(run_kernel, [qkv], 20)
    lib_a = time_launches(run_lib, [lib_in], 50)
    lib_b = time_launches(run_lib, [lib_in], 50)
    ms_b = time_launches(run_kernel, [qkv], 20)
    plain_b = time_launches(run_plain, [qkv], 2)
    b_ms, b_by, n_bytes, flops = flash_bound_ms(B, S, H, KV, hd, 2)
    kernel_ms = min(ms, ms_b)
    print(f"timing flash_attention at (B,S,H,KV,hd)=({B},{S},{H},{KV},{hd}) "
          f"bf16 causal: kernel {ms:.6f} / {ms_b:.6f} ms, plain "
          f"{plain_a:.6f} / {plain_b:.6f} ms, scaled_dot_product_attention "
          f"{lib_a:.6f} / {lib_b:.6f} ms (max |kernel - library| "
          f"{lib_err}), bound {b_ms:.6f} ms by {b_by} ({n_bytes:.0f} bytes, "
          f"{flops:.0f} FLOP), {flops / kernel_ms / 1e9:.3f} TFLOP/s, "
          f"{100 * b_ms / kernel_ms:.3f}% of the {b_by} bound, "
          f"{kernel_ms / min(lib_a, lib_b):.2f}x the library call")
    return {"ms": kernel_ms, "plain_ms": min(plain_a, plain_b),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": min(lib_a, lib_b)}


def launch_counts(wrappers) -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in wrappers}


def main_path(name: str, wrappers, needs: tuple[str, ...], run):
    """Drive one path of the main run with every launch count set to 0
    just before it and read just after; fail if a kernel the path names
    was not launched.  Returns (counts, what `run` returned)."""
    for fn in wrappers:
        fn.launches = 0
    result = run()
    counts = launch_counts(wrappers)
    for k in needs:
        check(counts[k] > 0, f"{k} was not launched in {name}")
    print(f"launches in {name}: {counts}")
    return counts, result


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core import seeds as seeds_mod
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf2_xor as gx
    from repro_torch.kernels import gf_matmul as gk
    from repro_torch.models import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:   # one nvcc each
        libs = list(pool.map(build.build, KERNEL_SOURCES))
    gk._lib()
    gx._lib()
    fa._lib()
    print(f"build: {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.3f} s (nvcc "
          f"{' '.join(build.NVCC_FLAGS)})")
    ptxas_report(libs)
    sass_report(*(libs[KERNEL_SOURCES.index(name)] for name in (
        "gf_matmul", "gf2_xor", "flash_attention")))

    wrappers = gk.WRAPPERS + gx.WRAPPERS + fa.WRAPPERS
    errors = phase1(gk, gx, ref, seeds_mod)
    errors.update(phase1_batched(gk, ref))
    errors.update(phase1_flash(fa, ref, attn))
    cnn = cnn_clients()
    packed = ("gf_matmul_packed", "gf_matmul_packed_seeded")
    runs = [
        main_path("phase 2", wrappers, packed, lambda: phase2(*cnn)),
        main_path("phase 3", wrappers, packed, lambda: phase3(wrappers)),
        main_path("phase 4", wrappers, ("gf_matmul_unpacked", "gf2_matmul"),
                  lambda: phase4(*cnn)),
        main_path("phase 5", wrappers, ("gf_matmul_unpacked",),
                  lambda: phase5(cnn[1])),
    ]
    P = runs[1][1]
    runs[1] = (runs[1][0], None)
    P1 = P & 1
    runs.append(main_path("phase 6", wrappers,
                          ("gf_matmul_unpacked", "gf2_matmul"),
                          lambda: phase6(wrappers, P, P1)))
    trace_rounds(P, P1)
    del P1
    times = time_kernels(gk, gx, ref, P)
    counts8, wide_err = main_path(
        "phase 8", wrappers,
        ("gf_matmul_packed", "gf_matmul_packed_seeded",
         "gf_matmul_packed_batched"), lambda: phase8(gk, ref, P))
    runs.append((counts8, None))
    errors["gf_matmul_packed"] = max(errors["gf_matmul_packed"], wide_err)
    times["gf_matmul_packed_batched"] = time_batched(gk, ref)
    errors["gf_matmul_packed_batched"] = max(
        errors["gf_matmul_packed_batched"],
        times["gf_matmul_packed_batched"]["max_abs_err"])
    del P                 # 4 GB of payload: free it before phase 7
    torch.cuda.empty_cache()

    cfg = get_config(QWEN)
    params, prompt = qwen_model(cfg)
    counts7, m7 = main_path("phase 7", wrappers, ("flash_attention",),
                            lambda: phase7(fa, cfg, params, prompt))
    runs.append((counts7, None))
    phase9(wrappers, runs)
    runs.append(main_path("phase 10", wrappers,
                          ("gf_matmul_packed", "gf_matmul_packed_seeded",
                           "gf_matmul_unpacked", "gf2_matmul"),
                          lambda: phase10(wrappers, cnn[1])))
    trace_serving(cfg, params, prompt)
    # phase 11 trains on phase 7's first TRAIN_LAYERS layers; the rest go
    holder = {"params": {**params,
                         "decoder": params["decoder"][:TRAIN_LAYERS]}}
    del params, prompt
    torch.cuda.empty_cache()
    counts11, m11 = phase11(fa, attn, wrappers, cfg, holder)
    runs.append((counts11, None))
    torch.cuda.empty_cache()
    runs.append(main_path("phase 12", wrappers, ("flash_attention",),
                          lambda: phase12(fa, attn)))
    torch.cuda.empty_cache()
    counts13, m13 = main_path("phase 13", wrappers, ("flash_attention",),
                              lambda: phase13(fa))
    runs.append((counts13, None))
    torch.cuda.empty_cache()
    counts14, m14 = main_path("phase 14", wrappers, ("flash_attention",),
                              lambda: phase14(fa))
    runs.append((counts14, None))
    torch.cuda.empty_cache()
    phase15(wrappers, m7, m11, m13, m14)
    del m11
    counts = {fn.__name__: sum(c[fn.__name__] for c, _ in runs)
              for fn in wrappers}
    print("kernels: " + ", ".join(f"{k} launches={v}"
                                  for k, v in counts.items())
          + " (phases 2-14)")
    times["flash_attention"] = time_flash(fa, ref)

    gm_py = "src/repro/kernels/gf_matmul.py"
    replaces = {"gf_matmul_packed": f"{gm_py}:204",
                "gf_matmul_packed_batched": f"{gm_py}:204",
                "gf_matmul_packed_seeded": f"{gm_py}:286",
                "gf_matmul_unpacked": f"{gm_py}:93",
                "gf2_matmul": "src/repro/kernels/gf2_xor.py:33",
                "flash_attention": "src/repro/kernels/flash_attention.py:78"}
    csrc = "src/repro_torch/kernels/csrc"
    source = {"gf2_matmul": f"{csrc}/gf2_xor.cu",
              "flash_attention": f"{csrc}/flash_attention.cu"}
    report = {"kernels": [{
        "name": name, "route": "cuda",
        "source": source.get(name, f"{csrc}/gf_matmul.cu"),
        "replaces": replaces[name], "launches": counts[name],
        "max_abs_err": errors[name], "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"],
        "library_ms": times[name].get("library_ms"),
    } for name in counts]}
    print(card)                                # as nvidia-smi prints it
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
