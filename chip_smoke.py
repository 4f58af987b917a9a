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
   aggregation's synchronized ms, then profiles one FedNC s = 8 round.

Phase 1 also holds the packed kernel's batched instance against its
plain version (J = 1, 3, 8; s = 1, 4, 8; 16-, 8-, 4- and 1-byte aligned
rows; strided views; K = 4,099; nothing written outside each output)
and the flash-attention kernel against its plain version
in float32 and bf16: head_dim 32, 64, 128, GQA groups 1 and 4, S = 1,
ragged S (100, 2049), the bf16 kernel's 128-key tile edges (129, 256,
300), non-causal, strided views, views TMA cannot read in place (each
still one launch) and phase 7's shape.  After the build it prints
ptxas' registers and spills of every kernel instance, the SASS census
of the GF kernels' s = 8 instances and of the XOR kernel's 8-row
instance, whole and of their hottest basic block, the step of a full
tile (LOP3, of them the selects, SHF, IADD3, IMAD, ISETP, and shared
and global loads by width; the selects per word and packet row) and the
count of tensor-core instructions (HGMMA, HMMA) in the flash library.

Each of phases 2-9 (each run of phase 9) drives the main path with every launch count set to
0 just before it and read just after, and fails if a kernel of that
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
2-9), error, time, plain time and bound.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository's `src/` beside it, it fails before printing a result.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

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
KERNEL_SOURCES = ("gf_matmul", "gf2_xor", "flash_attention")  # csrc/<name>.cu


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
        shapes = cases + ([(QWEN_BATCH, QWEN_PROMPT, 32, 8, 128, True, 0)]
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
          f"in each dtype + the phase-7 shape in bf16 (hd 32/64/128, groups "
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


def held_to_fresh(dec, fresh, cfg, tol: dict, what: str) -> tuple[float, int]:
    """Cached-decode logits == fresh ones within `tol`, and the same
    greedy token wherever the margin is clear; (max |err|, requests with
    a clear margin)."""
    err = float((dec - fresh).abs().max())
    check(torch.allclose(dec, fresh, **tol),
          f"phase 7: {what} cached decode logits differ from a fresh "
          f"forward (max |err| {err}, tolerance {tol})")
    clear = clear_margin(fresh, cfg, tol)
    check(torch.equal(greedy(dec, cfg)[clear], greedy(fresh, cfg)[clear]),
          f"phase 7: {what} cached and fresh greedy tokens differ at a "
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
           "peak": peak}
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
    counts7, _ = main_path("phase 7", wrappers, ("flash_attention",),
                           lambda: phase7(fa, cfg, params, prompt))
    runs.append((counts7, None))
    phase9(wrappers, runs)
    counts = {fn.__name__: sum(c[fn.__name__] for c, _ in runs)
              for fn in wrappers}
    print("kernels: " + ", ".join(f"{k} launches={v}"
                                  for k, v in counts.items())
          + " (phases 2-9)")
    trace_serving(cfg, params, prompt)
    del params, prompt
    torch.cuda.empty_cache()
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
