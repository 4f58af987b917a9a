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
   wherever the fresh top-2 margin is clear of the tolerance.

Phase 1 also holds the flash-attention kernel against its plain version
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

Each of phases 2-7 drives the main path with every launch count set to
0 just before it and read just after, and fails if a kernel of that
path was not launched.  Then it traces one round per 500M configuration,
one prefill and one serve step with torch.profiler (device busy share, device time per
kernel), times each GF kernel and its plain version at the chunk shape
(8 x 262,144; beside the operations bound, the share of the bytes
bound; the XOR kernel also at phase 6's leg shapes, 10 x 8 and 8 x 10)
and the flash kernel, its plain version and PyTorch's
`scaled_dot_product_attention` (timing only) at phase 7's shape with
CUDA events, and prints, before its last line, the card's name and
power limit and one JSON object with every kernel's launches (phases
2-7), error, time, plain time and bound.  The last line is
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
# phase 7: Qwen3-4B serving
QWEN = "qwen3-4b"
QWEN_BATCH = 4
QWEN_PROMPT = 2048
QWEN_DECODE = 32                 # greedy steps; the cache holds prompt + these
SEED_QWEN = 5                    # weights, drawn on the card
SEED_PROMPT = 6                  # prompt token ids
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
# the XOR kernel's 8-row one (LDGSTS: cp.async, global to shared)
SASS_OPS = ("LOP3", "LOP3.select", "SHF", "IADD3", "IMAD", "ISETP",
            "LDS.128", "LDS.32", "LDG.128", "LDG.64", "LDG.32", "LDG.U8",
            "LDGSTS.128", "LDGSTS.64", "LDGSTS.32", "STG.128", "STG.64",
            "STG.32", "STG.U8")


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
            per = int(args[2 if label.startswith("gf_matmul_packed") else 1])
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
    del P                 # 4 GB of payload: free it before phase 7
    torch.cuda.empty_cache()

    cfg = get_config(QWEN)
    params, prompt = qwen_model(cfg)
    counts7, _ = main_path("phase 7", wrappers, ("flash_attention",),
                           lambda: phase7(fa, cfg, params, prompt))
    runs.append((counts7, None))
    counts = {fn.__name__: sum(c[fn.__name__] for c, _ in runs)
              for fn in wrappers}
    print("kernels: " + ", ".join(f"{k} launches={v}"
                                  for k, v in counts.items())
          + " (phases 2-7)")
    trace_serving(cfg, params, prompt)
    del params, prompt
    torch.cuda.empty_cache()
    times["flash_attention"] = time_flash(fa, ref)

    gm_py = "src/repro/kernels/gf_matmul.py"
    replaces = {"gf_matmul_packed": f"{gm_py}:204",
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
