#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/kernels/csrc`
with nvcc (sm_90a) and runs, failing on the first wrong result:

1. each kernel against its plain PyTorch version on the card, byte for
   byte: s in {1, 2, 4, 8}, the chunk shapes of phases 2 and 3, ragged
   L, n != K, n above one row tile, strided and misaligned column views
   of P and of the output, L = 0;
2. `fednc_round` at the paper CNN's full width (32x32x3 inputs, 10
   classes, K = 10 clients, 2 extra tuples, 20% erasures, s = 8) with the
   `auto` and `auto_seeded` kernels: it must decode and equal
   `fedavg_round` bit for bit;
3. `CodingEngine.round` on a real update size: K = 8 clients of 500,000,000
   symbols (one float32 update of a 125M-parameter model), 2 extra
   tuples, 10% erasures, the default chunk width, materialized and
   seeded: the decoded packets must equal P.

Then it traces one round per configuration with torch.profiler (device
busy share, device time per kernel), times each kernel and its plain
version at the chunk shape (8 x 262,144) with CUDA events, and prints,
before its last line, the
card's name and power limit and one JSON object with every kernel's
launches (phases 2 and 3), error, time, plain time and bound.  The last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's `src/` beside it, it fails before printing a
result.  It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (700 W).  HBM: 3.35 TB/s.  int32: 64 int32
# lanes per SM (Hopper white paper) x 132 SMs x 1.98 GHz, the clock at
# which the data sheet's 67 TFLOP/s float32 (128 lanes x 2 FLOP) holds.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

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


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def phase1(gk, ref, seeds_mod) -> dict[str, int]:
    """Byte-exact kernel == plain version; returns max |error| per kernel."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # (n, K, L, column offset, extra columns) of a view into a wider P
    # and a wider output: phase 3's chunk, phase 2's full and last
    # chunks (CNN, K = 10: 1,237,160 = 4 x 2^18 + 188,584), ragged L,
    # unaligned rows, a misaligned view, an aligned strided view, n over
    # one 16-row tile, K = 1, L = 0
    cases = [(8, 8, 1 << 18, 0, 0), (10, 10, 1 << 18, 0, 0),
             (10, 10, 188584, 0, 0), (3, 5, 4097, 0, 3), (10, 8, 1001, 0, 0),
             (6, 6, 2050, 3, 1), (6, 6, 4096, 4, 4), (19, 7, 1030, 0, 2),
             (5, 1, 13, 0, 0), (4, 4, 0, 0, 0)]
    worst = {"gf_matmul_packed": 0, "gf_matmul_packed_seeded": 0}
    for s in (1, 2, 4, 8):
        for n, K, L, off, extra in cases:
            wide = torch.randint(0, 1 << s, (K, L + off + extra), generator=g,
                                 device=dev, dtype=torch.uint8)
            P = wide[:, off:off + L]           # row-strided column view
            A = torch.randint(0, 1 << s, (n, K), generator=g, device=dev,
                              dtype=torch.uint8)
            seeds = torch.randint(0, 1 << 32, (n,), generator=g,
                                  device=dev, dtype=torch.int64)
            # the materialized result goes into columns of a wider output,
            # as the engine's chunk loop hands them over
            wide_out = torch.zeros((n, L + off + extra), device=dev,
                                   dtype=torch.uint8)
            got = gk.gf_matmul_packed(A, P, s=s, out=wide_out[:, off:off + L])
            want = ref.gf_matmul_packed_ref(A, P, s)
            got_s = gk.gf_matmul_packed_seeded(seeds, P, s=s)
            want_s = ref.gf_matmul_packed_seeded_ref(seeds, P, s)
            via_rows = gk.gf_matmul_packed(
                seeds_mod.expand_rows(seeds, K, s), P, s=s)
            torch.cuda.synchronize()
            check(not wide_out[:, :off].any() and
                  not wide_out[:, off + L:].any(),
                  f"gf_matmul_packed s={s} {(n, K, L, off)} wrote outside "
                  f"its output view")
            for name, a, b in (("gf_matmul_packed", got, want),
                               ("gf_matmul_packed_seeded", got_s, want_s),
                               ("gf_matmul_packed_seeded", got_s, via_rows)):
                check(a.shape == (n, L) and a.dtype == torch.uint8,
                      f"{name} s={s} {(n, K, L)}: shape {tuple(a.shape)}")
                err = int((a.int() - b.int()).abs().max()) if a.numel() \
                    else 0
                worst[name] = max(worst[name], err)
                check(err == 0, f"{name} s={s} (n,K,L,off)={(n, K, L, off)}"
                                f" differs from its plain version")
            if L and L <= 4097:                # independent table oracle
                table = ref.gf_matmul_ref(A, P, s)
                check(torch.equal(got, table),
                      f"gf_matmul_packed s={s} {(n, K, L)} != table oracle")
    print(f"phase 1: both kernels == plain versions, s in 1,2,4,8, "
          f"{len(cases)} shapes each, max_abs_err={worst}")
    return worst


# ---------------------------------------------------------------------------
# phase 2: fednc_round at the paper CNN's full width
# ---------------------------------------------------------------------------

def phase2() -> None:
    from repro_torch.core import packets as pkt
    from repro_torch.core.channel import ErasureChannel
    from repro_torch.core.fednc import FedNCConfig, fedavg_round, fednc_round
    from repro_torch.models.cnn import init_cnn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED_CLIENTS)
    base = init_cnn(g, num_classes=10, image_size=32)
    clients = [pkt.tree_map(
        lambda x: x + 0.01 * torch.randn(x.shape, generator=g, device=dev),
        base) for _ in range(10)]
    weights = np.random.default_rng(SEED_CLIENTS).integers(50, 500, 10)
    want = fedavg_round(clients, weights, base).global_params
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
        same = [torch.equal(a, b) for a, b in zip(
            pkt.tree_flatten(res.global_params)[0],
            pkt.tree_flatten(want)[0], strict=True)]
        check(all(same), f"phase 2 {kernel}: FedNC != FedAvg")
        print(f"phase 2: fednc_round kernel={kernel} CNN {n_bytes} bytes/"
              f"client K=10 {res.report}: decoded, == fedavg_round "
              f"bit-exact")


# ---------------------------------------------------------------------------
# phase 3: CodingEngine.round at a real update size
# ---------------------------------------------------------------------------

def phase3(gk) -> torch.Tensor:
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
        before = gk.launch_counts()
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
        after = gk.launch_counts()
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
# where a round's time goes: one traced round per kernel configuration
# ---------------------------------------------------------------------------

def trace_round(P: torch.Tensor) -> None:
    """Profile one phase-3 round per configuration: device busy time (the
    union of device activity), its share of the traced wall time, and the
    device time per kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.channel import ErasureChannel
    from repro_torch.engine import CodingEngine, EngineConfig

    for kernel in ("auto", "auto_seeded"):
        eng = CodingEngine(EngineConfig(s=8, kernel=kernel, extra_tuples=2),
                           device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = eng.round(P, torch.Generator().manual_seed(SEED_ROUND),
                            channel=ErasureChannel(0.1, seed=SEED_ERASE3))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        check(out.ok and torch.equal(out.packets, P),
              f"traced round {kernel}: P_hat != P")
        del out
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
            per_name.setdefault(name[:72], []).append(e - s)
        busy += hi - lo
        print(f"trace {kernel}: traced wall {wall_us:.1f} us, device busy "
              f"{busy:.1f} us ({100 * busy / wall_us:.2f}% of the wall, "
              f"idle {100 - 100 * busy / wall_us:.2f}%), "
              f"{len(spans)} device activities")
        for name, d in sorted(per_name.items(), key=lambda x: -sum(x[1])):
            print(f"trace {kernel}:   {sum(d):.1f} us in {len(d)} x "
                  f"{name} (mean {sum(d) / len(d):.3f} us)")


# ---------------------------------------------------------------------------
# timing at the chunk shape
# ---------------------------------------------------------------------------

def bound_ms(n: int, K: int, L: int, s: int, seeded: bool
             ) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, int32 ops) for one launch."""
    words = -(-L // 4)
    row_bytes = 8 * n if seeded else n * K
    n_bytes = K * L + n * L + row_bytes
    ops = words * (XTIME_OPS * K * (s - 1) + SELECT_OPS * n * K * s)
    if seeded:
        ops += n * -(-K // 4) * THREEFRY_OPS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops > t_bytes
            else "bytes", n_bytes, ops)


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


def time_kernels(gk, ref, P: torch.Tensor) -> dict:
    n, K, L = CHUNK
    s = 8
    g = torch.Generator(device="cuda").manual_seed(1)
    A = torch.randint(0, 256, (n, K), generator=g, device="cuda",
                      dtype=torch.uint8)
    seeds = torch.randint(0, 1 << 32, (n,), generator=g, device="cuda",
                          dtype=torch.int64)
    # distinct chunk views of the phase-3 payload, 2 MB each, 400 MB in
    # all: every launch reads its chunk from HBM, as in the round
    chunks = [P[:, c * L:(c + 1) * L] for c in range(200)]
    out = {}
    for name, kern, plain, rows, seeded in (
            ("gf_matmul_packed", gk.gf_matmul_packed,
             ref.gf_matmul_packed_ref, A, False),
            ("gf_matmul_packed_seeded", gk.gf_matmul_packed_seeded,
             ref.gf_matmul_packed_seeded_ref, seeds, True)):
        def run_plain(X, plain=plain, rows=rows):
            return plain(rows, X, s)

        def run_kernel(X, kern=kern, rows=rows):
            return kern(rows, X, s=s)

        # in turns: plain, kernel, kernel, plain
        plain_a = time_launches(run_plain, chunks, 2)
        ms = time_launches(run_kernel, chunks, 400)
        ms_b = time_launches(run_kernel, chunks, 400)
        plain_b = time_launches(run_plain, chunks, 2)
        b_ms, b_by, n_bytes, ops = bound_ms(n, K, L, s, seeded)
        kernel_ms = min(ms, ms_b)
        plain_ms = min(plain_a, plain_b)
        out[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        print(f"timing {name} at (n,K,L)=({n},{K},{L}) s={s}: kernel "
              f"{ms:.6f} / {ms_b:.6f} ms, plain {plain_a:.6f} / "
              f"{plain_b:.6f} ms, bound {b_ms:.6f} ms by {b_by} "
              f"({n_bytes} bytes, {ops} int32 ops), "
              f"{n_bytes / kernel_ms / 1e6:.3f} GB/s, "
              f"{ops / kernel_ms / 1e9:.3f} T int32 op/s, "
              f"{100 * b_ms / kernel_ms:.2f}% of the {b_by} bound")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.core import seeds as seeds_mod
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import gf_matmul as gk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    lib = build.build("gf_matmul")
    gk._lib()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.3f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    log = lib.with_name(lib.name + ".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}")

    errors = phase1(gk, ref, seeds_mod)
    gk.reset_launch_counts()                   # the main path starts here
    phase2()
    after2 = gk.launch_counts()
    P = phase3(gk)
    counts = gk.launch_counts()                # ... and ends here
    for name, c in counts.items():
        check(after2[name] > 0, f"{name} was not launched in phase 2")
        check(c - after2[name] > 0, f"{name} was not launched in phase 3")
    print("kernels: " + ", ".join(
        f"{k} launches={v} (phase 2: {after2[k]}, phase 3: "
        f"{v - after2[k]})" for k, v in counts.items()))

    trace_round(P)
    times = time_kernels(gk, ref, P)
    replaces = {"gf_matmul_packed": "src/repro/kernels/gf_matmul.py:204",
                "gf_matmul_packed_seeded":
                    "src/repro/kernels/gf_matmul.py:286"}
    report = {"kernels": [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gf_matmul.cu",
        "replaces": replaces[name], "launches": counts[name],
        "max_abs_err": errors[name], "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"], "library_ms": None,
    } for name in counts]}
    print(card)                                # as nvidia-smi prints it
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
