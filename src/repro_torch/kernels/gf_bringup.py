"""Bring-up A/B of designs of `csrc/gf_matmul.cu` on one NVIDIA card.

    python -m repro_torch.kernels.gf_bringup NAME=SOURCE[:KEY=VALUE,...] ...

(from the repository root, with ``PYTHONPATH=src``).  Each argument is
one variant: SOURCE is a `gf_matmul.cu` with the C interface of
`kernels/gf_matmul.py` (the current one, ``csrc/gf_matmul.cu``, or an
older commit's, written out with ``git show``), and each KEY=VALUE
replaces the value of the line ``constexpr int KEY = ...;`` in a copy
of it.  Every variant is built with `build.NVCC_FLAGS` into
``build/bringup/`` (gitignored); then the script prints, per variant,
ptxas' registers and spills and the SASS census of the hot loop
(`build.sass_census`) of its s = 8 instances, holds its three kernels
byte for byte against the plain versions (`kernels.ref`) on the main
path's shapes and the edge cases, and times each kernel at the chunk shape (n = K = 8,
L = 2^18, s = 8) with rows 16-, 8- and 4-byte aligned (and the first
variant at K = 0, its fixed cost of launch and stores): 200 distinct
chunk views of one payload, the stream held busy while 400 launches
queue, CUDA events; the variants in order and then in reverse, the
lower of each variant's two readings kept.  It prints the card's name
and power limit first.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build, ref
from . import gf_matmul as gk

OUT_DIR = build.BUILD_DIR.parent / "bringup"
CHUNK = (8, 8, 1 << 18)
VIEWS = 200
REPS = 400
SLEEP_CYCLES = 100_000_000
KERNELS = ("gf_matmul_packed", "gf_matmul_packed_seeded",
           "gf_matmul_unpacked")


def variant_source(name: str, spec: str) -> pathlib.Path:
    """Write variant `name` (SOURCE[:KEY=VALUE,...]) under OUT_DIR."""
    source, _, edits = spec.partition(":")
    text = pathlib.Path(source).read_text()
    for edit in filter(None, edits.split(",")):
        key, value = edit.split("=")
        text, hits = re.subn(rf"(constexpr int {key} = )[^;]+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise SystemExit(f"{name}: no line 'constexpr int {key} = ...;'")
    out = OUT_DIR / f"{name}.cu"
    out.write_text(text)
    return out


def build_variant(name: str, source: pathlib.Path) -> ctypes.CDLL:
    lib = OUT_DIR / f"lib{name}.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
           str(lib), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed:\n{proc.stderr[-4000:]}")
    for label, info in sorted(build.ptxas_kernels(proc.stdout +
                                                  proc.stderr).items()):
        if "<8" in label:
            print(f"{name} ptxas: {label}: {info}")
    for label, (_, loop) in sorted(build.sass_census(lib).items()):
        if "<8" in label:
            keep = {k: v for k, v in sorted(loop.items())
                    if k.split(".")[0] in ("instructions", "LOP3", "SHF",
                                           "IADD3", "IMAD", "ISETP", "LDS",
                                           "LDG", "BRA")}
            print(f"{name} sass hot loop: {label}: {keep}")
    return gk.declare(ctypes.CDLL(str(lib)), KERNELS)


def call(lib, kernel: str, rows, P, s: int, out=None):
    wrapper = getattr(gk, kernel)
    return gk.launch(lib, wrapper, rows, P, rows.shape[0], s, out)


def plain(kernel: str, rows, P, s: int):
    return {"gf_matmul_packed": ref.gf_matmul_packed_ref,
            "gf_matmul_packed_seeded": ref.gf_matmul_packed_seeded_ref,
            "gf_matmul_unpacked": ref.gf_matmul_clmul_ref}[kernel](rows, P, s)


def check(name: str, lib) -> None:
    """Byte-exact against the plain versions; outside the output view
    untouched."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cnn = 1_237_160
    # (n, K, L, column offset, extra columns)
    cases = [(8, 8, 1 << 18, 0, 0), (10, 10, 1 << 18, 1 << 18,
                                     cnn - 2 * (1 << 18)),
             (10, 10, 188_584, cnn - 188_584, 0), (8, 8, 4097, 0, 15),
             (8, 8, 1039, 0, 1), (6, 6, 2050, 3, 1), (17, 7, 1030, 0, 2),
             (33, 9, 777, 4, 0), (9, 40, 3001, 16, 7), (3, 3072, 517, 0, 0),
             (5, 1, 13, 0, 0)]
    for s in (2, 8):
        for n, K, L, off, extra in cases:
            for kernel in KERNELS:
                hi = 256 if kernel == "gf_matmul_unpacked" else 1 << s
                wide = torch.randint(0, hi, (K, L + off + extra), generator=g,
                                     device=dev, dtype=torch.uint8)
                P = wide[:, off:off + L]
                if kernel == "gf_matmul_packed_seeded":
                    rows = torch.randint(0, 1 << 32, (n,), generator=g,
                                         device=dev, dtype=torch.int64)
                else:
                    rows = torch.randint(0, hi, (n, K), generator=g,
                                         device=dev, dtype=torch.uint8)
                wide_out = torch.zeros((n, L + off + extra), device=dev,
                                       dtype=torch.uint8)
                got = call(lib, kernel, rows, P, s,
                           wide_out[:, off:off + L])
                torch.cuda.synchronize()
                what = f"{name} {kernel} s={s} {(n, K, L, off, extra)}"
                if not torch.equal(got, plain(kernel, rows, P, s)):
                    raise SystemExit(f"FAIL {what}")
                if wide_out[:, :off].any() or wide_out[:, off + L:].any():
                    raise SystemExit(f"FAIL {what}: wrote outside")
    print(f"{name}: 3 kernels == plain versions on {len(cases)} shapes, "
          f"s in 2, 8", flush=True)


def time_launches(fn, inputs) -> float:
    """Mean device ms per call over REPS calls cycling through `inputs`,
    queued behind a busy stream."""
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(REPS):
        fn(inputs[i % len(inputs)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def time_all(libs: dict) -> None:
    n, K, L = CHUNK
    s = 8
    g = torch.Generator(device="cuda").manual_seed(1)
    A = torch.randint(0, 256, (n, K), generator=g, device="cuda",
                      dtype=torch.uint8)
    seeds = torch.randint(0, 1 << 32, (n,), generator=g, device="cuda",
                          dtype=torch.int64)
    for align in (16, 8, 4):
        pad = {16: 0, 8: 8, 4: 4}[align]
        payload = torch.randint(0, 256, (K, VIEWS * L + pad), generator=g,
                                device="cuda", dtype=torch.uint8)
        views = [payload[:, c * L:(c + 1) * L] for c in range(VIEWS)]
        outs = torch.empty((n, VIEWS * L + pad), device="cuda",
                           dtype=torch.uint8)
        out_views = [outs[:, c * L:(c + 1) * L] for c in range(VIEWS)]
        pairs = list(zip(views, out_views))
        for kernel in KERNELS:
            rows = seeds if kernel == "gf_matmul_packed_seeded" else A
            order = list(libs) + list(reversed(libs))
            got: dict[str, list[float]] = {name: [] for name in libs}
            for name in order:
                lib = libs[name]
                got[name].append(time_launches(
                    lambda x, lib=lib: call(lib, kernel, rows, x[0], s, x[1]),
                    pairs))
            print(f"time {kernel} (n,K,L)=({n},{K},{L}) s={s} rows "
                  f"{align}-byte aligned: " + ", ".join(
                      f"{name} {min(t) * 1e3:.3f} us ({t[0] * 1e3:.3f} / "
                      f"{t[1] * 1e3:.3f})" for name, t in got.items()),
                  flush=True)
            if align == 16:
                # the fixed cost: the same launch at K = 0 (C written as 0)
                lib = next(iter(libs.values()))
                empty = rows if rows.dim() == 1 else rows[:, :0]
                floor = time_launches(
                    lambda x: call(lib, kernel, empty, x[0][:0], s, x[1]),
                    pairs)
                print(f"time {kernel} at K=0 (launch and stores only), "
                      f"{next(iter(libs))}: {floor * 1e3:.3f} us", flush=True)
        del payload, outs, views, out_views, pairs
        torch.cuda.empty_cache()


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    specs = dict(arg.split("=", 1) for arg in argv)
    sources = {name: variant_source(name, spec)
               for name, spec in specs.items()}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build_variant, sources,
                                           sources.values())))
    for name, lib in built.items():
        check(name, lib)
    time_all(built)


if __name__ == "__main__":
    main(sys.argv[1:])
