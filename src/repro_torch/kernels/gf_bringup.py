"""Bring-up A/B of designs of the GF kernel sources on one NVIDIA card.

    python -m repro_torch.kernels.gf_bringup NAME=SOURCE[:KEY=VALUE,...] ...

(from the repository root, with ``PYTHONPATH=src``).  Each argument is
one variant: SOURCE is a `gf_matmul.cu` with the C interface of
`kernels/gf_matmul.py`, or a `gf2_xor.cu` with that of
`kernels/gf2_xor.py` (the current one under ``csrc/``, or an older
commit's, written out with ``git show``); all variants of one call are
of one source.  Each KEY=VALUE replaces the value of the line
``constexpr int KEY = ...;`` in a copy of it.  Every variant is built
with `build.NVCC_FLAGS` into ``build/bringup/`` (gitignored); then the
script prints, per variant, ptxas' registers and spills and the SASS
census of the hot loop (`build.sass_census`) of the instances the
timing runs (s = 8 for `gf_matmul.cu`, the 8-row tile for
`gf2_xor.cu`), holds its kernels byte for byte against the plain
versions (`kernels.ref`) on the main path's shapes and the edge cases,
and times each kernel at the chunk shape (n = K = 8, L = 2^18; s = 8,
or raw bytes for the XOR kernel) with rows 16-, 8- and 4-byte aligned,
the XOR kernel also at phase 6's leg shapes (10, 8) and (8, 10), and
the first variant at K = 0 (its fixed cost of launch and stores; for
the XOR kernel also PyTorch's copy of the chunk, which moves the same
bytes, as a yardstick): 200
distinct chunk views of one payload, the stream held busy while 400
launches queue, CUDA events; the variants in order and then in
reverse, the lower of each variant's two readings kept.  The XOR
kernel is also timed as a coding round runs it, each leg pair alone on
an idle card (`time_legs_isolated`, torch.profiler): there a launch
finds the instruction cache cold.  It prints the
card's name and power limit first.  Nothing here runs at import time.
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
from . import gf2_xor as gx
from . import gf_matmul as gk

OUT_DIR = build.BUILD_DIR.parent / "bringup"
CHUNK = (8, 8, 1 << 18)
LEGS = ((10, 8, 1 << 18), (8, 10, 1 << 18))   # phase 6's RowMix legs
VIEWS = 200
REPS = 400
SLEEP_CYCLES = 100_000_000
# per source: its kernels, the fields it is checked and timed at, and
# the instance label (`build.kernel_label`) whose census is printed
SOURCES = {
    "gf_matmul": {"kernels": ("gf_matmul_packed", "gf_matmul_packed_seeded",
                              "gf_matmul_unpacked"),
                  "fields": (2, 8), "s": 8, "census": re.compile(r"<8\b")},
    "gf2_xor": {"kernels": ("gf2_matmul",), "fields": (1,), "s": 1,
                "census": re.compile(r"^gf2_matmul_kernel(<8>)?$")},
}
PLAIN = {"gf_matmul_packed": ref.gf_matmul_packed_ref,
         "gf_matmul_packed_seeded": ref.gf_matmul_packed_seeded_ref,
         "gf_matmul_unpacked": ref.gf_matmul_clmul_ref,
         "gf2_matmul": lambda rows, P, s: ref.gf2_matmul_ref(rows, P)}
WRAPPER = {**{fn.__name__: fn for fn in gk.WRAPPERS},
           **{fn.__name__: fn for fn in gx.WRAPPERS}}


def source_kind(text: str) -> str:
    """Which source a variant is: by the C function it exports."""
    return "gf2_xor" if re.search(r"\bint gf2_matmul\(", text) else \
        "gf_matmul"


def variant_source(name: str, spec: str) -> tuple[pathlib.Path, str]:
    """Write variant `name` (SOURCE[:KEY=VALUE,...]) under OUT_DIR;
    return its path and `source_kind`."""
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
    return out, source_kind(text)


def build_variant(name: str, source: pathlib.Path, kind: str) -> ctypes.CDLL:
    lib = OUT_DIR / f"lib{name}.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
           str(lib), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed:\n{proc.stderr[-4000:]}")
    census = SOURCES[kind]["census"]
    for label, info in sorted(build.ptxas_kernels(proc.stdout +
                                                  proc.stderr).items()):
        if kind == "gf2_xor" or census.search(label):
            print(f"{name} ptxas: {label}: {info}")
    for label, (_, loop) in sorted(build.sass_census(lib).items()):
        if census.search(label):
            keep = {k: v for k, v in sorted(loop.items())
                    if k.split(".")[0] in ("instructions", "LOP3", "SHF",
                                           "IADD3", "IMAD", "ISETP", "LDS",
                                           "LDG", "LDGSTS", "BRA")}
            print(f"{name} sass hot loop: {label}: {keep}")
    return gk.declare(ctypes.CDLL(str(lib)), SOURCES[kind]["kernels"])


def call(lib, kernel: str, rows, P, s: int, out=None):
    return gk.launch(lib, WRAPPER[kernel], rows, P, rows.shape[0], s, out)


def draw_rows(kernel: str, n: int, K: int, hi: int, g):
    """Coding rows: seeds for the seeded kernel, else (n, K) bytes < hi."""
    if kernel == "gf_matmul_packed_seeded":
        return torch.randint(0, 1 << 32, (n,), generator=g, device="cuda",
                             dtype=torch.int64)
    return torch.randint(0, hi, (n, K), generator=g, device="cuda",
                         dtype=torch.uint8)


def check(name: str, lib, kind: str) -> None:
    """Byte-exact against the plain versions; outside the output view
    untouched."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cnn = 1_237_160
    # (n, K, L, column offset, extra columns): rows 16-, 8-, 4- and
    # 1-byte aligned, ragged L, n over 16, K above the mask tile and
    # above 3,072, K = 1
    cases = [(8, 8, 1 << 18, 0, 0), (10, 8, 1 << 18, 0, 0),
             (8, 10, 1 << 18, 0, 0),
             (10, 10, 1 << 18, 1 << 18, cnn - 2 * (1 << 18)),
             (10, 10, 188_584, cnn - 188_584, 0), (8, 8, 4097, 0, 15),
             (8, 8, 1039, 0, 1), (6, 6, 2050, 3, 1), (6, 6, 4096, 4, 4),
             (17, 7, 1030, 0, 2), (33, 9, 777, 4, 0), (9, 40, 3001, 16, 7),
             (3, 4099, 517, 0, 0), (5, 1, 13, 0, 0)]
    kernels = SOURCES[kind]["kernels"]
    # an older source that bounds K says so (`gf_max_k`); its variant
    # skips the cases above its limit
    kmax = lib.gf_max_k() if hasattr(lib, "gf_max_k") else None
    if kmax is not None:
        print(f"{name}: gf_max_k() = {kmax}: cases with K above it skipped",
              flush=True)
        cases = [c for c in cases if c[1] <= kmax]
    for s in SOURCES[kind]["fields"]:
        for n, K, L, off, extra in cases:
            for kernel in kernels:
                hi = 1 << s if kernel.startswith("gf_matmul_packed") else 256
                wide = torch.randint(0, hi, (K, L + off + extra), generator=g,
                                     device=dev, dtype=torch.uint8)
                P = wide[:, off:off + L]
                rows = draw_rows(kernel, n, K, hi, g)
                wide_out = torch.zeros((n, L + off + extra), device=dev,
                                       dtype=torch.uint8)
                got = call(lib, kernel, rows, P, s,
                           wide_out[:, off:off + L])
                torch.cuda.synchronize()
                what = f"{name} {kernel} s={s} {(n, K, L, off, extra)}"
                if not torch.equal(got, PLAIN[kernel](rows, P, s)):
                    raise SystemExit(f"FAIL {what}")
                if wide_out[:, :off].any() or wide_out[:, off + L:].any():
                    raise SystemExit(f"FAIL {what}: wrote outside")
    print(f"{name}: {len(kernels)} kernel(s) == plain versions on "
          f"{len(cases)} shapes, s in {SOURCES[kind]['fields']}", flush=True)


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


def time_isolated(fn, inputs) -> float:
    """Mean device time (ms) per kernel over REPS // 2 calls of `fn`
    cycling through `inputs`, the host waiting for each call before the
    next, so the card idles between them as in a coding round
    (torch.profiler's kernel spans)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(REPS // 2):
            fn(inputs[i % len(inputs)])
            torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == DeviceType.CUDA and "_kernel" in e.name]
    return sum(spans) / len(spans)


def time_legs_isolated(libs: dict) -> None:
    """The XOR kernel as phase 6's RowMix round runs it: the (10, 8) leg,
    then the (8, 10) leg on its output, one pair at a time."""
    (n1, K1, L), (n2, _, _) = LEGS
    g = torch.Generator(device="cuda").manual_seed(2)
    payload = torch.randint(0, 256, (K1, VIEWS * L), generator=g,
                            device="cuda", dtype=torch.uint8)
    views = [payload[:, c * L:(c + 1) * L] for c in range(VIEWS)]
    enc = draw_rows("gf2_matmul", n1, K1, 256, g)
    post = draw_rows("gf2_matmul", n2, n1, 256, g)
    got: dict[str, list[float]] = {name: [] for name in libs}
    for name in list(libs) + list(reversed(libs)):
        lib = libs[name]
        got[name].append(time_isolated(
            lambda x, lib=lib: call(lib, "gf2_matmul", post,
                                    call(lib, "gf2_matmul", enc, x, 1), 1),
            views))
    print(f"time gf2_matmul in isolation, legs ({n1},{K1}) then ({n2},{n1}) "
          f"on its output, L={L}, one pair at a time (profiler kernel time, "
          f"mean per launch): " + ", ".join(
              f"{name} {min(t) * 1e3:.3f} us ({t[0] * 1e3:.3f} / "
              f"{t[1] * 1e3:.3f})" for name, t in got.items()), flush=True)


def time_all(libs: dict, kind: str) -> None:
    s = SOURCES[kind]["s"]
    g = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(CHUNK, align) for align in (16, 8, 4)]
    if kind == "gf2_xor":
        shapes[1:1] = [(leg, 16) for leg in LEGS]
    for (n, K, L), align in shapes:
        pad = {16: 0, 8: 8, 4: 4}[align]
        payload = torch.randint(0, 256, (K, VIEWS * L + pad), generator=g,
                                device="cuda", dtype=torch.uint8)
        views = [payload[:, c * L:(c + 1) * L] for c in range(VIEWS)]
        outs = torch.empty((n, VIEWS * L + pad), device="cuda",
                           dtype=torch.uint8)
        out_views = [outs[:, c * L:(c + 1) * L] for c in range(VIEWS)]
        pairs = list(zip(views, out_views))
        for kernel in SOURCES[kind]["kernels"]:
            rows = draw_rows(kernel, n, K, 256, g)
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
            if (n, K, L) == CHUNK and align == 16:
                # the fixed cost: the same launch at K = 0 (C written as 0)
                lib = next(iter(libs.values()))
                empty = rows if rows.dim() == 1 else rows[:, :0]
                floor = time_launches(
                    lambda x: call(lib, kernel, empty, x[0][:0], s, x[1]),
                    pairs)
                print(f"time {kernel} at K=0 (launch and stores only), "
                      f"{next(iter(libs))}: {floor * 1e3:.3f} us", flush=True)
                if kind == "gf2_xor":
                    # a yardstick, not the function: PyTorch's copy kernel
                    # moving the same bytes (P's K rows read, C's n written)
                    copy = time_launches(lambda x: x[1].copy_(x[0]), pairs)
                    print(f"time copy_ of the chunk (the same {K * L} bytes "
                          f"read and {n * L} written, one launch): "
                          f"{copy * 1e3:.3f} us", flush=True)
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
    kinds = {kind for _, kind in sources.values()}
    if len(kinds) != 1:
        raise SystemExit(f"variants of one call must be of one source, got "
                         f"{sorted(kinds)}")
    kind = kinds.pop()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(
            lambda item: build_variant(item[0], *item[1]), sources.items())))
    for name, lib in built.items():
        check(name, lib, kind)
    time_all(built, kind)
    if kind == "gf2_xor":
        time_legs_isolated(built)


if __name__ == "__main__":
    main(sys.argv[1:])
