"""Build the CUDA sources in `csrc/` with nvcc at first use; load them
with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so
         csrc/<name>.cu

The library lands in ``build/kernels/`` at the repository root (listed
in ``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one loads at once.  nvcc's
``-Xptxas -v`` report (registers, shared memory, spills per kernel)
is kept beside the library as ``<library>.log``; `ptxas_kernels` reads
it per kernel, and `sass_census` counts a library's instructions by
kernel (``cuobjdump -sass``).  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from collections import Counter

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where `csrc/<name>.cu` builds to (hash of source, headers and
    flags)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile `csrc/<name>.cu` unless its library exists; return it."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)        # atomic: concurrent builders never see half
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]


_TYPES = {"f": "float", "d": "double", "i": "int", "j": "unsigned",
          "h": "unsigned char", "b": "bool"}


def kernel_label(mangled: str) -> str:
    """A readable name of a mangled kernel symbol: its last name and its
    integer and bool template arguments, e.g.
    ``gf_matmul_packed_kernel<8, false, 4, 16>``."""
    m = re.match(r"_ZN((?:\d+\w+?)+?)(I.*?E)?E", mangled)
    if m is None:
        return mangled
    names, pos, body = [], 0, m.group(1)
    while pos < len(body):
        digits = re.match(r"\d+", body[pos:]).group()
        pos += len(digits)
        names.append(body[pos:pos + int(digits)])
        pos += int(digits)
    args = [("false", "true")[int(v)] if kind == "b" else v or _TYPES[t]
            for kind, v, t in re.findall(r"L([ib])(\d+)E|([fdijhb])",
                                         (m.group(2) or "")[1:])]
    return names[-1] + (f"<{', '.join(args)}>" if args else "")


def ptxas_kernels(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel in an ``-Xptxas -v``
    log, by `kernel_label`."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = kernel_label(m.group(1))
            out.setdefault(name, {"registers": 0, "spill_stores": 0,
                                  "spill_loads": 0})
        elif name and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_WIDTHS = (".128", ".64", ".U8", ".S8", ".U16", ".S16")


def _opcode(op: str, mods: str, operands: str) -> list[str]:
    """The census keys of one instruction: memory instructions with their
    width (``LDG.128``, ``LDS.32``, ``LDGSTS.128`` for a cp.async), and a
    LOP3 computing a ^ (b & c) on registers alone, the form of a select
    ``acc ^= rung & mask``, also as ``LOP3.select``."""
    if op in ("LDG", "LDS", "STG", "STS", "LDGSTS"):
        return [op + next((w for w in _WIDTHS if w in mods), ".32")]
    if (op == "LOP3" and re.search(r"0x(78|6c|6a)\b", operands)
            and len(re.findall(r"0x", operands)) == 1):
        return [op, "LOP3.select"]
    return [op]


def _hot_block(body: list[tuple[int, list[str], str]]) -> Counter:
    """The census of a kernel's hottest basic block (no branch into it
    or out of it but at its ends): the one with the most selects, the
    step of a full tile, and of blocks with as many the one that reaches
    them in the fewest instructions (the step of the widest loads, not
    of byte loads).  ``instructions`` counts each instruction once."""
    targets = {int(m.group(1), 16) for _, keys, operands in body
               if keys[0] == "BRA"
               and (m := re.match(r"`?\(?0x([0-9a-f]+)", operands.strip()))}
    best, block = Counter(), Counter()
    for addr, keys, _ in body:
        if addr in targets:
            block = Counter()
        block.update(keys)
        block["instructions"] += 1
        if (block["LOP3.select"] > best["LOP3.select"]
                or block["LOP3.select"] == best["LOP3.select"] > 0
                and block["instructions"] < best["instructions"]):
            best = block.copy()
        if keys[0] in ("BRA", "EXIT", "BAR"):
            block = Counter()
    return best


def sass_census(lib: pathlib.Path) -> dict[str, tuple[Counter, Counter]]:
    """Static instruction counts of each kernel of a built library, by
    `kernel_label`, from the toolkit's ``cuobjdump -sass``: (the whole
    kernel, its hottest basic block), keyed as `_opcode` says.  Empty
    where there is no cuobjdump beside nvcc."""
    tool = pathlib.Path(nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    bodies: dict[str, list[tuple[int, list[str], str]]] = {}
    body = None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            body = bodies.setdefault(kernel_label(m.group(1)), [])
        elif body is not None and (m := _SASS_LINE.search(line)):
            addr, op, mods, operands = m.groups()
            body.append((int(addr, 16), _opcode(op, mods, operands),
                         operands))
    return {label: (Counter(k for _, keys, _ in body for k in keys),
                    _hot_block(body))
            for label, body in bodies.items()}
