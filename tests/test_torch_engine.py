"""repro_torch.engine against repro.engine on the same inputs.

Coding matrices, seeds and payloads are drawn with numpy and handed to
both engines (`jax.random` and `torch.Generator` never have to agree);
channels are built twice from the same seed, so both engines see the
same erasure or blind-box plan.  Everything compared is GF data:
byte-exact, with equal ok flags, channel reports and dispatch counts.
"""
import ast
import os
import pathlib
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jchannel
from repro.core import seeds as jseeds
from repro.engine import CodingEngine as JEngine
from repro.engine import EngineConfig as JConfig
from repro.engine.select import incremental_select as j_select
from repro_torch.core import channel as tchannel
from repro_torch.core import seeds as tseeds
from repro_torch.core.rlnc import SeededBatch
from repro_torch.engine import (CodingEngine, EngineConfig,
                                available_kernels, get_engine,
                                incremental_select, is_seeded_kernel,
                                materialized_kernel_name, register_kernel,
                                resolve_kernel,
                                resolve_kernel_name, seeded_kernel_name)
from repro_torch.kernels import gf_matmul as tgm

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def _with_dependent_rows(rng, n, K, s):
    A = rng.integers(0, 1 << s, (n, K)).astype(np.uint8)
    if n > 2:
        A[1] = A[0]                   # a repeat
        A[2] = 0                      # a zero row
    if n > 4:
        A[4] = A[3] ^ A[0]            # a sum: dependent over GF(2^s)
    return A


@pytest.mark.parametrize("s", [2, 8])
@pytest.mark.parametrize("n,K", [(3, 3), (8, 5), (12, 8), (4, 6)])
def test_incremental_select_matches_reference(s, n, K):
    rng = np.random.default_rng(n * 31 + K + s)
    for trial in range(3):
        A = _with_dependent_rows(rng, n, K, s)
        ok_r, idx_r, count_r = j_select(jnp.asarray(A), s)
        ok_t, idx_t, count_t = incremental_select(_t(A), s)
        assert (ok_t, count_t) == (bool(ok_r), int(count_r)), trial
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))


# ---------------------------------------------------------------------------
# the fused round: _run_round parity per channel kind
# ---------------------------------------------------------------------------

CHANNELS = {
    "ideal": None,
    "erasure": ("ErasureChannel", (0.25,), 3),
    "erasure_lossy": ("ErasureChannel", (0.7,), 0),   # too few arrive
    "blindbox": ("BlindBoxChannel", (9,), 4),
}


def _channel(pkg, spec):
    if spec is None:
        return None
    name, args, seed = spec
    return getattr(pkg, name)(*args, seed=seed)


def _report(r):
    return None if r is None else (r.sent, r.delivered, bool(r.decodable),
                                   r.distinct_sources)


@pytest.mark.parametrize("chunk_l", [0, 64])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("chan", list(CHANNELS))
def test_run_round_matches_reference(chan, seeded, chunk_l):
    K, n, L, s = 5, 8, 301, 8
    rng = np.random.default_rng(zlib.crc32(repr((chan, seeded, chunk_l))
                                           .encode()))
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    seeds[1] = seeds[0]                       # a dependent (repeated) row
    if seeded:
        A = np.asarray(jseeds.expand_rows(jnp.asarray(seeds), K, s))
    else:
        A = _with_dependent_rows(rng, n, K, s)
    kernel = "auto_seeded" if seeded else "auto"
    jeng = JEngine(JConfig(s=s, kernel=kernel, chunk_l=chunk_l))
    teng = CodingEngine(EngineConfig(s=s, kernel=kernel, chunk_l=chunk_l),
                        device="cpu")
    d0 = jeng.dispatch_count
    want = jeng._run_round(jnp.asarray(P), jnp.asarray(A),
                           _channel(jchannel, CHANNELS[chan]),
                           seeds=jnp.asarray(seeds) if seeded else None)
    got = teng._run_round(_t(P), _t(A), _channel(tchannel, CHANNELS[chan]),
                          seeds=tseeds.as_seeds(seeds) if seeded else None)
    assert got.ok == bool(want.ok)
    assert _report(got.report) == _report(want.report)
    assert teng.dispatch_count == jeng.dispatch_count - d0
    if want.ok:
        np.testing.assert_array_equal(got.packets.numpy(),
                                      np.asarray(want.packets))
        np.testing.assert_array_equal(got.packets.numpy(), P)
    else:
        assert got.packets is None


@pytest.mark.parametrize("seeded", [False, True])
def test_encode_decode_match_reference(seeded):
    K, n, L, s = 4, 6, 97, 4
    rng = np.random.default_rng(21 + seeded)
    P = rng.integers(0, 1 << s, (K, L)).astype(np.uint8)
    jeng = JEngine(JConfig(s=s, kernel="auto", chunk_l=32))
    teng = CodingEngine(EngineConfig(s=s, kernel="auto", chunk_l=32),
                        device="cpu")
    if seeded:
        rows = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        jb = jeng.encode(jnp.asarray(P), jnp.asarray(rows))
        tb = teng.encode(_t(P), tseeds.as_seeds(rows))
        assert isinstance(tb, SeededBatch) and tb.K == K
    else:
        rows = rng.integers(0, 1 << s, (n, K)).astype(np.uint8)
        jb = jeng.encode(jnp.asarray(P), jnp.asarray(rows))
        tb = teng.encode(_t(P), _t(rows))
    np.testing.assert_array_equal(tb.C.numpy(), np.asarray(jb.C))
    keep = np.array([5, 0, 3, 2, 4])                 # one tuple erased
    ok_r, P_r = jeng.decode(jb[jnp.asarray(keep)])
    ok_t, P_t = teng.decode(tb[torch.as_tensor(keep)])
    assert ok_t == bool(ok_r) and ok_t
    np.testing.assert_array_equal(P_t.numpy(), np.asarray(P_r))
    np.testing.assert_array_equal(P_t.numpy(), P)


@pytest.mark.parametrize("kernel", ["auto", "auto_seeded", "table",
                                    "table_seeded"])
def test_round_recovers_packets_on_cpu(kernel):
    g = torch.Generator().manual_seed(5)
    P = torch.randint(0, 256, (6, 1000), generator=g, dtype=torch.uint8)
    eng = CodingEngine(EngineConfig(kernel=kernel, chunk_l=256,
                                    extra_tuples=2), device="cpu")
    out = eng.round(P, g, channel=tchannel.ErasureChannel(0.1, seed=1))
    assert out.ok and torch.equal(out.packets, P)
    assert eng.dispatch_count == 2 * 4            # 4 chunks, encode + decode


# ---------------------------------------------------------------------------
# registry and devices
# ---------------------------------------------------------------------------

def test_aliases_resolve_by_engine_device():
    """`auto`/`auto_seeded` name the CUDA kernels whatever the engine's
    device; their wrappers pick the plain version for CPU tensors."""
    assert resolve_kernel_name("auto") == "cuda_packed"
    assert resolve_kernel_name("auto_seeded") == "cuda_packed_seeded"
    assert resolve_kernel("auto")[1] is tgm.gf_matmul_packed
    assert resolve_kernel("auto_seeded")[1] is tgm.gf_matmul_packed_seeded
    assert is_seeded_kernel("auto_seeded") and not is_seeded_kernel("auto")
    assert seeded_kernel_name("cuda_packed") == "cuda_packed_seeded"
    assert materialized_kernel_name("cuda_packed_seeded") == "cuda_packed"
    assert seeded_kernel_name("table") == "table_seeded"
    assert seeded_kernel_name("cuda") == "table_seeded"
    assert set(available_kernels()) == {
        "table", "clmul", "cuda", "cuda_packed", "table_seeded",
        "cuda_packed_seeded", "auto", "auto_seeded"}
    eng = CodingEngine(EngineConfig(kernel="auto_seeded"), device="cpu")
    assert eng.seeded and eng.kernel_name == "cuda_packed_seeded"
    assert eng._seed_kernel is tgm.gf_matmul_packed_seeded
    assert eng._mat_kernel is tgm.gf_matmul_packed
    assert get_engine(EngineConfig(), "cpu") is get_engine(EngineConfig(),
                                                           "cpu")


@pytest.mark.parametrize("s", [1, 8])
def test_registry_cuda_and_clmul_equal_table(s):
    """`cuda` (the XOR kernel at s=1, the clmul kernel above) and
    `clmul` compute the table oracle's product, also into `out=`."""
    rng = np.random.default_rng(30 + s)
    A = _t(rng.integers(0, 1 << s, (6, 5)).astype(np.uint8))
    P = _t(rng.integers(0, 1 << s, (5, 203)).astype(np.uint8))
    want = resolve_kernel("table")[1](A, P, s=s)
    for name in ("cuda", "clmul"):
        fn = resolve_kernel(name)[1]
        assert torch.equal(fn(A, P, s=s), want), name
        wide = torch.zeros((6, 210), dtype=torch.uint8)
        fn(A, P, s=s, out=wide[:, 4:207])
        assert torch.equal(wide[:, 4:207], want), name
        assert not wide[:, :4].any() and not wide[:, 207:].any(), name
    eng = CodingEngine(EngineConfig(s=s, kernel="cuda", chunk_l=64),
                       device="cpu")
    assert eng._seed_kernel is resolve_kernel("table_seeded")[1]
    out = eng.round(P, torch.Generator().manual_seed(1))
    assert out.ok and torch.equal(out.packets, P)


def test_register_kernel_guards():
    with pytest.raises(ValueError, match="reserved alias"):
        register_kernel("auto", tgm.gf_matmul_packed)
    with pytest.raises(ValueError, match="already registered"):
        register_kernel("cuda_packed", tgm.gf_matmul_packed)
    with pytest.raises(ValueError, match="unknown kernel"):
        resolve_kernel("pallas_packed")


def test_cuda_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine is built, not refused")
    with pytest.raises(RuntimeError, match="is_available"):
        CodingEngine(EngineConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        CodingEngine(EngineConfig())              # the default is the card


def test_engine_refuses_payload_on_another_device():
    eng = CodingEngine(EngineConfig(), device="cpu")
    P = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="engine on"):
        eng.matmul(torch.eye(2, dtype=torch.uint8), P)


# ---------------------------------------------------------------------------
# import isolation: the port never reaches JAX or the JAX package
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro_in_a_subprocess():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch.kernels\n"       # the order that once cycled
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print(sum(m.startswith('repro_torch.') for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=False)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 74        # every module was imported


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro"}, f
