"""The port's launch tier against the JAX package, on the CPU: the shape
table and input stand-ins (`launch.specs`), the one-card mesh
(`launch.mesh`), the roofline terms and the step counter
(`launch.roofline`), the dry run's plans (`launch.dryrun`), and the
serve entry point (`launch.serve`, in a subprocess).

Nothing here traces a full-size configuration: full widths are built on
the meta device for their parameter counts and input shapes only, and
every traced step is a reduced config (or a few layers) on the meta
device or the CPU.  The counter's FLOPs are held to a hand sum of the
step's matmuls plus flash's closed form (`flash_flops`: S(S+1)/2 live
pairs when causal), on the CPU and on meta alike.
"""
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as trl
from repro_torch.launch import specs as tsp
from repro_torch.launch.sharding import tree_paths
from repro_torch.models import transformer as ttf

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = tconfigs.ARCHITECTURES


@pytest.fixture(scope="module")
def J():
    """The JAX reference, imported here and not at module level."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.launch import roofline as jrl
    from repro.launch import specs as jsp
    from repro.models import transformer as jtf
    return SimpleNamespace(jax=jax, configs=jconfigs, sp=jsp, rl=jrl, tf=jtf)


@pytest.fixture
def one_card_mesh():
    mesh = tmesh.make_production_mesh(device="cpu")
    yield mesh
    tmesh.destroy_production_mesh()


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def test_shapes_table_matches_reference(J):
    assert list(tsp.SHAPES) == list(J.sp.SHAPES)
    for name, spec in tsp.SHAPES.items():
        want = J.sp.SHAPES[name]
        assert (spec.name, spec.kind, spec.seq_len, spec.global_batch) == (
            want.name, want.kind, want.seq_len, want.global_batch)
    assert tsp.SHAPES["train_4k"] == tsp.ShapeSpec("train_4k", "train",
                                                   4096, 256)
    assert tsp.SHAPES["prefill_32k"].global_batch == 32
    assert tsp.SHAPES["decode_32k"].global_batch == 128
    assert (tsp.SHAPES["long_500k"].seq_len,
            tsp.SHAPES["long_500k"].global_batch) == (524288, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_window_and_batch_inputs_match_reference(J, arch):
    """decode_window, needs_memory, memory_len and batch_inputs' shapes
    for every shape of `arch`; the stand-ins live on the meta device."""
    tcfg, jcfg = tconfigs.get_config(arch), J.configs.get_config(arch)
    for name, shape in tsp.SHAPES.items():
        jshape = J.sp.SHAPES[name]
        assert tsp.decode_window(tcfg, shape) == \
            J.sp.decode_window(jcfg, jshape)
        assert tsp.needs_memory(tcfg) == J.sp.needs_memory(jcfg)
        assert tsp.memory_len(tcfg, shape) == J.sp.memory_len(jcfg, jshape)
        got = tsp.batch_inputs(tcfg, shape)
        want = J.sp.batch_inputs(jcfg, jshape)
        assert sorted(got) == sorted(want)
        for key in got:
            assert tuple(got[key].shape) == tuple(want[key].shape), key
            assert got[key].device.type == "meta"
        if "memory" in got:
            assert got["memory"].dtype == tcfg.dtype


def _unstacked_shapes(cfg, tree) -> list:
    """The reference's {prefix, scan, suffix} tree of ShapeDtypeStructs
    as per-layer (path, shape) lists in the port's layer order, the scan
    group axis dropped (as `lm_params_from_jax` unstacks it)."""
    import jax

    def leaves(sub):
        return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path), tuple(x.shape))
                for path, x in jax.tree_util.tree_flatten_with_path(sub)[0]]

    prefix, pattern, suffix = cfg.decoder_layer_kinds()
    layers = [leaves(c) for c in tree["prefix"]]
    for _ in range(cfg.n_scan_groups()):
        layers += [[(p, s[1:]) for p, s in leaves(tree["scan"][f"b{j}"])]
                   for j in range(len(pattern))]
    return layers + [leaves(c) for c in tree["suffix"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_inputs_cache_shapes_match_reference(J, arch):
    """Every decode shape: the port's per-layer caches (built by
    `make_decoder_cache` on meta) have the reference's leaves and
    shapes (its "pos" counters are ints in the port), the token
    (B, 1)."""
    tcfg, jcfg = tconfigs.get_config(arch), J.configs.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        got = tsp.decode_inputs(tcfg, tsp.SHAPES[name])
        want = J.sp.decode_inputs(jcfg, J.sp.SHAPES[name])
        assert tuple(got["token"].shape) == tuple(want["token"].shape)
        want_layers = _unstacked_shapes(jcfg, want["cache"])
        assert len(got["cache"]) == len(want_layers) == tcfg.num_layers
        for layer, ref in zip(got["cache"], want_layers, strict=True):
            mine = sorted((p, tuple(t.shape)) for p, t in tree_paths(layer))
            assert mine == sorted((p, s) for p, s in ref
                                  if not p.endswith("pos")), (arch, name)
            assert all(t.device.type == "meta" for _, t in tree_paths(layer))
    # a full-attention arch keeps a full cache at 32k, its long-context
    # window at 500k (as the reference's test_decode_inputs_cache_shapes)
    if arch == "qwen3_8b":
        c32 = tsp.decode_inputs(tcfg, tsp.SHAPES["decode_32k"])["cache"]
        c500 = tsp.decode_inputs(tcfg, tsp.SHAPES["long_500k"])["cache"]
        assert c32[0]["k"].shape[1] == 32768
        assert c500[0]["k"].shape[1] == tcfg.long_context_window


# ---------------------------------------------------------------------------
# parameter counts (dryrun)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference(J, arch):
    """count_params and count_active_params of the port's full-size
    tree (on meta) equal the reference's over its `eval_shape`."""
    jcfg, tcfg = J.configs.get_config(arch), tconfigs.get_config(arch)
    shapes = J.jax.eval_shape(
        lambda: J.tf.init_lm(J.jax.random.PRNGKey(0), jcfg))
    flat = J.jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = sum(int(np.prod(x.shape)) for _, x in flat)
    active = 0.0
    for path, x in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        n = float(np.prod(x.shape))
        if jcfg.moe is not None and "moe/w_" in name:
            n *= jcfg.moe.top_k / jcfg.moe.num_experts
        active += n
    params = tdr.init_params(tcfg)
    assert tdr.count_params(params) == want
    assert tdr.count_active_params(params, tcfg) == int(active)


def test_arctic_param_count_and_active_fraction():
    cfg = tconfigs.get_config("arctic-480b")
    params = tdr.init_params(cfg)
    total = tdr.count_params(params)
    active = tdr.count_active_params(params, cfg)
    assert total > 4e11                  # ~480B
    assert active < total * 0.1          # top-2 of 128 experts


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_production_mesh_is_one_card(one_card_mesh):
    import torch.distributed as dist
    assert one_card_mesh.mesh_dim_names == ("data", "model")
    assert tmesh.axis_sizes(one_card_mesh) == {"data": 1, "model": 1}
    assert tmesh.batch_axes(one_card_mesh) == ("data",)
    assert tmesh.num_clients(one_card_mesh) == 1
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    # a second request reuses the running group
    assert tmesh.make_production_mesh(device="cpu").mesh_dim_names == (
        "data", "model")


def test_mesh_helpers_keep_the_reference_meaning():
    pod = {"pod": 2, "data": 16, "model": 16}
    assert tmesh.batch_axes(pod) == ("pod", "data")
    assert tmesh.num_clients(pod) == 32
    assert tmesh.num_clients({"data": 16, "model": 16}) == 16
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW) == (989.4e12, 3.35e12)
    assert tmesh.HBM_BYTES == 85_899_345_920


@pytest.mark.parametrize("make", [
    lambda: tmesh.make_production_mesh(multi_pod=True, device="cpu"),
    lambda: tmesh.make_mesh(2, 1, device="cpu"),
    lambda: tmesh.make_mesh(1, 16, device="cpu"),
])
def test_mesh_refuses_more_than_one_card(make):
    import torch.distributed as dist
    with pytest.raises(ValueError, match="runs on one card"):
        make()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_roofline_terms_and_model_flops_h100():
    t = trl.roofline_terms(1e15, 1e9, 1e12)
    assert t["bottleneck"] == "collective"
    assert t["compute_s"] == pytest.approx(1e15 / 989.4e12)
    assert t["memory_s"] == pytest.approx(1e9 / 3.35e12)
    assert t["collective_s"] == pytest.approx(1e12 / 450e9)
    assert trl.roofline_terms(1e15, 1e9, 0.0)["bottleneck"] == "compute"
    assert trl.roofline_terms(1e9, 1e12, 0.0)["bottleneck"] == "memory"
    assert trl.model_flops(1e9, 1e6, training=True) == 6e15
    assert trl.model_flops(1e9, 1e6, training=False) == 2e15
    assert trl.collective_bytes(1000, 1, "fednc_naive") == 0.0
    assert trl.collective_bytes(1000, 4, "fednc_naive") == 3000.0
    assert trl.collective_bytes(1000, 4, "fednc_blocked") == 1500.0


def test_flash_flops_closed_form():
    """Phase 7's flash shape (B 4, S 2,048, H 32, hd 128): the causal
    half, S(S+1)/2 live pairs, is 137.5 GFLOP (PERF.md §6's bound); the
    counter sees one op of that count on the CPU and on meta."""
    assert tfa.flash_flops(4, 2048, 32, 128, True) == 137_506_062_336
    assert tfa.flash_flops(1, 256, 2, 64, False) == 4 * 2 * 256 * 256 * 64
    for device in ("cpu", "meta"):
        q = torch.zeros((1, 40, 4, 32), device=device)
        k = torch.zeros((1, 40, 2, 32), device=device)
        ana, out = trl.analyze_step(
            lambda: tfa.flash_attention(q, k, k), device)
        assert out.shape == q.shape and out.device.type == device
        assert ana.flops == tfa.flash_flops(1, 40, 4, 32, True)
        assert ana.n_ops == 1
    assert tfa.flash_attention.launches == 0


def _prefill_matmul_flops(cfg, B, S) -> int:
    """The reduced Qwen3 prefill's matmuls by hand: q, k, v, o and the
    SwiGLU MLP per layer over B·S tokens, flash's closed form, and the
    LM head on the last position."""
    d, H, KV, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.d_ff)
    T = B * S
    layer = 2 * T * d * (H * hd + 2 * KV * hd) + 2 * T * H * hd * d \
        + 3 * 2 * T * d * ff + tfa.flash_flops(B, S, H, hd, True)
    return cfg.num_layers * layer + 2 * B * d * cfg.padded_vocab


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_flops_equal_the_hand_sum(device):
    cfg = tconfigs.reduced_config("qwen3-4b")
    assert cfg.resolved_head_dim in tfa.HEAD_DIMS and not cfg.tie_embeddings
    B, S = 2, 48
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg,
                         device=device)
    tokens = torch.zeros((B, S), dtype=torch.long, device=device)
    from repro_torch.launch.steps import make_prefill_step
    step = make_prefill_step(cfg, cache_len=S + 4)
    ana, (logits, cache) = trl.analyze_step(
        lambda: step(params, {"tokens": tokens}), device)
    assert ana.flops == _prefill_matmul_flops(cfg, B, S)
    assert logits.shape == (B, 1, cfg.padded_vocab)
    # what the step hands back is still alive: the caches and the logits
    assert ana.end_bytes == sum(
        trl.tensor_bytes(t) for _, t in tree_paths(cache)) + \
        trl.tensor_bytes(logits)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_bytes_and_peak_on_a_toy(device):
    """y = x @ w, then z = y + 1 with y dropped: the bytes are the
    operands and results of both ops, a view adds none, and the live
    peak is y and z together (x and w are arguments, not counted)."""
    x = torch.ones((64, 32), device=device)
    w = torch.ones((32, 16), device=device)

    def run():
        y = x @ w.t().t()                  # two views: no bytes
        z = y + 1
        del y
        return z

    ana, z = trl.analyze_step(run, device)
    nb = 4 * (64 * 32 + 32 * 16 + 64 * 16)          # x, w, y
    assert ana.eager_bytes == nb + 4 * 2 * 64 * 16  # + (y, z)
    assert ana.write_bytes == 0
    assert ana.flops == 2 * 64 * 32 * 16
    assert ana.n_ops == 2
    assert ana.peak_bytes == 2 * 4 * 64 * 16
    assert ana.end_bytes == 4 * 64 * 16


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_floor_bytes_read_arguments_once_and_write_once(device):
    """A toy decode: three passes over x and an in-place write of one
    slot, twice, into a cache.  The eager bytes count every pass; the
    floor reads x and the cache once, writes the slot once and the
    result once, and the in-place write makes no new storage."""
    x = torch.ones((64, 32), device=device)
    cache = torch.zeros((4, 8, 32), device=device)

    def run():
        y = (x * 2).float() + 1             # two passes over (64, 32)
        cache[:, 3:4].copy_(y[:4, None])    # one slot: 4 x 32 floats
        cache[:, 3:4].copy_(y[4:8, None])   # the same slot again
        return y.sum(0)

    ana, out = trl.analyze_step(run, device)
    slot = 4 * 4 * 32
    assert ana.write_bytes == 2 * slot
    assert ana.end_bytes == trl.tensor_bytes(out) == 4 * 32
    args = trl.tensor_bytes(x) + trl.tensor_bytes(cache)
    assert trl.floor_bytes(args, ana) == args + 2 * slot + 4 * 32
    assert ana.eager_bytes > 3 * trl.tensor_bytes(x)


def test_floor_of_a_decode_is_its_arguments_and_its_cache_slots():
    """The reduced Qwen3-4B's serve step: the floor is the parameters,
    the cache and the token read once, plus each layer's k and v slot
    and the logits written once; the bound divides by the floor, not by
    the eager bytes."""
    cfg = tconfigs.reduced_config("qwen3-4b")
    B, S = 3, 40
    plan = tdr.plan_step(cfg, tdr.init_params(cfg), "decode", B, S,
                         cache_len=S)
    ta, mp, r = plan["trace_analysis"], plan["memory_plan"], plan["roofline"]
    elem = torch.empty((), dtype=cfg.dtype).element_size()
    slots = cfg.num_layers * 2 * B * cfg.num_kv_heads * \
        cfg.resolved_head_dim * elem
    assert ta["write_bytes_per_device"] == slots
    assert ta["floor_bytes_per_device"] == \
        mp["argument_bytes"] + slots + mp["output_bytes"]
    assert ta["eager_bytes_per_device"] > ta["floor_bytes_per_device"]
    assert r["memory_s"] == ta["floor_bytes_per_device"] / tmesh.HBM_BW
    assert r["eager_memory_s"] == ta["eager_bytes_per_device"] / tmesh.HBM_BW
    assert tdr.bound_s(plan) == max(r["compute_s"], r["memory_s"])


# ---------------------------------------------------------------------------
# dry run
# ---------------------------------------------------------------------------

def test_memory_plan_argument_bytes_are_params_and_caches():
    """A decode plan's argument bytes are exactly the parameters' and
    the caches' bytes (and the token's), on the reduced DeepSeek-V2
    (MLA's latent cache, MoE) and the CPU tree of the same config."""
    cfg = tconfigs.reduced_config("deepseek-v2-236b")
    plan = tdr.plan_step(cfg, tdr.init_params(cfg), "decode", 3, 40,
                         cache_len=40)
    mp = plan["memory_plan"]
    cpu = ttf.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = ttf.make_decoder_cache(cfg, 3, 40, None, device="cpu")
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_paths(cpu))
    cache_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_paths(cache))
    assert mp["param_bytes"] == param_bytes
    assert mp["cache_bytes"] == cache_bytes
    assert mp["argument_bytes"] == param_bytes + cache_bytes + 3 * 8
    assert mp["peak_bytes"] == mp["argument_bytes"] + mp["step_peak_bytes"]
    assert mp["limit_bytes"] == tmesh.HBM_BYTES and mp["fits"]
    assert plan["tokens"] == 3


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_depth_extension_equals_a_whole_trace(kind):
    """Traces at 2 and 3 groups extended to 5 equal a trace of all 5
    layers: FLOPs, bytes, ops and the step's own peak (the reduced
    Qwen3-4B at 5 layers)."""
    cfg = tconfigs.reduced_config("qwen3-4b").with_overrides(num_layers=5)
    kw = dict(cache_len=36, clients=2, agg_mode="fednc_blocked")
    whole, _ = tdr.trace_step(cfg, tdr.init_params(cfg), kind, 4, 32, **kw)
    a, b = (tdr.trace_step(tdr.depth_config(cfg, g),
                           tdr.init_params(tdr.depth_config(cfg, g)), kind,
                           4, 32, **kw)[0] for g in (2, 3))
    got = tdr.extend(a, b, 2)
    for key in ("flops", "eager_bytes", "write_bytes", "n_ops", "peak_bytes",
                "end_bytes"):
        assert getattr(got, key) == getattr(whole, key), key


def test_dryrun_cli_writes_a_record(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert tdr.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                     "--out", str(out)]) == 0
    assert "[OK] qwen3-4b x decode_32k (1x1)" in capsys.readouterr().out
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "1x1"
    assert rec["planned_by"].startswith("depth: traced at 2 and 3 of 36")
    for key in ("n_params", "n_active_params", "trace_analysis",
                "roofline", "model_flops", "useful_flops_ratio",
                "memory_plan", "bound_s"):
        assert key in rec, key
    mp = rec["memory_plan"]
    # 36 layers x 2 x (128, 32,768, 8, 128) bf16: the cache alone is ~618 GB
    assert mp["cache_bytes"] == 36 * 2 * 128 * 32768 * 8 * 128 * 2
    assert not mp["fits"]


@pytest.mark.parametrize("flag, match", [
    ("--multi-pod", "runs on one card"),
    ("--keep-hlo", "compiles no HLO"),
    ("--moe-act-shard", "TPU-mesh knob"),
    ("--grad-kshard", "TPU mesh"),
    ("--attn-bf16", "deliberate non-port"),
])
def test_dryrun_refuses_the_tpu_mesh_flags(tmp_path, flag, match):
    with pytest.raises(ValueError, match=match):
        tdr.main(["--arch", "qwen3-4b", "--shape", "decode_32k", flag,
                  "--out", str(tmp_path / "x.json")])


def test_dryrun_refuses_dff_expert_sharding(tmp_path):
    with pytest.raises(ValueError, match="not sharded on one card"):
        tdr.main(["--arch", "arctic-480b", "--shape", "decode_32k",
                  "--moe-shard", "dff", "--out", str(tmp_path / "x.json")])


# ---------------------------------------------------------------------------
# serve entry point
# ---------------------------------------------------------------------------

def _run_cli(args, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, *args], text=True,
                          capture_output=True, timeout=timeout, cwd=ROOT,
                          env=env)


def test_serve_entry_point_help_and_a_tiny_trace(tmp_path):
    proc = _run_cli(["-m", "repro_torch.launch.serve", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--jobs" in proc.stdout and "--sequential" in proc.stdout
    out = tmp_path / "report.json"
    proc = _run_cli(["-m", "repro_torch.launch.serve", "--device", "cpu",
                     "--jobs", "4", "--K", "4", "--L", "16", "--slots", "2",
                     "--g-tick", "3", "--json", str(out)])
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    assert doc["completed"] == 4 and doc["mode"] == "batched"
    assert len(doc["completions"]) == 4
