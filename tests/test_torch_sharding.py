"""The port's sharding rules (`launch.sharding`) against the reference's.

The rules are pure functions of a path, a shape and the mesh's axis
sizes, so the reference's production 16 x 16 topology is evaluated as
``{"data": 16, "model": 16}`` beside the reference's `AbstractMesh`:
every case of `tests/test_sharding.py`, spec for spec.  Then the rules
over the port's whole reduced trees (parameters and decode caches of
every config, per-layer lists) against the reference's over its
stacked trees on a (data 2, model 4) mesh, where the reduced widths
divide: each port layer's leaf takes the spec of its reference leaf
with the scan group axis dropped (right-aligned templates, and
`left_skip_scan`'s offset len(shape) - 3).  Last, DTensor placements on
the port's one-card mesh (gloo on the CPU) change no value.
"""
from types import SimpleNamespace

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch.sharding import tree_paths
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw

ARCHS = tconfigs.ARCHITECTURES
PROD = {"data": 16, "model": 16}
SMALL = {"data": 2, "model": 4}


@pytest.fixture(scope="module")
def J():
    """The JAX reference and its abstract meshes."""
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh
    from repro import configs as jconfigs
    from repro.launch import sharding as jsh
    from repro.models import transformer as jtf
    try:
        prod = AbstractMesh((16, 16), ("data", "model"))
        small = AbstractMesh((2, 4), ("data", "model"))
    except TypeError:
        pytest.skip("AbstractMesh unavailable")
    return SimpleNamespace(jax=jax, configs=jconfigs, sh=jsh, tf=jtf,
                           prod=prod, small=small)


def _spec(p) -> tuple:
    """A reference PartitionSpec as the port's plain tuple."""
    return tuple(p)


# ---------------------------------------------------------------------------
# the reference's cases at 16 x 16
# ---------------------------------------------------------------------------

PARAM_CASES = [
    ("decoder/scan/b0/mlp/up/w", (36, 4096, 12288)),       # generic matrix
    ("decoder/3/mlp/up/w", (4096, 12288)),                 # the port's layer
    ("attn/wq/w", (7000, 56 * 128)),                       # 7000 % 16 != 0
    ("attn/wq/w", (118, 118)),
    ("decoder/scan/b0/moe/w_gate", (59, 160, 5120, 1536)),  # experts
    ("decoder/prefix/moe/w_down", (128, 4864, 7168)),
    ("decoder/5/moe/w_up", (160, 5120, 1536)),
    ("decoder/5/moe/router/w", (5120, 160)),
    ("embed/table", (256256, 1024)),
    ("lm_head/w", (8192, 128256)),
    ("decoder/2/rglru/conv_w", (4, 4096)),
    ("decoder/2/rglru/lam", (4096,)),
    ("gate_attn", ()),                                      # scalar
    ("mlp/up/b", (12288,)),                                 # bias
]


@pytest.mark.parametrize("path, shape", PARAM_CASES)
def test_param_spec_matches_reference(J, path, shape):
    assert tsh.param_spec_for(path, shape, PROD) == _spec(
        J.sh.param_spec_for(path, shape, J.prod))


def test_the_reference_cases_by_value():
    """tests/test_sharding.py's expectations, on the port alone."""
    assert tsh.param_spec_for("decoder/scan/b0/mlp/up/w", (36, 4096, 12288),
                              PROD) == (None, "data", "model")
    assert tsh.param_spec_for("attn/wq/w", (7000, 56 * 128), PROD) == (
        None, "model")
    assert tsh.param_spec_for("attn/wq/w", (118, 118), PROD) == (None, None)
    assert tsh.param_spec_for("decoder/scan/b0/moe/w_gate",
                              (59, 160, 5120, 1536), PROD) == (
        None, "model", "data", None)
    assert tsh.param_spec_for("decoder/prefix/moe/w_down",
                              (128, 4864, 7168), PROD) == (
        "model", "data", None)
    assert tsh.param_spec_for("embed/table", (256256, 1024), PROD) == (
        "model", "data")
    assert tsh.param_spec_for("gate_attn", (), PROD) == ()
    assert tsh.param_spec_for("mlp/up/b", (12288,), PROD) == (None,)
    assert tsh.batch_spec((256, 4096), PROD) == ("data", None)
    assert tsh.batch_spec((1, 1), PROD) == (None, None)
    assert tsh.cache_spec_for("scan/b0/k", (36, 128, 32768, 8, 128),
                              PROD)[2] == "model"
    assert tsh.cache_spec_for("prefix/0/ckv", (128, 32768, 512), PROD) == (
        "data", "model", None)


@pytest.mark.parametrize("mode", ["dmodel", "dff"])
def test_moe_inner_shard_matches_reference(J, monkeypatch, mode):
    monkeypatch.setattr(J.sh, "MOE_INNER", J.sh.MOE_INNER)
    monkeypatch.setattr(tsh, "MOE_INNER", tsh.MOE_INNER)
    J.sh.set_moe_inner_shard(mode)
    tsh.set_moe_inner_shard(mode)
    for path in ("decoder/4/moe/w_gate", "decoder/4/moe/w_up",
                 "decoder/4/moe/w_down"):
        assert tsh.param_spec_for(path, (160, 5120, 1536), PROD) == _spec(
            J.sh.param_spec_for(path, (160, 5120, 1536), J.prod))
    with pytest.raises(ValueError):
        tsh.set_moe_inner_shard("rows")


@pytest.mark.parametrize("shape", [(256, 4096), (1, 1), (32, 32768, 1024),
                                   (128, 1), ()])
def test_batch_spec_matches_reference(J, shape):
    assert tsh.batch_spec(shape, PROD) == _spec(J.sh.batch_spec(shape,
                                                                J.prod))


@pytest.mark.parametrize("path, shape", [
    ("scan/b0/k", (36, 128, 32768, 8, 128)),
    ("0/k", (128, 32768, 8, 128)),
    ("prefix/0/ckv", (128, 32768, 512)),
    ("3/krope", (128, 32768, 64)),
    ("1/conv", (128, 3, 4096)),
    ("1/h", (128, 4096)),
    ("0/C", (128, 4, 384, 384)),
    ("0/n", (128, 4, 384)),
    ("0/m", (128, 4)),
    ("5/c", (128, 768)),
    ("7/cross/v", (4, 4096, 8, 128)),
    ("7/other", (4, 7)),
])
def test_cache_spec_matches_reference(J, path, shape):
    assert tsh.cache_spec_for(path, shape, PROD) == _spec(
        J.sh.cache_spec_for(path, shape, J.prod))


@pytest.mark.parametrize("ndim", [0, 1, 2, 3])
def test_coded_and_replicated_specs_match_reference(J, ndim):
    assert tsh.replicated_spec(ndim) == _spec(J.sh.replicated_spec(ndim))
    assert tsh.coded_spec(ndim, PROD) == _spec(J.sh.coded_spec(ndim, J.prod))
    assert tsh.coded_spec(ndim, {"model": 4}) == _spec(
        J.sh.coded_spec(ndim, J.jax.sharding.AbstractMesh((4,), ("model",))))


def test_vocab_padding_divides():
    for a in ARCHS:
        cfg = tconfigs.get_config(a)
        assert cfg.padded_vocab % 256 == 0
        assert cfg.padded_vocab >= cfg.vocab_size


# ---------------------------------------------------------------------------
# the port's whole reduced trees
# ---------------------------------------------------------------------------

def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _by_port_path(J, cfg, tree, spec_for, mesh) -> dict:
    """{the port's path: the reference's spec} over a reference tree of
    `cfg` (its stacks {prefix, scan, suffix} under "decoder" and
    "encoder", or a decode cache's at the root), each scan leaf once
    per group with the group axis dropped from its spec."""
    out = {}
    stacks = {"decoder": cfg}
    if cfg.encoder_layers:
        stacks["encoder"] = ttf.encoder_config(cfg)
    for path, x in J.jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [_key(k) for k in path]
        spec = _spec(spec_for("/".join(keys), tuple(x.shape), mesh))
        root = keys[0] if keys[0] in stacks else None
        part = keys[1:] if root else keys
        c = stacks[root] if root else cfg
        if part[0] not in ("prefix", "scan", "suffix"):
            out["/".join(keys)] = spec
            continue
        if keys[-1] == "pos":
            continue
        prefix, pattern, suffix = c.decoder_layer_kinds()
        head = [root] if root else []
        if part[0] == "prefix":
            layers, rest = [int(part[1])], part[2:]
        elif part[0] == "suffix":
            layers = [len(prefix) + c.n_scan_groups() * len(pattern)
                      + int(part[1])]
            rest = part[2:]
        else:
            j = int(part[1][1:])
            layers = [len(prefix) + g * len(pattern) + j
                      for g in range(c.n_scan_groups())]
            rest = part[2:]
            # the reference's rule on the leaf of one layer; a stacked
            # matrix or expert stack keeps its spec with the group axis
            # dropped (right-aligned templates, left_skip_scan's
            # offset), while a stacked vector (G, d) falls under the
            # matrix rule and shards G, an axis the port does not have
            one = _spec(spec_for("/".join(keys), tuple(x.shape[1:]), mesh))
            if x.ndim >= 3:
                assert spec[0] is None and spec[1:] == one
            spec = one
        for i in layers:
            out["/".join(head + [str(i)] + rest)] = spec
    return out


def _paths_specs(specs, prefix=""):
    """(path, spec) of a spec tree: dicts and lists whose leaves are the
    spec tuples."""
    if isinstance(specs, dict):
        items = specs.items()
    elif isinstance(specs, list):
        items = enumerate(specs)
    else:
        return [(prefix, specs)]
    out = []
    for k, v in items:
        out += _paths_specs(v, f"{prefix}/{k}" if prefix else str(k))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_over_the_ports_reduced_trees(J, arch):
    """Parameters, AdamW slots and decode caches of the reduced `arch`:
    every port leaf's spec is its reference leaf's, group axis
    dropped."""
    jcfg, tcfg = J.configs.reduced_config(arch), tconfigs.reduced_config(arch)
    jtree = J.jax.eval_shape(lambda: J.tf.init_lm(J.jax.random.PRNGKey(0),
                                                  jcfg))
    want = _by_port_path(J, jcfg, jtree, J.sh.param_spec_for, J.small)
    params = ttf.init_lm(torch.Generator().manual_seed(0), tcfg,
                         device="meta")
    got = dict(_paths_specs(tsh.param_shardings(params, SMALL)))
    assert got == want
    assert sum(s != (None,) * len(s) for s in got.values()) > 0
    opt = adamw(1e-3).init(params)
    slots = dict(_paths_specs(tsh.opt_shardings(opt, SMALL, params)))
    assert slots == {f"{m}/{p}": s for m in ("m", "v") for p, s in
                     got.items()}

    batch = {"tokens": torch.empty((6, 24), dtype=torch.long,
                                   device="meta"),
             "memory": torch.empty((6, 8, tcfg.d_model), device="meta")}
    assert tsh.batch_shardings(batch, SMALL) == {
        k: _spec(J.sh.batch_spec(tuple(v.shape), J.small))
        for k, v in batch.items()}

    B, S, M = 4, 24, 8 if tcfg.frontend else 0
    jcache = J.jax.eval_shape(lambda: J.tf.make_decoder_cache(
        jcfg, B, S, None, M))
    want = _by_port_path(J, jcfg, jcache, J.sh.cache_spec_for, J.small)
    cache = ttf.make_decoder_cache(tcfg, B, S, None, M, device="meta")
    got = {p: s for p, s in _paths_specs(tsh.cache_shardings(cache, SMALL))
           if not p.endswith("pos")}          # the int counters stay ints
    assert got == want


# ---------------------------------------------------------------------------
# placements on the one-card mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def one_card_mesh():
    mesh = tmesh.make_production_mesh(device="cpu")
    yield mesh
    tmesh.destroy_production_mesh()


def test_placements_change_no_value_on_one_card(one_card_mesh):
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    mesh = one_card_mesh
    assert tsh.to_placements(("data", "model"), mesh) == (Shard(0), Shard(1))
    assert tsh.to_placements((None, "data"), mesh) == (Shard(1), Replicate())
    assert tsh.to_placements(((("data",)), None), mesh) == (Shard(0),
                                                            Replicate())
    assert tsh.to_placements((), mesh) == (Replicate(), Replicate())
    cfg = tconfigs.reduced_config("qwen3-4b")
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = ttf.make_decoder_cache(cfg, 2, 8, None, device="cpu")
    leaves = [(p, t, tsh.param_spec_for) for p, t in tree_paths(params)] + \
        [(p, t, tsh.cache_spec_for) for p, t in tree_paths(cache)]
    for path, t, spec_for in leaves:
        placements = tsh.to_placements(spec_for(path, tuple(t.shape), mesh),
                                       mesh)
        placed = distribute_tensor(t, mesh, placements)
        assert isinstance(placed, DTensor)
        assert tuple(placed.placements) == placements
        assert torch.equal(placed.to_local(), t) and torch.equal(
            placed.full_tensor(), t)
    assert any(isinstance(p, Shard) for _, t, f in leaves
               for p in tsh.to_placements(f(_, tuple(t.shape), mesh), mesh))
