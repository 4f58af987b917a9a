"""The port's scenario grid (`repro_torch.grid`) against the JAX
package's and the committed `GRID_smoke.json`.

`GridAxes.expand` gives the reference's names and seeds.  The port's
smoke grid runs once here, on the CPU, through the CLI into a temporary
directory: its four simulator cells must equal the committed
`GRID_smoke.json` in every field but `wall_s` and `per_stage` (numpy
and the Threefry seed expansion are shared exactly); its six engine
cells draw their coding rows from host torch generators, so they are
held to the committed file's structural fields (payload, wire bytes,
the closed-form leak probability) and to their own invariants, and the
document must pass `scripts/check_bench.py`'s `check_grid_smoke`.  One
`hier:2` cell per field size and one `async_compute` cell run too.

The executors themselves are held to the reference's value for value
on the reference's draws: its `run_scenario` runs first and records
every coding matrix, seed header and multi-edge matrix its engine
draws (and the async strategy's coding matrices); the port's run
replays them in the same order, with the reference's payload, view
seeds and CNN initialization.  Nothing is redrawn.
"""
import dataclasses
import doctest
import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rlnc as jrlnc
from repro.core.security import eavesdropper_leak_probability as jleak
from repro.grid import GridAxes as JAxes
from repro.grid import grid_document as jgrid_document
from repro.grid import markdown_report as jmarkdown
from repro.engine.engine import CodingEngine as JEngine
from repro.federation import server as jserver
from repro.grid import execute as jexecute
from repro.grid.__main__ import smoke_axes as jsmoke_axes
from repro.models import cnn as jcnn
from repro_torch.core import rlnc as trlnc
from repro_torch.core.packets import params_from_jax
from repro_torch.engine.engine import CodingEngine as TEngine
from repro_torch.grid import GridAxes, grid_document, markdown_report
from repro_torch.grid import run_grid, run_scenario, scenario_seed
from repro_torch.grid import __main__ as tcli
from repro_torch.grid import execute as texecute

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMMITTED = json.loads((ROOT / "GRID_smoke.json").read_text())["scenarios"]
SIM_CELLS = [n for n, e in COMMITTED.items()
             if e["axes"]["strategy"] != "engine"]
ENGINE_CELLS = [n for n, e in COMMITTED.items()
                if e["axes"]["strategy"] == "engine"]
#: the engine fields that do not depend on the coding draws
STRUCTURAL = ("payload_symbols", "seeded", "wire_bytes_per_packet",
              "wire_bytes_per_round", "wire_overhead_ratio",
              "leak_probability_closed_form")
PORT_KERNEL = {"jnp_packed": "cuda_packed",
               "jnp_packed_seeded": "cuda_packed_seeded"}


def _port_name(name: str) -> str:
    for ref, port in PORT_KERNEL.items():
        if name.endswith("-k" + ref) or f"-k{ref}-" in name:
            return name.replace("-k" + ref, "-k" + port)
    return name


def _check_bench():
    spec = importlib.util.spec_from_file_location(
        "check_bench_for_port", ROOT / "scripts" / "check_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The port's smoke grid through the CLI, on the CPU, run from an
    empty working directory into a separate output directory."""
    out = tmp_path_factory.mktemp("grid_out")
    cwd = tmp_path_factory.mktemp("grid_cwd")
    here = os.getcwd()
    os.chdir(cwd)
    try:
        assert tcli.main(["--smoke", "--device", "cpu", "--jobs", "1",
                          "--outdir", str(out), "--trace"]) == 0
    finally:
        os.chdir(here)
    return {"doc": json.loads((out / "GRID_torch_smoke.json").read_text()),
            "out": out, "cwd": cwd}


# ---------------------------------------------------------------------------
# axes: the reference's names and seeds
# ---------------------------------------------------------------------------

AXES = {
    "default": {},
    "sim_axes": {"strategy": ("fednc_stream", "fednc_stages", "fedavg"),
                 "straggler": ("lognormal", "pareto"),
                 "delay_spread": (0.0, 1.5), "p_dropout": (0.0, 0.1),
                 "population": (1000, 10**6)},
    "hier_async": {"strategy": ("hier:2", "hier:4", "async",
                                "async_compute"),
                   "kernel": ("cuda", "auto"),
                   "adversary": ("none", "eavesdrop:0.5", "collude:2")},
    "engine_adversaries": {"strategy": ("engine",),
                           "kernel": ("cuda_packed", "table_seeded"),
                           "adversary": ("none", "eavesdrop:0.6",
                                         "collude:3", "byzantine:0.05"),
                           "p_dropout": (0.0, 0.2), "base_seed": 11},
}


@pytest.mark.parametrize("case", sorted(AXES))
def test_expand_names_seeds_and_config_equal_reference(case):
    want, got = JAxes(**AXES[case]), GridAxes(**AXES[case])
    assert [s.name for s in got.expand()] == [s.name for s in want.expand()]
    for t, j in zip(got.expand(), want.expand(), strict=True):
        assert (t.seed, t.axes(), t.rounds, t.s, t.num_edges,
                t.compute_coupled) == (j.seed, j.axes(), j.rounds, j.s,
                                       j.num_edges, j.compute_coupled)
    assert got.config() == want.config()


def test_smoke_axes_are_the_references_with_the_ports_kernels():
    want = jsmoke_axes().config()
    want["axes"]["kernel"] = [PORT_KERNEL[k] for k in
                              want["axes"]["kernel"]]
    assert tcli.smoke_axes().config() == want
    names = [s.name for s in tcli.smoke_axes().expand()]
    assert names == [_port_name(s.name) for s in jsmoke_axes().expand()]


def test_unknown_strategy_rejected():
    with pytest.raises(ValueError, match="unknown strategy"):
        GridAxes(strategy=("nope",)).expand()


# ---------------------------------------------------------------------------
# the smoke grid on the CPU
# ---------------------------------------------------------------------------

def test_smoke_grid_has_ten_cells(smoke):
    cells = smoke["doc"]["scenarios"]
    assert len(cells) == 10 == len(COMMITTED)
    assert list(cells) == [_port_name(n) for n in COMMITTED]


@pytest.mark.parametrize("name", SIM_CELLS)
def test_smoke_sim_cell_equals_committed_grid(smoke, name):
    got = dict(smoke["doc"]["scenarios"][name])
    want = dict(COMMITTED[name])
    for key in ("wall_s", "per_stage"):
        got.pop(key)
        want.pop(key)
    assert got == want


@pytest.mark.parametrize("name", ENGINE_CELLS)
def test_smoke_engine_cell_structure_equals_committed_grid(smoke, name):
    got = smoke["doc"]["scenarios"][_port_name(name)]
    want = COMMITTED[name]
    for key in STRUCTURAL:
        assert got.get(key) == want.get(key), key
    assert set(got) == set(want)
    assert got["kernel_resolved"] == PORT_KERNEL[want["kernel_resolved"]]
    assert got["axes"]["kernel"] == PORT_KERNEL[want["axes"]["kernel"]]
    assert got["seed"] == scenario_seed(_port_name(name), 7)
    if got["axes"]["adversary"].startswith("byzantine"):
        assert got["undetected_bad_decodes"] == 0
        assert got["detection_rate"] == 1.0
    else:
        assert got["decode_rate"] == 1.0
    if got["axes"]["adversary"].startswith("eavesdrop"):
        assert got["intercepted_mean"] == got["eavesdrop_rank_mean"]
        assert got["full_leak_rate"] == 0.0


def test_smoke_grid_passes_check_grid_smoke(smoke):
    assert _check_bench().check_grid_smoke("GRID_torch_smoke.json",
                                           smoke["doc"]) == []


def test_smoke_grid_writes_only_into_its_outdir(smoke):
    assert sorted(p.name for p in smoke["out"].iterdir()) == [
        "GRID_torch_smoke.json", "GRID_torch_smoke.md",
        "TRACE_grid_torch_smoke.json"]
    assert list(smoke["cwd"].iterdir()) == []
    trace = json.loads((smoke["out"] / "TRACE_grid_torch_smoke.json")
                       .read_text())
    assert any(e.get("name") == "engine.round"
               for e in trace["traceEvents"])
    md = (smoke["out"] / "GRID_torch_smoke.md").read_text()
    assert md == markdown_report(smoke["doc"])


def test_report_renders_as_the_reference(smoke):
    doc = smoke["doc"]
    cfg = {k: v for k, v in doc["config"].items() if k != "full"}
    got = grid_document(cfg, doc["scenarios"])
    assert got == jgrid_document(cfg, doc["scenarios"])
    assert markdown_report(got) == jmarkdown(got)


# ---------------------------------------------------------------------------
# hierarchical, engine and async cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 8])
def test_hier_eavesdrop_cell_decodes_behind_the_rank_wall(s):
    spec = GridAxes(strategy=("hier:2",), kernel=("cuda",),
                    adversary=("eavesdrop:0.5",), clients_per_round=8,
                    rounds=3, s=s).expand()[0]
    entry = run_scenario(spec, device="cpu")
    assert entry["kernel_resolved"] == "cuda"
    if s == 8:                  # over GF(2) a round may miss rank K
        assert entry["decode_rate"] == 1.0
    assert entry["rank_wall_holds"] is True
    assert entry["tapped_edges_mean"] == 1.0
    assert entry["eavesdrop_rank_mean"] <= 4.0
    assert entry["payload_symbols"] == 8 * texecute.HIER_L
    assert "engine.select" in entry["per_stage"]


def test_engine_collude_cell_with_dropout():
    spec = GridAxes(strategy=("engine",), kernel=("cuda_packed",),
                    adversary=("collude:2",), p_dropout=(0.2,),
                    clients_per_round=8, rounds=3).expand()[0]
    entry = run_scenario(spec, device="cpu")
    assert entry["colluders"] == 2
    assert entry["sources_recovered_mean"] >= 2.0
    assert entry["wire_bytes_per_round"] == (8 + texecute.HIER_SPARES) * \
        entry["wire_bytes_per_packet"]
    assert entry["leak_probability_closed_form"] == jleak(
        8 + texecute.HIER_SPARES, 8 - 2, texecute.COLLUDE_INTERCEPT_P, 8)


def test_async_compute_cell_dominates_network_only():
    spec = GridAxes(strategy=("async_compute",), straggler=("pareto",),
                    clients_per_round=4, rounds=2).expand()[0]
    entry = run_scenario(spec, device="cpu")
    assert entry["decode_rate"] == 1.0
    assert entry["compute_dominates"] is True
    assert 4 <= entry["consumed_mean"] <= entry["budget"] == 12
    assert np.isfinite(entry["final_train_loss"])


def test_round_generators_are_fresh_and_derived():
    a = texecute.host_generator(7, 3)
    b = texecute.host_generator(7, 3)
    assert torch.equal(torch.randint(0, 256, (8,), generator=a),
                       torch.randint(0, 256, (8,), generator=b))
    assert texecute.derived_seed(7, 3) != texecute.derived_seed(7, 4)
    assert texecute.derived_seed(7, 3) != texecute.derived_seed(3, 7)
    assert 0 <= texecute.derived_seed(2**40, -1) < 2**32


# ---------------------------------------------------------------------------
# the executors on the reference's draws
# ---------------------------------------------------------------------------

#: (axes, the port's kernel, the reference's kernel) per executor path
REPLAY_CELLS = {
    "engine_eavesdrop_seeded": (dict(strategy=("engine",),
                                     adversary=("eavesdrop:0.6",)),
                                "cuda_packed_seeded", "jnp_packed_seeded"),
    "engine_collude_dropout": (dict(strategy=("engine",),
                                    adversary=("collude:2",),
                                    p_dropout=(0.2,)),
                               "cuda_packed", "jnp_packed"),
    "engine_byzantine": (dict(strategy=("engine",),
                              adversary=("byzantine:0.1",)),
                         "cuda_packed", "jnp_packed"),
    "hier2_eavesdrop": (dict(strategy=("hier:2",),
                             adversary=("eavesdrop:0.5",)), "cuda", "auto"),
    "async_compute": (dict(strategy=("async_compute",),
                           straggler=("pareto",)), "-", "-"),
}
#: the fields that time the run, and the kernel's name
NOT_COMPARED = ("wall_s", "per_stage", "wall_s_per_round",
                "kernel_resolved", "axes")


def _engine_recorder(draws, name):
    orig = getattr(JEngine, name)

    def record(self, *args):
        out = orig(self, *args)
        draws.append((name, np.asarray(out)))
        return out
    return record


def _engine_replayer(draws, name):
    def replay(self, *args):
        kind, rows = draws.pop(0)
        assert kind == name
        if name == "coding_seeds":
            return torch.from_numpy(rows.astype(np.int64))
        return torch.from_numpy(rows.copy())
    return replay


def _reference_view_seed(*words):
    rk = jax.random.fold_in(jax.random.PRNGKey(words[0]), words[1])
    return int(rk[0] ^ rk[1])


def _reference_payload(spec, device):
    key = jax.random.fold_in(jax.random.PRNGKey(spec.seed), 10**6)
    P = jax.random.randint(key, (spec.clients_per_round, jexecute.HIER_L),
                           0, 1 << spec.s, dtype=jnp.uint8)
    return torch.from_numpy(np.asarray(P).copy()).to(device)


def _reference_cnn(generator, **kw):
    init = jcnn.init_cnn(jax.random.PRNGKey(generator.initial_seed()), **kw)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, init),
                           device="cpu")


@pytest.mark.parametrize("case", sorted(REPLAY_CELLS))
def test_cell_metrics_equal_reference_on_its_draws(case, monkeypatch):
    axes, kernel, jkernel = REPLAY_CELLS[case]
    common = dict(clients_per_round=8, rounds=3, **axes)
    if axes["strategy"] == ("async_compute",):
        common.update(clients_per_round=4, rounds=2)
    want_spec = JAxes(kernel=(jkernel,), **common).expand()[0]
    spec = dataclasses.replace(
        GridAxes(kernel=(kernel,), **common).expand()[0],
        seed=want_spec.seed)

    # the engine cells draw through the engine's methods, the async
    # strategy through `random_coding_matrix` (which the reference's
    # engine methods call in turn, so only one of the two is recorded;
    # the reference's server imports it by name, the port's strategies
    # draw through `core.rlnc`)
    draws = []
    if spec.strategy in texecute.ASYNC_STRATEGIES:
        methods, jmodules, tmodules = (), (jrlnc, jserver), (trlnc,)
    else:
        methods = ("coding_matrix", "coding_seeds",
                   "multi_edge_coding_matrix")
        jmodules = tmodules = ()
    for name in methods:
        monkeypatch.setattr(JEngine, name, _engine_recorder(draws, name))
    jdraw = jrlnc.random_coding_matrix

    def record(key, n, k, s):
        A = jdraw(key, n, k, s)
        draws.append(("random_coding_matrix", np.asarray(A)))
        return A
    for jmod in jmodules:
        monkeypatch.setattr(jmod, "random_coding_matrix", record)
    want = jexecute.run_scenario(want_spec)
    assert draws

    for name in methods:
        monkeypatch.setattr(TEngine, name, _engine_replayer(draws, name))

    def replay(generator, n, k, s):
        kind, A = draws.pop(0)
        assert kind == "random_coding_matrix" and A.shape == (n, k)
        return torch.from_numpy(A.copy())
    for tmod in tmodules:
        monkeypatch.setattr(tmod, "random_coding_matrix", replay)
    monkeypatch.setattr(texecute, "host_generator",
                        lambda *words: torch.Generator())
    monkeypatch.setattr(texecute, "derived_seed", _reference_view_seed)
    monkeypatch.setattr(texecute, "_payload", _reference_payload)
    monkeypatch.setattr("repro_torch.models.cnn.init_cnn", _reference_cnn)
    got = run_scenario(spec, device="cpu")
    assert not draws, "the port drew fewer rows"

    assert got["axes"] == {**want["axes"], "kernel": kernel}
    if kernel != "-":
        assert got["kernel_resolved"].startswith("cuda")
    assert got.keys() == want.keys()
    for key in want:
        if key == "final_train_loss":      # two float32 Adam trainings
            assert abs(got[key] - want[key]) <= 1e-3
        elif key not in NOT_COMPARED:
            assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# devices and worker processes
# ---------------------------------------------------------------------------

def test_run_scenario_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cell runs there")
    spec = GridAxes(strategy=("fedavg",), population=(100,),
                    clients_per_round=4, rounds=1).expand()[0]
    with pytest.raises(RuntimeError, match="is_available"):
        run_scenario(spec)
    with pytest.raises(RuntimeError, match="is_available"):
        run_grid([spec])


def test_cli_without_a_card_fails_and_writes_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.grid", "--strategies", "fedavg",
         "--populations", "100", "--rounds", "1", "--jobs", "1",
         "--outdir", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, check=False)
    assert proc.returncode != 0
    assert "is_available" in proc.stderr
    assert not list((tmp_path / "out").glob("GRID_*"))


def test_run_grid_process_parallel_matches_serial():
    specs = GridAxes(strategy=("fednc_stream", "fedavg"),
                     straggler=("pareto",), population=(300,),
                     clients_per_round=8, rounds=3).expand()
    serial = run_grid(specs, jobs=1, device="cpu")
    parallel = run_grid(specs, jobs=2, device="cpu")
    assert list(parallel) == list(serial)
    for name in serial:
        for entry in (serial[name], parallel[name]):
            entry.pop("wall_s")
            entry.pop("per_stage")
        assert parallel[name] == serial[name]


# ---------------------------------------------------------------------------
# the doctests of the slice's modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", [
    "repro_torch.adversary.eavesdrop", "repro_torch.adversary.spec",
    "repro_torch.grid.spec", "repro_torch.grid.execute",
    "repro_torch.core.packets"])
def test_module_doctests_pass(module):
    result = doctest.testmod(importlib.import_module(module))
    assert result.failed == 0 and result.attempted > 0
