"""repro_torch.grid — the declarative scenario-grid runner.

The port of `repro.grid`.  FedNC's headline claims (Prop. 1
efficiency, straggler/dropout robustness, the §III hierarchy, the
security and byzantine models) are regime-dependent; this package
turns "measure everything" into a declarative matrix:

spec.py    — :class:`GridAxes` (the cartesian axes: straggler
             distribution, delay reordering, dropout, population size,
             strategy, GF kernel backend, adversary) expanded into
             frozen, picklable :class:`ScenarioSpec` records with
             stable per-scenario seeds (``crc32(name) ^ base_seed``).
execute.py — one executor per strategy family (network simulator,
             hierarchical and flat engine rounds on the port's
             kernels, async FL) and ``run_grid``'s spawn-context fan-out.
report.py  — the ``GRID_*.json`` artifact (schema ``fednc-grid-v1``,
             checked by ``scripts/check_bench.py``) and its markdown
             table.
__main__   — ``python -m repro_torch.grid`` CLI (``--smoke``: the
             10-cell smoke grid; ``--device``: ``cuda`` by default).
"""
from .execute import run_grid, run_scenario
from .report import GRID_SCHEMA, grid_document, markdown_report
from .spec import GridAxes, ScenarioSpec, scenario_seed

__all__ = [
    "GridAxes", "ScenarioSpec", "scenario_seed",
    "run_grid", "run_scenario",
    "GRID_SCHEMA", "grid_document", "markdown_report",
]
