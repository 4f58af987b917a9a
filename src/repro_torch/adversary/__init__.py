"""repro_torch.adversary — the paper's "Secure" claim as executable models.

The port of `repro.adversary`:

spec.py      — AdversarySpec: the grid axis value
               (``none`` / ``eavesdrop:p`` / ``collude:c`` /
               ``byzantine:b``) parsed in one place.
eavesdrop.py — EavesdropperView: a passive attacker's accumulated
               knowledge as reduced-basis state (achieved rank,
               residual entropy, sources recovered), plus edge-link
               capture for hierarchical cells.
byzantine.py — ByzantineChannel: active corruption as a RowTamper
               channel plan (flip / forge / both), replayed-seed
               batches for the stream path, and the rounds-to-recovery
               measurement against the engine's redundant-rank
               cross-check.

Closed forms live in `repro_torch.core.security`; the grid's
``adversary`` axis (`repro_torch.grid`) reports the measured
counterparts per cell.
"""
from .byzantine import (MODES, ByzantineChannel, apply_tamper,
                        replayed_seed_batch, rounds_to_recovery)
from .eavesdrop import EavesdropperView, edge_row_slices, tap_edges
from .spec import KINDS, AdversarySpec

__all__ = [
    "AdversarySpec", "KINDS", "EavesdropperView", "edge_row_slices",
    "tap_edges", "ByzantineChannel", "MODES", "apply_tamper",
    "replayed_seed_batch", "rounds_to_recovery",
]
