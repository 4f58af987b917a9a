"""repro_torch.adversary — the paper's "Secure" claim, active side.

byzantine.py — ByzantineChannel: active corruption as a RowTamper
               channel plan (flip / forge / both) with its stage-wise
               oracle, `apply_tamper`, and `rounds_to_recovery` against
               the engine's redundant-rank cross-check.

The port of `repro.adversary.byzantine`; the eavesdropper views and
replayed-seed batches (which need `StreamDecoder`) are not ported yet.
"""
from .byzantine import MODES, ByzantineChannel, apply_tamper, rounds_to_recovery

__all__ = ["ByzantineChannel", "MODES", "apply_tamper", "rounds_to_recovery"]
