"""repro_torch.sim — the parts of the network simulator ported so far.

distributions.py — named delay distributions and the straggler
                   profiles (numpy), which `repro_torch.serve.trace`
                   draws packet gaps from.  The event simulator itself
                   is not ported yet.
"""
from .distributions import (STRAGGLER_PROFILES, DistSpec,
                            available_distributions, register_distribution,
                            sample_delays)

__all__ = ["DistSpec", "STRAGGLER_PROFILES", "available_distributions",
           "register_distribution", "sample_delays"]
