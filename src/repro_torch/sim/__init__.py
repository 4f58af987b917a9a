"""repro_torch.sim — the parts of the network simulator ported so far.

distributions.py — named delay distributions and the straggler
                   profiles (numpy), which `repro_torch.serve.trace`
                   and the async FL driver draw packet gaps from.
compute.py       — per-client local-training compute times for the
                   async arrival clock (`ComputeModel`).

The event simulator itself is not ported yet.
"""
from .compute import ComputeModel
from .distributions import (STRAGGLER_PROFILES, DistSpec,
                            available_distributions, register_distribution,
                            sample_delays)

__all__ = ["ComputeModel", "DistSpec", "STRAGGLER_PROFILES",
           "available_distributions", "register_distribution",
           "sample_delays"]
