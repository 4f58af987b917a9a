"""FedNC core in PyTorch: the field, seeds, packets, coding, channels.

`fednc` (the Alg.-1 round over the engine) is imported as
``repro_torch.core.fednc``; it is left out here because it reaches into
`repro_torch.engine`, which imports these leaves.
"""
from . import channel, gf, packets, rlnc, seeds
from .gf import ge_solve, get_field, invert, rank
from .rlnc import EncodedBatch, SeededBatch

__all__ = [
    "channel", "gf", "packets", "rlnc", "seeds",
    "get_field", "ge_solve", "invert", "rank",
    "EncodedBatch", "SeededBatch",
]
