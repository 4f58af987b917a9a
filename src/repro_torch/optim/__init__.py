"""Native optimizers (no torch.optim): SGD, momentum, Adam, AdamW.

The port of `repro.optim`, functional on the port's parameter trees."""
from .base import (Optimizer, OptState, apply_updates, clip_by_global_norm,
                   global_norm, tree_zeros_like)
from .optimizers import adam, adamw, momentum, sgd
from .schedule import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "Optimizer", "OptState", "apply_updates", "tree_zeros_like",
    "global_norm", "clip_by_global_norm", "adam", "adamw", "momentum",
    "sgd", "constant", "cosine_decay", "linear_warmup_cosine",
]
