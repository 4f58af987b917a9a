"""Optimizer interface: pure-functional (init, update) pairs.

The port of `repro.optim.base`, on the port's trees of tensors
(`core.packets.tree_map`).  An Optimizer is a pair of closures over
hyperparameters:

    state   = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params  = apply_updates(params, updates)

States are trees matching the parameter tree plus a step counter (a
Python int: the port steps eagerly).  `torch.optim` is not used: its
Adam places ε and the bias correction differently from the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.packets import tree_flatten, tree_map


class OptState(NamedTuple):
    step: int                  # updates applied so far
    slots: Any                 # optimizer-specific tree (or ())


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[..., tuple[Any, OptState]]


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def tree_zeros_like(params: Any, dtype=None) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype,
                                          device=p.device), params)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0
    for leaf in tree_flatten(tree)[0]:
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree: Any, max_norm: float) -> Any:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda leaf: leaf * scale.to(leaf.dtype), tree)
