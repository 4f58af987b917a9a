"""SGD / momentum / Adam / AdamW, schedule-aware.

The port of `repro.optim.optimizers`: the same float32 arithmetic in
the same order, leaf by leaf.  The learning rate is read at the step
before the increment and Adam's bias corrections are float32 powers,
as in the reference."""
from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch.core.packets import tree_map

from .base import Optimizer, OptState, tree_zeros_like

Schedule = Union[float, Callable[[int], torch.Tensor]]


def _lr_at(lr: Schedule, step: int) -> torch.Tensor:
    """The learning rate at `step`, a float32 0-d tensor on the host."""
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return OptState(step=0, slots=())

    def update(grads, state, params=None):
        eta = _lr_at(lr, state.step)
        upd = tree_map(lambda g: -eta * _f32(g), grads)
        return upd, OptState(step=state.step + 1, slots=())

    return Optimizer(init, update)


def momentum(lr: Schedule, beta: float = 0.9,
             state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return OptState(step=0, slots=tree_zeros_like(params, state_dtype))

    def update(grads, state, params=None):
        eta = _lr_at(lr, state.step)
        new_m = tree_map(
            lambda m, g: (beta * _f32(m) + _f32(g)).to(state_dtype),
            state.slots, grads)
        upd = tree_map(lambda m: -eta * _f32(m), new_m)
        return upd, OptState(step=state.step + 1, slots=new_m)

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, state_dtype=torch.float32) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0,
                 state_dtype=state_dtype)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01,
          state_dtype=torch.float32) -> Optimizer:
    """AdamW with bias correction; moments stored in `state_dtype`."""

    def init(params):
        return OptState(step=0, slots={
            "m": tree_zeros_like(params, state_dtype),
            "v": tree_zeros_like(params, state_dtype)})

    def update(grads, state, params):
        step = state.step + 1
        eta = _lr_at(lr, state.step)
        t = torch.tensor(step, dtype=torch.float32)
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t

        def upd_m(m, g):
            return (b1 * _f32(m) + (1 - b1) * _f32(g)).to(state_dtype)

        def upd_v(v, g):
            g32 = _f32(g)
            return (b2 * _f32(v) + (1 - b2) * g32 * g32).to(state_dtype)

        new_m = tree_map(upd_m, state.slots["m"], grads)
        new_v = tree_map(upd_v, state.slots["v"], grads)

        def step_fn(m, v, p):
            mhat = _f32(m) / c1
            vhat = _f32(v) / c2
            return -eta * (mhat / (torch.sqrt(vhat) + eps)
                           + weight_decay * _f32(p))

        upd = tree_map(step_fn, new_m, new_v, params)
        return upd, OptState(step=step, slots={"m": new_m, "v": new_v})

    return Optimizer(init, update)
