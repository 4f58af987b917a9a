"""Client-side local training (paper: local_train(w, D_k), 5 epochs).

The port of `repro.federation.client`.  Model-agnostic: the trainer
runs an eager step over a user-supplied ``loss_fn(params, batch) ->
(loss, aux)`` — autograd for the gradients, then the port's functional
optimizer — for E local epochs over the client's partition, on
`device`.  Convolutions and matmuls run in full float32 inside the
step (`models.cnn.float32_products`), as the reference's do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable

import torch

from repro_torch.core.packets import tree_flatten, tree_map, tree_unflatten
from repro_torch.models.cnn import float32_products
from repro_torch.optim import Optimizer, apply_updates


def _to_device(batch, device) -> tuple:
    """A batch of numpy arrays (or tensors) as tensors on `device`."""
    return tuple(torch.as_tensor(b, device=device) for b in batch)


@dataclass
class LocalTrainer:
    """loss_fn(params, batch) -> (loss, aux).  If `state_merge` is set,
    it is called as state_merge(params, aux) after every optimizer step
    — this is how non-gradient state (e.g. the CNN's BatchNorm running
    statistics) flows back into the client parameters so that FedNC
    packets carry it."""

    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, Any]]
    optimizer: Optimizer
    local_epochs: int = 5
    state_merge: Callable[[Any, Any], Any] = None
    device: Any = "cuda"

    def step(self, params: Any, opt_state, batch
             ) -> tuple[Any, Any, torch.Tensor]:
        """One optimizer step on one batch (already on the device):
        (params, opt_state, loss).  Every leaf gets a gradient; a leaf
        the loss does not use (BN running stats) gets zeros."""
        leaves, treedef = tree_flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        with float32_products():
            loss, aux = self.loss_fn(tree_unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            leaves = [x.detach() for x in leaves]
            grads = tree_unflatten(treedef, [
                torch.zeros_like(x) if g is None else g
                for x, g in zip(leaves, grads, strict=True)])
            params = tree_unflatten(treedef, leaves)
            updates, opt_state = self.optimizer.update(grads, opt_state,
                                                       params)
            params = apply_updates(params, updates)
            if self.state_merge is not None:
                # aux was computed from the grad-tracking leaves
                params = tree_map(torch.Tensor.detach,
                                  self.state_merge(params, aux))
        return params, opt_state, loss.detach()

    def train(self, params: Any, batch_iter: Iterable) -> tuple[Any, float]:
        """Run local epochs; returns (new_params, mean_loss).

        `batch_iter` must already encode the epoch count (see
        data.synthetic.batches(epochs=...)); fresh optimizer state per
        round, as in FedAvg.  The losses are read back once, at the
        end."""
        opt_state = self.optimizer.init(params)
        losses = []
        for batch in batch_iter:
            params, opt_state, loss = self.step(
                params, opt_state, _to_device(batch, self.device))
            losses.append(loss)
        values = torch.stack(losses).tolist() if losses else []
        return params, sum(values) / max(len(values), 1)
