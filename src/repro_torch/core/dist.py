"""Mesh-level FedNC: network coding as a collective over the data axis.

The port of `repro.core.dist` on `torch.distributed`.  The paper's
"clients" map onto the ranks of the data axis: each rank holds one
client's update, and FedNC's random linear mixing is applied across
the ranks before the (logical) server averages.  Coefficients live in
the real field (Gaussian: invertible a.s.); the GF(2^s) bit-exact path
remains the protocol codec (`core.rlnc`).

Three formulations, identical math, different wire cost:

* ``mode='naive'`` — paper-literal: `all_gather` every client's update
  (K x bytes), encode with the K x K matrix A, decode with A's
  Gauss–Jordan inverse (`launch.steps.float_inv`), average.
* ``mode='blocked'`` — NC-aware reduce-scatter: the update is
  zero-padded to a multiple of K and split into K blocks; one
  `all_to_all_single` lands block j of every client on rank j, which
  encodes and decodes that block locally, then an `all_gather`
  redistributes the averaged blocks (bytes ~ an all-reduce).
* ``mode='psum'`` — decode∘encode is the identity on a reliable fabric:
  an `all_reduce` SUM divided by K (gloo has no AVG).

All return the FedAvg mean when decoding succeeds (linearity).  The
mixing matrix of each leaf comes from a `torch.Generator` seeded the
same on every rank (the reference folds the leaf's index into a shared
key), or is given as ``A=`` for every leaf, as
`launch.steps.aggregate_gradients` takes it.  The inverse is taken on
the host, so every rank decodes with the same float32 matrix.

On one card the group has one rank: K = 1 and every collective is the
identity (`launch.mesh`).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.packets import tree_flatten, tree_unflatten

MODES = ("naive", "blocked", "psum")


def mix_matrix(generator: torch.Generator, K: int,
               dtype=torch.float32) -> torch.Tensor:
    """Random real coding matrix, shared by construction (the same
    generator state on every rank), drawn on the host."""
    return torch.randn((K, K), generator=generator, dtype=dtype)


def _inverse(A: torch.Tensor, device) -> torch.Tensor:
    from repro_torch.launch.steps import float_inv
    return float_inv(A.cpu()).to(device)


def _all_gather(x: torch.Tensor, K: int, group) -> torch.Tensor:
    """(K, *x.shape): every rank's x, in rank order (the list form of
    `all_gather`, which gloo and NCCL both take)."""
    outs = [torch.empty_like(x) for _ in range(K)]
    dist.all_gather(outs, x.contiguous(), group=group)
    return torch.stack(outs)


def _naive_body(u: torch.Tensor, A: torch.Tensor, *, K: int,
                group=None) -> torch.Tensor:
    """u: (L,) this rank's update -> the decoded mean (L,)."""
    allu = _all_gather(u, K, group)                       # (K, L)
    A = A.to(u.device)
    C = A @ allu.float()                          # encode (eq. 4)
    P_hat = _inverse(A, u.device) @ C             # Gauss-Jordan decode
    return torch.mean(P_hat, 0).to(u.dtype)


def _blocked_body(u: torch.Tensor, A: torch.Tensor, *, K: int,
                  group=None) -> torch.Tensor:
    """NC-aware reduce-scatter formulation; u's length is a multiple of
    K."""
    L = u.shape[0]
    mine = torch.empty_like(u)
    # block j of every client lands on rank j, in client order
    dist.all_to_all_single(mine, u.contiguous(), group=group)
    mine = mine.reshape(K, L // K)
    A = A.to(u.device)
    C = A @ mine.float()                          # encode block j
    P_hat = _inverse(A, u.device) @ C             # decode block j
    mean_j = torch.mean(P_hat, 0).to(u.dtype)     # (L // K,)
    return _all_gather(mean_j, K, group).reshape(L)


def fednc_mean_flat(u: torch.Tensor, A: Optional[torch.Tensor], *, K: int,
                    mode: str = "blocked", group=None) -> torch.Tensor:
    """FedNC-coded mean of a flat per-rank update over the K ranks of
    `group`; A is the (K, K) mixing matrix (unused by ``psum``)."""
    if mode == "naive":
        return _naive_body(u, A, K=K, group=group)
    if mode == "blocked":
        L = u.shape[0]
        pad = (-L) % K
        up = torch.nn.functional.pad(u, (0, pad))
        return _blocked_body(up, A, K=K, group=group)[:L]
    if mode == "psum":
        out = u.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / K if out.is_floating_point() else out // K
    raise ValueError(f"unknown mode {mode!r}")


def fednc_tree_mean(tree: Any, generator: Optional[torch.Generator], *,
                    K: int, mode: str = "blocked",
                    A: Optional[torch.Tensor] = None, group=None) -> Any:
    """The coded mean leaf by leaf: each leaf is flattened, coded with
    the next matrix of `generator` (or with A), averaged, restored."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for leaf in leaves:
        Ai = A if (A is not None or mode == "psum") \
            else mix_matrix(generator, K)
        m = fednc_mean_flat(leaf.reshape(-1), Ai, K=K, mode=mode,
                            group=group)
        out.append(m.reshape(leaf.shape))
    return tree_unflatten(treedef, out)


def make_fednc_mean(mesh=None, *, axis: str = "data",
                    mode: str = "blocked") -> Callable:
    """Returns f(update_tree, generator=None, *, A=None) -> mean_tree.
    Each leaf of update_tree is this rank's slice (1, ...) of the
    reference's (K, ...) client stack; the result has the same shape,
    every rank's slice the coded mean.  K is the size of `axis` of
    `mesh` (a DeviceMesh), or the default group's world size."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    group = mesh.get_group(axis) if mesh is not None else None
    K = dist.get_world_size(group)

    def f(tree, generator: Optional[torch.Generator] = None, *,
          A: Optional[torch.Tensor] = None):
        leaves, treedef = tree_flatten(tree)
        local = tree_unflatten(treedef, [x[0] for x in leaves])
        mean = fednc_tree_mean(local, generator, K=K, mode=mode, A=A,
                               group=group)
        return tree_unflatten(treedef, [x[None] for x in
                                        tree_flatten(mean)[0]])

    return f
