"""Step builders: train_step (with FedNC gradient aggregation across
the client axis), prefill_step, serve_step (single-token greedy decode).

The port of `repro.launch.steps`.  FedNC on the training step: the
global batch is split into K client shards, each client's gradient of
`lm_loss` is taken on its shard, and the K gradients are aggregated by
one of

  plain         — the mean over clients (the reliable-fabric reference);
  fednc_naive   — the paper-literal codec: encode all clients' full
                  gradients with a random float mixing matrix A
                  (C = A·G), decode by A⁻¹ (Gauss–Jordan), average;
  fednc_blocked — the blocked codec: each gradient split into K blocks
                  (the reference pads to a multiple of K), coded
                  block-wise, decoded in float32.

The reference states these as pjit programs whose collectives XLA
derives; on one device the port runs the same arithmetic eagerly, leaf
by leaf.  Its mixing matrix comes from a host `torch.Generator` (the
reference draws `jax.random.normal`), and every aggregation also takes
a given A, so the two packages can be held to one matrix.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.dist import mix_matrix
from repro_torch.core.packets import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, apply_updates

MASK_VALUE = -1e30
AGG_MODES = ("plain", "fednc_naive", "fednc_blocked")
AGG_COLUMNS = 1 << 24     # columns of a (K, n) gradient stack coded at once


# ---------------------------------------------------------------------------
# FedNC gradient aggregation (float field)
# ---------------------------------------------------------------------------

def float_inv(A: torch.Tensor) -> torch.Tensor:
    """Gauss–Jordan inverse of a small K x K matrix, unrolled, with the
    reference's partial pivoting (the largest |entry| at or below the
    diagonal, the first of equals), in float32 on A's device.  Not
    `torch.linalg.inv`: the reference keeps to elementwise steps so that
    the inverse stays a plain product downstream, and the port follows
    its arithmetic step for step."""
    K = A.shape[0]
    M = torch.cat([A.to(torch.float32),
                   torch.eye(K, dtype=torch.float32, device=A.device)], 1)
    rows = torch.arange(K, device=A.device)
    for col in range(K):
        cand = torch.where(rows >= col, M[:, col].abs(),
                           torch.tensor(float("-inf"), device=A.device))
        piv = int(torch.argmax(cand))
        M[[col, piv]] = M[[piv, col]]
        M[col] = M[col] / M[col, col]
        factors = M[:, col].clone()
        factors[col] = 0.0
        M = M - factors[:, None] * M[col][None, :]
    return M[:, K:]


def _mm(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M·x with M cast to x's dtype, float32 sums, the result rounded
    to x's dtype (the reference's ``preferred_element_type=float32``
    followed by ``astype``)."""
    return (M.to(x.dtype).float() @ x.float()).to(x.dtype)


def aggregate_gradients(grads: Any, generator: Optional[torch.Generator],
                        K: int, mode: str, *,
                        A: Optional[torch.Tensor] = None,
                        code_in_bf16: bool = False) -> Any:
    """grads: tree of (K, ...) per-client gradients -> tree of (...)
    means.  The coded modes draw A from `generator` (`core.dist.mix_matrix`)
    unless A is given.

    code_in_bf16 keeps the coded packets in the gradient's dtype (bf16)
    with float32 sums, instead of a float32 copy of the whole K x
    gradient stack."""
    if mode not in AGG_MODES:
        raise ValueError(f"unknown aggregation mode {mode!r}")
    if mode == "plain":
        return tree_map(lambda g: torch.mean(g, 0), grads)
    if A is None:
        A = mix_matrix(generator, K)
    A_inv = float_inv(A.cpu())
    device = tree_flatten(grads)[0][0].device
    A, A_inv = A.to(device), A_inv.to(device)

    def _cast(x):
        return x if code_in_bf16 else x.to(torch.float32)

    # Both coded modes code each column of a leaf's (K, n) stack on its
    # own: the reference's blocked mode zero-pads the leaf to a multiple
    # of K and codes it as K blocks of m columns, and its zero columns
    # decode to zero and are sliced off, so the same columns are coded
    # here without them.  The modes differ only in the decode: naive
    # rounds X = A⁻¹·C to the packet dtype, blocked keeps it float32.  A
    # leaf is coded AGG_COLUMNS columns at a time: a slab's float32
    # copies, not a whole leaf's, bound the extra memory.
    def code(g):
        gf = g.reshape(K, -1)
        out = torch.empty(gf.shape[1], dtype=g.dtype, device=g.device)
        for c0 in range(0, gf.shape[1], AGG_COLUMNS):
            C = _mm(A, _cast(gf[:, c0:c0 + AGG_COLUMNS]))   # encode (eq. 4)
            if mode == "fednc_naive":
                X = _mm(A_inv, C)                   # Gauss-Jordan decode
            else:
                X = A_inv.to(C.dtype).float() @ C.float()
            out[c0:c0 + X.shape[1]] = torch.mean(X.float(), 0)
        return out.reshape(g.shape[1:])

    return tree_map(code, grads)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def client_gradients(params: Any, batch: dict, cfg: ModelConfig, K: int, *,
                     window: Optional[int] = None
                     ) -> tuple[torch.Tensor, Any]:
    """Split the global batch into K client shards and take each
    client's loss and gradient of `lm_loss` (remat on): (losses (K,)
    float32, a tree of (K, ...) gradients in the parameters' dtypes).
    A loop over the clients into one preallocated stack stands in for
    the reference's vmap."""
    leaves, treedef = tree_flatten(params)
    stack = [torch.empty((K,) + t.shape, dtype=t.dtype, device=t.device)
             for t in leaves]
    losses = []
    for i in range(K):
        shard = {k: x.reshape((K, x.shape[0] // K) + x.shape[1:])[i]
                 for k, x in batch.items()}
        live = [t.detach().requires_grad_() for t in leaves]
        loss, _ = tf.lm_loss(tree_unflatten(treedef, live), shard, cfg,
                             window=window, remat=True)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        for dst, g in zip(stack, grads, strict=True):
            dst[i].copy_(g)
        del grads
        losses.append(loss.detach())
    return torch.stack(losses), tree_unflatten(treedef, stack)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    num_clients: int, agg_mode: str = "fednc_naive",
                    window: Optional[int] = None,
                    kshard_grads: bool = False,
                    agg_bf16: bool = False) -> Callable:
    """Returns train_step(params, opt_state, batch, generator, *, A=None)
    -> (params, opt_state, mean client loss).  The coded modes draw the
    mixing matrix from the host `generator` unless A is given.

    kshard_grads pins the reference's per-client gradient stack to a
    mesh layout (client axis on `data`); it is a sharding constraint,
    the identity on one device, as in the reference without a mesh.
    The port's mesh is one card (`launch.mesh`)."""
    K = num_clients
    if agg_mode not in AGG_MODES:
        raise ValueError(f"unknown aggregation mode {agg_mode!r}")
    del kshard_grads                # one device: the identity

    def train_step(params, opt_state, batch, generator=None, *, A=None):
        losses, grads = client_gradients(params, batch, cfg, K,
                                         window=window)
        gmean = aggregate_gradients(grads, generator, K, agg_mode, A=A,
                                    code_in_bf16=agg_bf16)
        del grads
        updates, opt_state = optimizer.update(gmean, opt_state, params)
        del gmean
        params = apply_updates(params, updates)
        return params, opt_state, torch.mean(losses)

    return train_step


def make_prefill_step(cfg: ModelConfig, *, cache_len: int,
                      window: Optional[int] = None) -> Callable:
    """(params, batch) -> (last logits (B, 1, V), cache); batch holds
    "tokens" (B, S) and, for a config with a frontend, "memory" (B, M, d)
    (`tf.prefill`)."""
    def prefill_step(params, batch):
        return tf.prefill(params, batch["tokens"], cfg, cache_len=cache_len,
                          window=window, memory=batch.get("memory"))
    return prefill_step


def make_serve_step(cfg: ModelConfig, *,
                    window: Optional[int] = None) -> Callable:
    """Single-token greedy decode step: (params, cache, token (B, 1)) ->
    (next_token (B, 1) int32, its log-prob (B, 1) float32, cache).  The
    vocabulary's padding columns are masked before the argmax."""
    def serve_step(params, cache, token):
        logits, cache = tf.decode_step(params, token, cache, cfg,
                                       window=window)
        logits = logits.float()
        vmask = torch.arange(cfg.padded_vocab,
                             device=logits.device) < cfg.vocab_size
        logits = torch.where(vmask[None, None], logits, MASK_VALUE)
        nxt = torch.argmax(logits, dim=-1)
        logp = torch.log_softmax(logits, dim=-1)
        lp = torch.gather(logp, -1, nxt[..., None])[..., 0]
        return nxt.to(torch.int32), lp, cache
    return serve_step
