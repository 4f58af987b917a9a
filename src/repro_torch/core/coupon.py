"""Proposition 1: the coupon-collector ('blind box') analysis.

FedAvg under blind-box reception needs E[G] = K·H(K) ≈ K ln K + γK
random draws to hear from all K clients; FedNC needs ~K draws (any K
linearly-independent coded packets decode).  This module provides the
exact math, the asymptotic expansion the paper quotes (eq. 5), and
Monte-Carlo simulations of both collection processes.

The port of `repro.core.coupon`: numpy, with the FedNC collector run
through the port's `incremental_select`.
"""
from __future__ import annotations

import math

import numpy as np

EULER_GAMMA = 0.5772156649015329


def harmonic(K: int) -> float:
    """H(K) = 1 + 1/2 + ... + 1/K (exact)."""
    return float(sum(1.0 / i for i in range(1, K + 1)))


def expected_draws_fedavg(K: int) -> float:
    """Exact E[G] = K·H(K) (paper eq. 7)."""
    return K * harmonic(K)


def expected_draws_fedavg_asymptotic(K: int) -> float:
    """Paper eq. 5: K ln K + γK + 1/2 + O(1/K)."""
    return K * math.log(K) + EULER_GAMMA * K + 0.5


def expected_draws_fednc(K: int, s: int = 8) -> float:
    """E[#coded packets to reach rank K] with uniform RLNC coefficients.

    Collecting rank i -> i+1 succeeds per draw with probability
    1 - q^(i-K) (a uniform vector avoids an i-dim subspace of F_q^K),
    so  E = Σ_{i=0}^{K-1} 1 / (1 - q^{i-K}).  For q=256 this is
    K + 1/255 + ... ≈ K — the paper's O(K) claim, made exact.
    """
    q = float(2**s)
    return float(sum(1.0 / (1.0 - q ** (i - K)) for i in range(K)))


def simulate_fedavg_draws(K: int, trials: int, seed: int = 0) -> np.ndarray:
    """Monte-Carlo G for the FedAvg blind-box collector, batched.

    Uses the geometric-stage decomposition: with i coupons held, the
    next new one takes Geom((K-i)/K) draws, and the stages are
    independent — so G = Σ_i Geom((K-i)/K) has *exactly* the law of
    the draw-by-draw collector.  One (trials, K) geometric sample
    replaces the per-trial Python loop of the seed.
    """
    rng = np.random.default_rng(seed)
    p = (K - np.arange(K, dtype=np.float64)) / K
    draws = rng.geometric(np.broadcast_to(p, (trials, K)))
    return draws.sum(axis=1).astype(np.int64)


def simulate_fednc_draws(K: int, s: int, trials: int, seed: int = 0
                         ) -> np.ndarray:
    """Monte-Carlo #draws for FedNC: uniform coding vectors over
    GF(2^s)^K until the stack reaches rank K.

    All pending trials draw their candidate stacks up front (the
    reference's numpy stream), and the port's
    `engine.select.incremental_select` (real GF elimination, not the
    closed-form stage law) finds, trial by trial on the host, the scan
    position of the K-th independent row; +1 is the draw count.  Trials
    whose stack ran out of rows before rank K (probability ~q^-margin)
    retry with a doubled stack.
    """
    import torch

    from repro_torch.engine.select import incremental_select

    rng = np.random.default_rng(seed)
    q = 1 << s
    out = np.zeros(trials, dtype=np.int64)
    todo = np.arange(trials)
    n_max = 2 * K + 8
    while todo.size:
        stacks = rng.integers(0, q, size=(todo.size, n_max, K),
                              dtype=np.uint8)
        ok = np.zeros(todo.size, dtype=bool)
        for j, stack in enumerate(stacks):
            ok[j], sel, _ = incremental_select(torch.from_numpy(stack), s)
            # sel is in scan order: position K-1 holds the index of the
            # K-th independent row — the draw on which rank hit K
            out[todo[j]] = int(sel[K - 1]) + 1
        todo = todo[~ok]
        n_max *= 2
    return out
