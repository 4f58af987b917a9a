"""Security & error-probability analysis (paper §III-A.1, Prop. 2).

The port of `repro.core.security`: the closed forms are the reference's
numpy, and the Monte-Carlo runs on the port's channel and engine.

* `error_probability_bound(s, eta)` — the paper's eq. (10):
      p_e <= 1 - (1 - 2^-s)^η
  the FedNC decode-failure bound with one receiver (d=1).
* `simulate_error_probability` — Monte-Carlo decode-failure rate of a
  FedNC round pushed through a MultiHopChannel; validates Table I's
  'Error Probability' column (0.5 / 0.0625 / 0.0039 / 0.3239).
* `full_rank_probability(n, K, s)` — exact P[an n×K uniform GF(2^s)
  matrix has rank K]; 0 whenever n < K (the rank-K wall every
  adversary hits).
* `eavesdropper_leak_probability(n, K, p, s)` — closed-form
  probability that an attacker intercepting each of n transmitted
  coded tuples independently with probability p achieves rank K: the
  binomial mixture of `full_rank_probability` over the intercepted
  count.  Monte-Carlo-validated by ``benchmarks/bench_security.py``
  through the reference's `EavesdropperView`.
* `eavesdropper_full_leak_probability(K, p, s)` — the n == K special
  case: all K tuples must be captured AND the K×K matrix must be
  nonsingular, i.e. p^K · Π(1 - q^-i).
"""
from __future__ import annotations

import math

import numpy as np


def error_probability_bound(s: int, eta: int) -> float:
    """Paper eq. (10): p_e <= 1 - (1 - 2^-s)^η."""
    return 1.0 - (1.0 - 2.0 ** (-s)) ** eta


def singular_probability_uniform(K: int, s: int) -> float:
    """Exact P[K×K uniform GF(2^s) matrix is singular]:
    1 - Π_{i=1..K} (1 - q^-i),  q = 2^s."""
    q = float(2**s)
    p_ns = 1.0
    for i in range(1, K + 1):
        p_ns *= 1.0 - q ** (-i)
    return 1.0 - p_ns


def full_rank_probability(n: int, K: int, s: int) -> float:
    """Exact P[an n×K uniform GF(2^s) matrix has rank K] (n rows heard,
    K sources): Π_{i=0}^{K-1} (1 - q^-(n-i)), and 0 for n < K — fewer
    than K intercepted tuples can never reach rank K, whatever the
    coefficients."""
    if n < K:
        return 0.0
    q = float(2**s)
    p = 1.0
    for i in range(K):
        p *= 1.0 - q ** (-(n - i))
    return p


def simulate_error_probability(K: int, s: int, eta: int, trials: int,
                               seed: int = 0, device="cuda") -> float:
    """Monte-Carlo decode-failure rate through η re-coding hops.

    Each trial's coding matrix comes from a torch generator seeded with
    the numpy draw the reference turns into a PRNG key, and its hop
    plan from a `MultiHopChannel` seeded as the reference seeds it; the
    1-symbol payload is recoded on `device`."""
    import torch

    from .channel import MultiHopChannel
    from .rlnc import EncodedBatch, random_coding_matrix

    rng = np.random.default_rng(seed)
    failures = 0
    for _ in range(trials):
        gen = torch.Generator().manual_seed(int(rng.integers(0, 2**31 - 1)))
        A = random_coding_matrix(gen, K, K, s)
        # packets irrelevant for rank statistics; 1-symbol payload
        batch = EncodedBatch(A=A, C=torch.zeros((K, 1), dtype=torch.uint8,
                                                device=device))
        # Prop. 2's η counts EVERY link carrying independent random
        # coefficients — the source's own encode is one of them, so the
        # network applies η-1 further recoding hops.
        chan = MultiHopChannel(eta=max(eta - 1, 0),
                               seed=int(rng.integers(0, 2**31 - 1)))
        _, rep = chan.transmit_encoded(batch, s)
        failures += int(not rep.decodable)
    return failures / trials


def eavesdropper_leak_probability(n: int, K: int, p_intercept: float,
                                  s: int = 8) -> float:
    """P[attacker reaches rank K] when each of n transmitted coded
    tuples is intercepted independently with probability p.

    Binomial mixture over the intercepted count e (every subset of a
    uniform RLNC stack is itself uniform):

        Σ_e C(n, e) · p^e (1-p)^(n-e) · full_rank_probability(e, K, s)

    Terms with e < K vanish — the paper's security claim that an
    eavesdropper holding fewer than K tuples learns *nothing* about
    the K source packets."""
    p = float(p_intercept)
    total = 0.0
    for e in range(K, n + 1):
        total += (math.comb(n, e) * p**e * (1.0 - p) ** (n - e)
                  * full_rank_probability(e, K, s))
    return total


def eavesdropper_full_leak_probability(K: int, p_intercept: float,
                                       s: int = 8) -> float:
    """P[attacker reaches rank K] when exactly K coded tuples are
    transmitted, each intercepted independently with prob p.

    Needs all K tuples AND the K×K coding matrix nonsingular:
        p^K · Π_{i=1..K}(1 - q^-i)
    (== ``eavesdropper_leak_probability(K, K, p, s)``).
    Compare FedAvg: expected leaked client models = p·K > 0 for any p.
    """
    q = float(2**s)
    p_ns = 1.0
    for i in range(1, K + 1):
        p_ns *= 1.0 - q ** (-i)
    return (p_intercept ** K) * p_ns


def fedavg_expected_leak(K: int, p_intercept: float) -> float:
    """Expected number of client models leaked without coding."""
    return p_intercept * K
