"""Synthetic LM token streams for the large-architecture drivers.

The port of `repro.data.tokens` (numpy, unchanged).

Markov-chain token source with a planted bigram structure so language
models have real signal to fit (loss decreases measurably within a few
hundred steps even at toy scale).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenStream:
    vocab_size: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse preferred-successor table: each token strongly prefers
        # a handful of successors (planted structure)
        self._succ = rng.integers(0, self.vocab_size,
                                  size=(self.vocab_size, 4))
        self._rng = np.random.default_rng(self.seed + 1)

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len + 1), np.int32)
        out[:, 0] = self._rng.integers(0, self.vocab_size, size=batch)
        for t in range(seq_len):
            prev = out[:, t]
            choice = self._rng.integers(0, 4, size=batch)
            planted = self._succ[prev, choice]
            noise = self._rng.integers(0, self.vocab_size, size=batch)
            use_noise = self._rng.random(batch) < 0.1
            out[:, t + 1] = np.where(use_noise, noise, planted)
        return out

    def batch(self, batch: int, seq_len: int) -> dict:
        toks = self.sample(batch, seq_len)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_token_stream(vocab_size: int, seed: int = 0) -> TokenStream:
    return TokenStream(vocab_size=vocab_size, seed=seed)
