"""FL data partitioners — paper §IV-A.2 data splitting.

The port of `repro.data.partition` (numpy, unchanged).

* iid: the training set is randomly assigned; every client holds data
  of uniform categories.
* mixed non-iid: the set is divided into single-category shards; each
  client gets 2 shards (2 categories) except for a 5% iid part.
"""
from __future__ import annotations

import numpy as np


def iid_partition(labels: np.ndarray, num_clients: int, *, seed: int = 0
                  ) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    return [np.sort(chunk) for chunk in np.array_split(order, num_clients)]


def mixed_noniid_partition(labels: np.ndarray, num_clients: int, *,
                           shards_per_client: int = 2,
                           iid_fraction: float = 0.05,
                           seed: int = 0) -> list[np.ndarray]:
    """Paper's 'mixed non-iid': 1-category shards, 2 per client,
    except for the 5% iid portion that is spread uniformly."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    idx = rng.permutation(n)

    n_iid = int(round(iid_fraction * n))
    iid_idx, shard_idx = idx[:n_iid], idx[n_iid:]

    # sort the non-iid part by label -> contiguous single-category runs
    shard_idx = shard_idx[np.argsort(labels[shard_idx], kind="stable")]
    num_shards = num_clients * shards_per_client
    shards = np.array_split(shard_idx, num_shards)
    shard_order = rng.permutation(num_shards)

    iid_parts = np.array_split(rng.permutation(iid_idx), num_clients)

    out = []
    for c in range(num_clients):
        mine = [shards[shard_order[c * shards_per_client + j]]
                for j in range(shards_per_client)]
        mine.append(iid_parts[c])
        out.append(np.sort(np.concatenate(mine)))
    return out


def client_weights(partitions: list[np.ndarray]) -> np.ndarray:
    """p_k proportional to local dataset size (paper eq. 1)."""
    sizes = np.array([len(p) for p in partitions], np.float64)
    return (sizes / sizes.sum()).astype(np.float32)
