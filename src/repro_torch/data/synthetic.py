"""Synthetic class-conditional image data (CIFAR-10 stand-in).

The port of `repro.data.synthetic` (numpy, unchanged): the same seeds
give the same arrays.  Nothing is downloaded, so the paper's CIFAR-10
task is replaced by a structured synthetic distribution with the same
shape: each of the 10 classes has a fixed random spatial template;
samples are template + per-sample noise.  A small CNN reaches high
accuracy on it only by learning the class structure, and the
iid/non-iid *partitioning* behaves as on the real dataset.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticImageDataset:
    images: np.ndarray   # (N, H, W, C) float32 in [0, 1]
    labels: np.ndarray   # (N,) int32

    def __len__(self) -> int:
        return len(self.labels)

    def subset(self, idx: np.ndarray) -> "SyntheticImageDataset":
        return SyntheticImageDataset(self.images[idx], self.labels[idx])


def make_image_dataset(n: int, *, num_classes: int = 10, size: int = 32,
                       channels: int = 3, noise: float = 0.35,
                       seed: int = 0,
                       template_seed: int = 1234) -> SyntheticImageDataset:
    # class templates come from template_seed so that train/test splits
    # built with different sampling seeds share one distribution
    trng = np.random.default_rng(template_seed)
    base = trng.normal(size=(num_classes, size // 4, size // 4, channels))
    templates = base.repeat(4, axis=1).repeat(4, axis=2)
    templates = templates / (np.abs(templates).max() + 1e-9)

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    imgs = templates[labels]
    imgs = imgs + noise * rng.normal(size=imgs.shape)
    imgs = (imgs - imgs.min()) / (imgs.max() - imgs.min() + 1e-9)
    return SyntheticImageDataset(imgs.astype(np.float32), labels)


def batches(ds: SyntheticImageDataset, batch_size: int, *, seed: int = 0,
            epochs: int = 1):
    """Shuffled minibatch iterator (drops the ragged tail)."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i: i + batch_size]
            yield ds.images[idx], ds.labels[idx]
