"""The paper's local model (§IV-A.1): a 6-conv-layer CNN with batch
normalization and max pooling, for 10-class 32x32x3 images.

The port of `repro.models.cnn.init_cnn`: the same keys, shapes, dtypes
and layouts (conv weights HWIO, as JAX keeps them), so a port tree and
a reference tree packetize to the same number of bytes in the same
order.  The BN running statistics live in the parameters and travel
inside the FedNC packets like weights.
"""
from __future__ import annotations

import math

import torch

CHANNELS = (32, 32, 64, 64, 128, 128)


def init_cnn(generator: torch.Generator, *, num_classes: int = 10,
             in_channels: int = 3, image_size: int = 32,
             dtype=torch.float32) -> dict:
    """He-normal conv weights, zero biases, unit BN scale; drawn on the
    generator's device."""
    dev = generator.device
    params: dict = {}
    c_in = in_channels
    for i, c_out in enumerate(CHANNELS):
        fan_in = 3 * 3 * c_in
        w = torch.randn((3, 3, c_in, c_out), generator=generator,
                        device=dev) * math.sqrt(2.0 / fan_in)
        params[f"conv{i}"] = {
            "w": w.to(dtype),
            "b": torch.zeros((c_out,), dtype=dtype, device=dev),
            "bn_scale": torch.ones((c_out,), dtype=dtype, device=dev),
            "bn_bias": torch.zeros((c_out,), dtype=dtype, device=dev),
            "bn_mean": torch.zeros((c_out,), dtype=torch.float32, device=dev),
            "bn_var": torch.ones((c_out,), dtype=torch.float32, device=dev),
        }
        c_in = c_out
    # 3 maxpools of stride 2: 32 -> 16 -> 8 -> 4
    feat = (image_size // 8) ** 2 * CHANNELS[-1]
    w = torch.randn((feat, num_classes), generator=generator,
                    device=dev) / math.sqrt(feat)
    params["fc"] = {
        "w": w.to(dtype),
        "b": torch.zeros((num_classes,), dtype=dtype, device=dev),
    }
    return params
