"""The paper's local model (§IV-A.1): a 6-conv-layer CNN with batch
normalization and max pooling, for 10-class 32x32x3 images.

The port of `repro.models.cnn`: the same keys, shapes, dtypes and
layouts (conv weights HWIO, images NHWC, as JAX keeps them), so a port
tree and a reference tree packetize to the same bytes in the same
order.  The BN running statistics live in the parameters and travel
inside the FedNC packets like weights.

`apply_cnn` runs plain `torch.nn.functional` calls (cuDNN and cuBLAS on
the card) on permuted views of that layout; BatchNorm's statistics are
computed explicitly, as the reference computes them (biased variance,
running stats 0.9·old + 0.1·batch), not through `F.batch_norm`.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

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


@contextlib.contextmanager
def float32_products():
    """Convolutions and matmuls in full float32 inside the block: cuDNN
    may use TF32 for float32 convolutions by default (~1e-3 relative
    error), which would move training away from the reference.  The
    flags are restored on exit, so nothing outside is changed."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _conv_bn(p: dict, x: torch.Tensor, train: bool, momentum: float = 0.9
             ) -> tuple[torch.Tensor, dict]:
    """x NCHW (a permuted view of NHWC) -> relu(BN(conv(x) + b))."""
    y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding=1)   # HWIO -> OIHW
    y = y + p["b"][:, None, None]
    if train:
        mu = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), correction=0)
        new_p = dict(p)
        new_p["bn_mean"] = (momentum * p["bn_mean"]
                            + (1 - momentum) * mu.detach())
        new_p["bn_var"] = (momentum * p["bn_var"]
                           + (1 - momentum) * var.detach())
    else:
        mu, var = p["bn_mean"], p["bn_var"]
        new_p = p
    y = (y - mu[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
    y = y * p["bn_scale"][:, None, None] + p["bn_bias"][:, None, None]
    return torch.relu(y), new_p


def apply_cnn(params: dict, x: torch.Tensor, *, train: bool = False
              ) -> tuple[torch.Tensor, dict]:
    """x: (B, H, W, C) -> (logits, updated_params_with_bn_stats)."""
    new_params = dict(params)
    x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW view
    for i in range(len(CHANNELS)):
        x, new_params[f"conv{i}"] = _conv_bn(params[f"conv{i}"], x, train)
        if i % 2 == 1:
            x = F.max_pool2d(x, 2, 2)
    # flatten in the reference's (H, W, C) order, so fc/w carries across
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    logits = x @ params["fc"]["w"] + params["fc"]["b"]
    return logits, new_params


def cnn_loss(params: dict, batch: tuple, *, train: bool = True):
    """Mean cross-entropy; aux = updated params (BN stats)."""
    x, y = batch
    logits, new_params = apply_cnn(params, x, train=train)
    return F.cross_entropy(logits, y.long()), new_params


def merge_bn_stats(params: dict, new_params: dict) -> dict:
    """Carry BN running statistics from a train-mode apply back into the
    parameter tree (LocalTrainer.state_merge hook)."""
    out = dict(params)
    for i in range(len(CHANNELS)):
        conv = dict(out[f"conv{i}"])
        conv["bn_mean"] = new_params[f"conv{i}"]["bn_mean"]
        conv["bn_var"] = new_params[f"conv{i}"]["bn_var"]
        out[f"conv{i}"] = conv
    return out


def cnn_accuracy(params: dict, images, labels, batch: int = 512) -> float:
    """Eval accuracy (running BN stats) of numpy images (N, H, W, C) and
    labels, on the device the parameters lie on."""
    dev = params["fc"]["w"].device
    correct = 0
    n = len(labels)
    with torch.no_grad(), float32_products():
        for i in range(0, n, batch):
            x = torch.from_numpy(np.asarray(images[i:i + batch])).to(dev)
            logits, _ = apply_cnn(params, x, train=False)
            want = torch.from_numpy(np.asarray(labels[i:i + batch])).to(dev)
            correct += int((logits.argmax(dim=-1) == want).sum())
    return correct / n
