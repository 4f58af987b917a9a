"""Assigned input shapes and per-(arch, shape) stand-in inputs.

The port of `repro.launch.specs`.  `batch_inputs` and `decode_inputs`
return meta-device tensors (the reference's `ShapeDtypeStruct`s): no
memory is allocated, and the dry run (`launch.dryrun`) traces the steps
on them.

Decode shapes run serve_step: ONE new token against a cache of
seq_len.  long_500k requires sub-quadratic attention: SSM/hybrid archs
run natively; full-attention archs run their sliding-window variant
(window = cfg.long_context_window), so all 10 archs cover all 4 shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def sds(shape, dtype, device=META) -> torch.Tensor:
    """A stand-in of `shape` and `dtype` (on the meta device: no bytes)."""
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def needs_memory(cfg: ModelConfig) -> bool:
    return cfg.frontend is not None


def memory_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Frontend token count.  Vision: fixed patch budget.  Audio: the
    shape's sequence length IS the audio frame count (long-form audio
    is the seq axis for enc-dec)."""
    if cfg.frontend == "vision":
        return cfg.num_frontend_tokens
    if cfg.frontend == "audio":
        return shape.seq_len
    return 0


def decode_window(cfg: ModelConfig, shape: ShapeSpec) -> Optional[int]:
    """Window override for the attention caches of a decode shape.
    long_500k forces the sliding-window variant on full-attention
    archs; shapes <= 32k keep the arch's own window (full cache if
    the arch has none)."""
    if shape.name == "long_500k" and cfg.window is None:
        return cfg.long_context_window
    return cfg.window


def batch_inputs(cfg: ModelConfig, shape: ShapeSpec, device=META) -> dict:
    """Inputs for train/prefill steps: token ids as int64, the port's
    index dtype (the reference's are int32)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((B, S), torch.long, device)}
    if shape.kind == "train":
        batch["labels"] = sds((B, S), torch.long, device)
    if needs_memory(cfg):
        M = memory_len(cfg, shape)
        batch["memory"] = sds((B, M, cfg.d_model), cfg.dtype, device)
    return batch


def decode_inputs(cfg: ModelConfig, shape: ShapeSpec, device=META) -> dict:
    """(cache, token) stand-ins for serve_step: the port's
    `make_decoder_cache` built on the meta device."""
    from repro_torch.models import transformer as tf
    B, S = shape.global_batch, shape.seq_len
    window = decode_window(cfg, shape)
    M = memory_len(cfg, shape) if needs_memory(cfg) else 0
    cache = tf.make_decoder_cache(cfg, B, S, window, M, device=device)
    return {"cache": cache, "token": sds((B, 1), torch.long, device)}
