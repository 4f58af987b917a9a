"""repro_torch.engine — the RLNC coding spine on one device.

engine.py   — EngineConfig + CodingEngine: packetization, chunk-streamed
              encode/decode through the registry kernel, and the fused
              round (`round`) that folds a channel's row plan into the
              encode/decode stream.
registry.py — named kernel registry; ``auto``/``auto_seeded`` resolve by
              the engine's device to the hand-written CUDA kernels.
select.py   — incremental-GE independent-row selector (`reduce_row`,
              `insert_row`: the reduced-basis step it shares with stream).
stream.py   — StreamDecoder / DecoderBank / stream_decode: the
              per-arrival decoder, row space on the host, payload row
              operations in the packed kernel on the card.
"""
from .engine import (DEFAULT_CHUNK_L, CodingEngine, EngineConfig,
                     EngineRound, get_engine, resolve_device)
from .registry import (available_kernels, is_seeded_kernel,
                       materialized_kernel_name, register_kernel,
                       resolve_kernel, resolve_kernel_name,
                       seeded_kernel_name)
from .select import incremental_select, reduce_insert
from .stream import DecoderBank, StreamDecoder, stream_decode

__all__ = [
    "CodingEngine", "DEFAULT_CHUNK_L", "EngineConfig", "EngineRound",
    "get_engine", "resolve_device", "available_kernels",
    "register_kernel", "resolve_kernel", "resolve_kernel_name",
    "is_seeded_kernel", "seeded_kernel_name", "materialized_kernel_name",
    "incremental_select", "reduce_insert",
    "StreamDecoder", "DecoderBank", "stream_decode",
]
