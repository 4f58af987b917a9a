"""Leaf constants shared by the engine and its core adapters.

Dependency-free, so `repro_torch.core.fednc` can import it at module
level while `repro_torch.engine.engine` imports `repro_torch.core`.
"""

#: default streamed-chunk width, in symbols: 2^18 uint8 symbols = 256
#: KiB per row of a chunk, a multiple of the int32 lane-pack factor.
DEFAULT_CHUNK_L = 1 << 18
