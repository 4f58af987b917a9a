"""repro_torch: FedNC (network-coded federated learning) in PyTorch.

The PyTorch port of the JAX package `repro`, module for module.  The
coding round (`engine.CodingEngine.round`, `core.fednc.fednc_round`)
runs on an NVIDIA Hopper card through the hand-written CUDA GF(2^s)
kernels in `kernels/csrc/`; every entry point takes an explicit
`device` and runs on ``"cuda"`` unless the caller passes ``"cpu"``.
On CPU tensors the kernel wrappers use their plain PyTorch versions
(`kernels.ref`), which is what the CPU tests hold against `repro`.

This package imports torch and numpy only — never jax, never `repro`.
"""
__version__ = "0.1.0"
