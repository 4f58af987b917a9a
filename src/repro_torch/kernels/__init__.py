"""Hand-written Hopper kernels: FedNC's GF(2^s) coding hot spot and the
LM serving path's causal attention.

gf_matmul.py   — wrappers of the CUDA GF kernels (lane-packed GF matmul,
                 its batched instance, its seeded variant, the unpacked
                 carry-less multiply), lane packing, launch counts
gf2_xor.py     — wrapper of the GF(2) masked-XOR kernel (s = 1)
flash_attention.py — wrapper of the causal flash-attention kernel
ops.py         — `gf_matmul` through the registry, `gf2_combine`,
                 `flash_attention`
csrc/          — the CUDA C++ sources (sm_90a)
build.py       — nvcc at first use into build/kernels/, ctypes loading,
                 ptxas and SASS reports of a built library
gf_bringup.py  — A/B of gf_matmul.cu or gf2_xor.cu designs on the card
                 (`python -m`)
ref.py         — plain PyTorch versions: table oracle + the kernels'
                 arithmetic in tensor ops
"""
from . import flash_attention, gf2_xor, gf_matmul, ops, ref
from .gf_matmul import gf_matmul_packed, gf_matmul_packed_batched

__all__ = ["flash_attention", "gf2_xor", "gf_matmul", "ops", "ref",
           "gf_matmul_packed", "gf_matmul_packed_batched"]
