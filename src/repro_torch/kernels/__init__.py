"""Hand-written Hopper kernels for FedNC's GF(2^s) coding hot spot.

gf_matmul.py   — wrappers of the two CUDA kernels (lane-packed GF
                 matmul, and its seeded variant), lane packing, launch
                 counts
csrc/          — the CUDA C++ sources (sm_90a)
build.py       — nvcc at first use into build/kernels/, ctypes loading
ref.py         — plain PyTorch versions: table oracle + the kernels'
                 arithmetic in tensor ops
"""
from . import gf_matmul, ref

__all__ = ["gf_matmul", "ref"]
