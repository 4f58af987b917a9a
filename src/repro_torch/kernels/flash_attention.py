"""Causal flash attention: CUDA kernels and wrapper.

The attention of every prefill, forward and training call of the LM
path.  Two hand-written Hopper kernels live in `csrc/flash_attention.cu`, one
per dtype, behind one wrapper:

* `flash_attention(q, k, v, causal=)` — replaces the TPU kernel
  `repro.kernels.flash_attention.flash_attention_folded` (and its
  wrapper `flash_attention`): online-softmax attention with scale
  1/sqrt(hd), float32 scores and accumulator, key tiles above the
  diagonal skipped.  bf16 runs on the tensor cores (wgmma, K and V
  through a TMA ring, P rounded to bf16 before P·V); float32 on the
  CUDA cores in full float32.

It takes q (B, S, H, hd) and k, v (B, S, KV, hd) as the model makes them
(no fold, no transpose: the kernels read strides) and indexes KV head
h // (H // KV) instead of expanding K and V.  The ragged last tile is
masked in the kernel, so S is not padded.  TMA reads a bf16 operand in
place only from a 16-byte-aligned base with strides of multiples of 16
bytes; an operand that is not is copied to a contiguous one first (the
same kernel then reads the copy).  As in the reference, the non-causal
case needs S to be a multiple of the reference's block (128) and raises
ValueError otherwise.

The wrapper decides by the tensor's device alone: a CPU tensor runs the
plain version `ref.flash_attention_ref`, a CUDA tensor launches the
kernel or raises, and a meta tensor (a traced plan, `launch.roofline`)
gets an output of the right shape and launches nothing.  It counts its
launches in ``.launches``.  The forward is one operator,
``torch.ops.repro_torch.flash_attention``, so a dispatch mode sees one op
on every device, not the plain version's products; its FLOP formula
(`flash_flops`, registered with `torch.utils.flop_counter`) counts the
causal half the kernel computes.  It is an autograd Function: the
kernels compute no logsumexp, so its backward, `attention_backward`,
recomputes the softmax in float32 and applies the closed-form gradient
of the reference's `_attend` in plain PyTorch (the reference takes that
gradient by autodiff, outside any kernel).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from . import ref

#: the reference's default blocks: the non-causal contract's multiple
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
HEAD_DIMS = (32, 64, 128)          # the kernel's template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: float32 elements of one (B, H, rows, keys) tensor of the backward
BWD_CHUNK_ELEMS = 1 << 28

_SIGNATURE = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
              + [ctypes.c_longlong] * 12
              + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C functions' types declared."""
    from . import build

    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = _SIGNATURE
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> None:
    """Raise on what the kernel does not take (on every device, so the
    CPU path keeps the card's contract)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D (B, S, heads, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"k and v must be ({B}, {S}, KV, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         f"heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel is built "
                         f"for {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if not causal and S % max(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K):
        raise ValueError("non-causal flash requires S % block == 0 "
                         "(zero-padded keys would receive attention)")


def _strides(x: torch.Tensor) -> tuple[int, int, int]:
    """x's batch, sequence and head strides in elements, where a
    dimension of size 1 (never stepped) takes a contiguous tensor's."""
    _, S, N, hd = x.shape
    natural = (S * N * hd, N * hd, hd)
    return tuple(st if n > 1 else nat for st, n, nat
                 in zip(x.stride()[:3], x.shape[:3], natural))


def tma_ready(x: torch.Tensor) -> bool:
    """Whether TMA can read x in place: unit hd stride, a 16-byte-aligned
    base, and positive strides that are multiples of 16 bytes."""
    size = x.element_size()
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(st > 0 and st * size % 16 == 0 for st in _strides(x)))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """One launch of the kernel of q's dtype on checked CUDA operands;
    raises if it fails and counts it in ``flash_attention.launches``."""
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        q, k, v = (x if tma_ready(x)
                   else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
    else:
        q, k, v = (x if x.stride(3) == 1 else x.contiguous()
                   for x in (q, k, v))
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, S, H, k.shape[2], hd,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        int(causal), 1.0 / math.sqrt(hd),
        q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({lib.flash_error_string(err).decode()})")
    flash_attention.launches += 1
    return out


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, *,
                       causal: bool) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of o = softmax(q·kᵀ/sqrt(hd) + mask)·v, in float32,
    returned in the inputs' dtypes.

    The closed form of the gradient the reference takes by autodiff of
    its float32 `_attend`: with S the masked scores and P = softmax(S),
    dV = Pᵀ·dO, dS = P ⊙ (dP − rowsum(P ⊙ dP)) with dP = dO·Vᵀ,
    dQ = dS·K/sqrt(hd), dK = dSᵀ·Q/sqrt(hd), each KV head summing the
    gradients of the H / KV query heads that share it.  rowsum(P ⊙ dP)
    is rowsum(dO ⊙ O) for the float32 O = P·V; the kernel's own output
    is not used there, since the bf16 kernel rounds P and O to bf16 and
    that would move the bf16 gradients off `_attend`'s.  P is recomputed
    from q and k in chunks of query rows (a causal chunk reads only the
    keys up to its last row), so no (B, H, S, S) tensor is built at
    once."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    q32 = q.float().reshape(B, S, KV, G, hd)
    do32 = dout.float().reshape(B, S, KV, G, hd)
    k32, v32 = k.float(), v.float()
    dq = torch.empty_like(q32)
    dk = torch.zeros_like(k32)
    dv = torch.zeros_like(v32)
    rows = max(1, BWD_CHUNK_ELEMS // max(B * H * S, 1))
    for i0 in range(0, S, rows):
        i1 = min(S, i0 + rows)
        T = i1 if causal else S
        qc, doc = q32[:, i0:i1], do32[:, i0:i1]
        kt, vt = k32[:, :T], v32[:, :T]
        s = torch.einsum("bqkgd,btkd->bkgqt", qc, kt) * scale
        if causal:
            qpos = torch.arange(i0, i1, device=q.device)[:, None]
            kpos = torch.arange(T, device=q.device)[None, :]
            s.masked_fill_(kpos > qpos, ref.FLASH_MASK)
        p = torch.softmax(s, dim=-1)
        del s
        dp = torch.einsum("bqkgd,btkd->bkgqt", doc, vt)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del dp
        dq[:, i0:i1] = torch.einsum("bkgqt,btkd->bqkgd", ds, kt) * scale
        dk[:, :T] += torch.einsum("bkgqt,bqkgd->btkd", ds, qc) * scale
        dv[:, :T] += torch.einsum("bkgqt,bqkgd->btkd", p, doc)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_flops(B: int, S: int, H: int, hd: int, causal: bool) -> int:
    """The multiply-adds (x2) of one call: q·kᵀ and P·V over the live
    (query, key) pairs of each head, S(S+1)/2 when causal (the kernel
    skips the tiles above the diagonal), else S²."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * H * pairs * hd


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """The forward as one operator: the plain version on the CPU, one
    launch of the kernel on the card."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _launch(q, k, v, causal)


@_flash_op.register_fake
def _flash_meta(q, k, v, causal):
    """The output's shape and dtype, without a launch (meta tensors)."""
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_op_flops(q_shape, k_shape, v_shape, causal, *args,
                    out_shape=None, **kwargs) -> int:
    B, S, H, hd = q_shape
    return flash_flops(B, S, H, hd, causal)


class _FlashAttention(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) forward and
    `attention_backward` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = _flash_op(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*attention_backward(*ctx.saved_tensors, dout,
                                    causal=ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q·kᵀ/sqrt(hd))·v per head: q (B, S, H, hd), k and v
    (B, S, KV, hd) with H a multiple of KV -> (B, S, H, hd) in q's dtype,
    differentiable in q, k and v (`attention_backward`).

    CUDA tensors launch the hand-written kernel of their dtype (a launch
    that fails raises; nothing falls back to another attention); CPU
    tensors run `ref.flash_attention_ref`; meta tensors launch nothing.
    """
    check_operands(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.launches = 0

#: every hand-written kernel wrapper of this module
WRAPPERS = (flash_attention,)
