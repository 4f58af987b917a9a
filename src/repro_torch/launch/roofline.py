"""Roofline terms of a traced step, and its memory plan.

The port of `repro.launch.roofline`, for one NVIDIA H100.  Three terms
per (arch x shape), in seconds:

    compute    = FLOPs / peak FLOP/s                    (989.4e12 bf16)
    memory     = HBM bytes / HBM bandwidth               (3.35e12)
    collective = collective bytes / link bandwidth       (0 on one card)

The reference parses XLA's optimized HLO to recover its `lax.scan`
trip counts (`analyze_hlo`).  The port has no HLO and no scan: an eager
step runs one kernel per aten op, so `analyze_step` runs the step once
under two dispatch modes and counts what it dispatches:

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` (matmuls,
    convolutions and the flash operator, whose registered formula
    counts the causal half the kernel computes; `kernels.flash_attention`);
  * eager bytes: Σ (operand + result bytes) over every op whose
    ``func.is_view`` is false and that touches a tensor on the traced
    device (views and allocations move nothing).  This is the traffic
    of today's eager step, casts and unfused passes included, not the
    least traffic of the function, and no bound divides by it;
  * written bytes: what the ops write in place into storages the step
    did not make (a decode's cache slots), each storage at most once;
  * the memory plan: the bytes of the storages the step creates, added
    when an op's result makes one and taken away when the storage dies,
    and their peak.  Views keep their base alive, so the count is by
    storage, not by tensor.

The memory term divides the step's floor of HBM traffic by the
bandwidth (`floor_bytes`): every argument (parameters, optimizer state,
caches, inputs) read once, every storage the step hands back written
once, and the in-place writes into its arguments.  It depends on the
function, not on how many passes today's implementation makes, so a
change that removes copies does not lower its own bound.  The floor
reads every parameter, as the capacity formulation of MoE computes
every expert's slots (the FLOPs count them too).

On the meta device the step allocates nothing and launches nothing, so
a full-size configuration is planned on any host.  What the count
cannot see: work inside an op (a kernel's workspace, the allocator's
rounding and fragmentation, cuBLAS's workspace).
The collective term is the bytes `core.dist` would move at the mesh's
client count (`collective_bytes`); one card has one client, so it is 0.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

aten = torch.ops.aten
#: ops that allocate or alias without moving bytes
_FREE_OPS = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten.lift_fresh.default}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class TraceAnalysis:
    """What one traced step dispatched."""
    flops: float = 0.0
    eager_bytes: float = 0.0  # operands and results of every eager op
    write_bytes: float = 0.0  # written in place into the step's arguments
    collective_bytes: float = 0.0
    n_ops: int = 0
    peak_bytes: int = 0       # live bytes the step created, at their peak
    end_bytes: int = 0        # of them, still alive when the step returned


class _StepCounter(TorchDispatchMode):
    """Counts eager bytes, the bytes written into storages the step did
    not make, and the live bytes of the storages it creates, over the
    ops that touch a tensor on `device`."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.ana = TraceAnalysis()
        self.live: dict[int, int] = {}
        self.written: dict[int, int] = {}
        self.cur = 0

    def _on_device(self, tensors) -> list:
        return [t for t in tensors if isinstance(t, torch.Tensor)
                and t.device.type == self.device.type]

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        ins = self._on_device(tree_flatten((args, kwargs))[0])
        outs = self._on_device(tree_flatten(out)[0])
        if not ins and not outs:
            return out
        self.ana.n_ops += 1
        if func not in _FREE_OPS:
            self.ana.eager_bytes += sum(map(tensor_bytes, ins + outs))
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue          # in place into a storage the step made
            if any(x.untyped_storage()._cdata == key for x in ins):
                # in place into an argument: its written bytes, each
                # storage at most once
                self.written[key] = min(st.nbytes(), self.written.get(
                    key, 0) + tensor_bytes(t))
                continue
            self.live[key] = st.nbytes()
            self.cur += st.nbytes()
            self.ana.peak_bytes = max(self.ana.peak_bytes, self.cur)
            weakref.finalize(st, self._free, key)
        return out


def analyze_step(run: Callable[[], Any], device) -> tuple[TraceAnalysis,
                                                           Any]:
    """Run `run()` once under the counters, for the ops on `device`
    (meta for a plan): (its TraceAnalysis, what it returned).  The
    result is returned alive, so `end_bytes` counts what the step
    hands back (a cache, new parameters)."""
    counter = _StepCounter(torch.device(device))
    with FlopCounterMode(display=False) as flop_mode, counter:
        result = run()
    ana = counter.ana
    ana.flops = float(flop_mode.get_total_flops())
    ana.end_bytes = counter.cur
    ana.write_bytes = float(sum(counter.written.values()))
    return ana, result


def floor_bytes(argument_bytes: int, ana: TraceAnalysis) -> float:
    """The least HBM traffic of the traced step: its arguments read
    once, what it hands back (`end_bytes`) and what it writes in place
    into its arguments (`write_bytes`) written once."""
    return float(argument_bytes) + ana.end_bytes + ana.write_bytes


def collective_bytes(update_bytes: int, clients: int, mode: str) -> float:
    """Bytes a client sends in one coded mean of `update_bytes` across
    `clients` ranks (`core.dist`): naive all-gathers every update
    ((K - 1)·L), blocked and the plain mean move ~ an all-reduce
    (2·(K - 1)/K·L).  0 at one client."""
    K = clients
    if K <= 1:
        return 0.0
    if mode == "fednc_naive":
        return float((K - 1) * update_bytes)
    return 2.0 * (K - 1) / K * update_bytes


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes: float) -> dict:
    compute = flops_per_device / PEAK_FLOPS_BF16
    memory = bytes_per_device / HBM_BW
    collective = collective_bytes / ICI_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    return terms


def model_flops(n_params_active: int, tokens: int, *,
                training: bool) -> float:
    """MODEL_FLOPS = 6·N·D train (fwd+bwd), 2·N·D inference."""
    mult = 6.0 if training else 2.0
    return mult * n_params_active * tokens
