"""Dry run: plan every (architecture x input shape) against one H100.

The port of `repro.launch.dryrun`.  The reference lowers and compiles
each pair for a 512-chip TPU mesh and reads XLA's memory and cost
analyses.  The port has one card and no compiler: it builds the
parameters, optimizer state, inputs and caches on the meta device (no
bytes), runs the pair's step once under `roofline.analyze_step`, and
records the FLOPs, the eager and the floor bytes (`roofline.floor_bytes`)
and the roofline terms of that step, and a memory plan: the argument bytes (parameters, optimizer state, caches,
inputs), the step's own bytes at their peak, and whether the sum fits
the card (80 GB, or the card's ``total_memory`` when one is present).
Nothing touches a device.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape decode_32k [--agg fednc_naive] [--out PATH]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

A pair is planned at full width and full depth.  Its counts come from
one trace of the whole step where that is quick; a model of more than
three groups of its repeated layer pattern is traced at two and at
three groups and extended linearly to all of them (`extend`: every group
dispatches the same ops), and a model whose step loops over tokens in
Python (xLSTM's sLSTM) at TRACE_SEQ and 2·TRACE_SEQ tokens and extended
to the sequence.  The record's ``planned_by`` says which.  The argument
bytes are always those of the whole model.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from dataclasses import replace
from typing import Any, Optional

import torch

from repro_torch import obs
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import HBM_BYTES, PRODUCTION_AXES, num_clients
from repro_torch.launch.sharding import tree_paths
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

DEFAULT_OUT = "EXPERIMENTS/dryrun_torch_results.json"
BIG_MODEL = 3e10          # above this many parameters Adam's state is bf16
MESH = "1x1"
#: the tokens of one traced unit of a model that loops over tokens
TRACE_SEQ = 512
#: block kinds whose step loops over tokens in Python
TOKEN_LOOP_KINDS = ("slstm",)
NOT_ON_ONE_CARD = {
    "multi_pod": "--multi-pod: the port runs on one card (world size 1); "
                 "the reference's 2 x 16 x 16 TPU mesh has no counterpart",
    "moe_shard": "--moe-shard dff: expert weights are not sharded on one "
                 "card (mesh (data, model) = (1, 1))",
    "moe_act_shard": "--moe-act-shard: the reference's TPU-mesh knob for "
                     "dispatched activations; one card has no mesh to pin",
    "grad_kshard": "--grad-kshard: pins the client stack to a TPU mesh "
                   "axis; the identity on one card",
    "keep_hlo": "--keep-hlo: the port compiles no HLO (an eager step is "
                "traced on the meta device)",
    "attn_bf16": "--attn-bf16: ATTEND_BF16 is a deliberate non-port "
                 "(ROADMAP.md §3): the port's _attend is float32",
}


def count_params(tree: Any) -> int:
    return sum(t.numel() for _, t in tree_paths(tree))


def count_active_params(tree: Any, cfg) -> int:
    """Active params per token: routed experts scaled by top_k/E."""
    total = 0.0
    for name, leaf in tree_paths(tree):
        n = float(leaf.numel())
        if cfg.moe is not None and "moe/w_" in name:
            n *= cfg.moe.top_k / cfg.moe.num_experts
        total += n
    return int(total)


def memory_limit() -> int:
    """The card's memory: its ``total_memory`` when one is present, else
    80 GB (85,899,345,920 bytes)."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return HBM_BYTES


def init_params(cfg, device="meta") -> dict:
    """The parameters of `cfg` (on the meta device: shapes and dtypes)."""
    return tf.init_lm(torch.Generator().manual_seed(0), cfg, device=device)


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree."""
    return sum(rl.tensor_bytes(t) for _, t in tree_paths(tree))


def _argument_sizes(cfg, params: dict, kind: str, batch: int, seq: int, *,
                    cache_len: Optional[int], window: Optional[int],
                    mem_len: int, state_dtype, device):
    """(the step's arguments as a dict of trees, their bytes by kind)."""
    mem = ({"memory": sp.sds((batch, mem_len, cfg.d_model), cfg.dtype,
                             device)} if sp.needs_memory(cfg) else {})
    args = {"params": params}
    if kind == "train":
        args["opt_state"] = adamw(1e-4, state_dtype=state_dtype).init(params)
        args["inputs"] = {"tokens": sp.sds((batch, seq), torch.long, device),
                          "labels": sp.sds((batch, seq), torch.long, device),
                          **mem}
    elif kind == "prefill":
        args["inputs"] = {"tokens": sp.sds((batch, seq), torch.long, device),
                          **mem}
    elif kind == "decode":
        args["cache"] = tf.make_decoder_cache(cfg, batch, cache_len or seq,
                                              window, mem_len, device=device)
        args["inputs"] = {"token": sp.sds((batch, 1), torch.long, device)}
    else:
        raise ValueError(f"unknown step kind {kind!r}")
    sizes = {"param_bytes": tree_bytes(params),
             "opt_state_bytes": (tree_bytes(args["opt_state"].slots)
                                 if kind == "train" else 0),
             "cache_bytes": tree_bytes(args.get("cache", [])),
             "input_bytes": tree_bytes(args["inputs"])}
    return args, sizes


def opt_state_dtype(n_params: int):
    """Adam's moments: bf16 above BIG_MODEL parameters, else float32."""
    return torch.bfloat16 if n_params > BIG_MODEL else torch.float32


def trace_step(cfg, params: dict, kind: str, batch: int, seq: int, *,
               cache_len: Optional[int] = None, window: Optional[int] = None,
               mem_len: int = 0, clients: int = 1,
               agg_mode: str = "fednc_naive", agg_bf16: bool = False,
               state_dtype=None, device="meta"):
    """Run one step of `kind` (train | prefill | decode) of `cfg` on
    `params` under `roofline.analyze_step`: train and prefill take
    (batch, seq) ids (and (batch, mem_len, d) memory with a frontend);
    decode takes one token against a cache of `cache_len` (default seq)
    slots.  Returns (TraceAnalysis, argument bytes by kind)."""
    if state_dtype is None:
        state_dtype = opt_state_dtype(count_params(params))
    args, sizes = _argument_sizes(cfg, params, kind, batch, seq,
                                  cache_len=cache_len, window=window,
                                  mem_len=mem_len, state_dtype=state_dtype,
                                  device=device)
    inputs = args["inputs"]
    if kind == "train":
        step = make_train_step(cfg, adamw(1e-4, state_dtype=state_dtype),
                               num_clients=clients, agg_mode=agg_mode,
                               agg_bf16=agg_bf16, window=window)
        gen = torch.Generator().manual_seed(0)

        def run():
            return step(params, args["opt_state"], inputs, gen)
    elif kind == "prefill":
        step = make_prefill_step(cfg, cache_len=cache_len or seq,
                                 window=window)

        def run():
            return step(params, inputs)
    else:
        step = make_serve_step(cfg, window=window)

        def run():
            return step(params, args["cache"], inputs["token"])
    ana, _ = rl.analyze_step(run, device)
    if kind == "train":
        ana.collective_bytes = rl.collective_bytes(
            sizes["param_bytes"], clients, agg_mode)
    return ana, sizes


def make_plan(ana: rl.TraceAnalysis, sizes: dict, tokens: int) -> dict:
    """{"tokens", "trace_analysis", "roofline", "memory_plan"} of a
    traced step and its argument bytes."""
    args = sum(sizes.values())
    peak = args + ana.peak_bytes
    limit = memory_limit()
    floor = rl.floor_bytes(args, ana)
    roofline = rl.roofline_terms(ana.flops, floor, ana.collective_bytes)
    roofline["eager_memory_s"] = ana.eager_bytes / rl.HBM_BW
    return {
        "tokens": tokens,
        "trace_analysis": {
            "flops_per_device": ana.flops,
            "floor_bytes_per_device": floor,
            "eager_bytes_per_device": ana.eager_bytes,
            "write_bytes_per_device": ana.write_bytes,
            "collective_bytes_per_device": ana.collective_bytes,
            "n_ops": ana.n_ops,
        },
        "roofline": roofline,
        "memory_plan": {
            **sizes, "argument_bytes": args,
            "step_peak_bytes": ana.peak_bytes,
            "output_bytes": ana.end_bytes,
            "peak_bytes": peak, "limit_bytes": limit, "fits": peak <= limit,
        },
    }


def plan_step(cfg, params: dict, kind: str, batch: int, seq: int,
              **kw) -> dict:
    """The plan of one step, traced whole (`trace_step`, `make_plan`)."""
    ana, sizes = trace_step(cfg, params, kind, batch, seq, **kw)
    return make_plan(ana, sizes, batch if kind == "decode" else batch * seq)


def bound_s(plan: dict) -> float:
    """The least time of a planned step: its largest roofline term (the
    memory term over the floor bytes, not the eager ones)."""
    r = plan["roofline"]
    return max(r["compute_s"], r["memory_s"], r["collective_s"])


def extend(a: rl.TraceAnalysis, b: rl.TraceAnalysis,
           steps: int) -> rl.TraceAnalysis:
    """The counts `steps` units past trace b, where trace b ran one unit
    more than trace a and each unit adds the same ops (a group of the
    repeated layer pattern, or TRACE_SEQ tokens of a model linear in the
    sequence): b + steps·(b - a), for FLOPs, bytes, ops, and the step's
    own bytes at their peak and at its end (exact for the peak once it
    falls at the same place in each unit: after the first group of a
    prefill, whose peak sits elsewhere, so depth is traced at 2 and 3
    groups)."""
    out = rl.TraceAnalysis()
    for key in ("flops", "eager_bytes", "write_bytes", "collective_bytes",
                "n_ops", "peak_bytes", "end_bytes"):
        x, y = getattr(a, key), getattr(b, key)
        setattr(out, key, type(x)(y + steps * (y - x)))
    return out


def depth_config(cfg, groups: int):
    """`cfg` with `groups` repetitions of its scan pattern (prefix and
    suffix kept)."""
    prefix, pattern, suffix = cfg.decoder_layer_kinds()
    return cfg.with_overrides(
        num_layers=len(prefix) + groups * len(pattern) + len(suffix))


def _token_loops(cfg) -> bool:
    return any(k in TOKEN_LOOP_KINDS for k in tf.layer_kinds(cfg))


def run_pair(arch: str, shape_name: str, *,
             agg_mode: str = "fednc_naive",
             mla_absorbed: bool = False,
             agg_bf16: bool = False,
             q_chunk: int = 0,
             variant: str = "baseline") -> dict:
    """Plan one (arch, shape) at full width and depth on the one-card
    mesh."""
    from repro_torch.models import attention as attn_mod
    t0 = obs.clock()
    cfg = get_config(arch)
    if mla_absorbed and cfg.mla is not None:
        cfg = cfg.with_overrides(mla=replace(cfg.mla, absorbed=True))
    shape = sp.SHAPES[shape_name]
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": MESH, "chips": 1,
        "agg_mode": agg_mode if shape.kind == "train" else None,
        "variant": variant, "status": "started",
    }
    params = init_params(cfg)
    n_params = count_params(params)
    n_active = count_active_params(params, cfg)
    rec["n_params"] = n_params
    rec["n_active_params"] = n_active
    window = None if shape.kind == "train" else sp.decode_window(cfg, shape)
    mem_len = sp.memory_len(cfg, shape) if sp.needs_memory(cfg) else 0
    B, S = shape.global_batch, shape.seq_len
    kw = dict(cache_len=S, window=window, mem_len=mem_len,
              clients=num_clients(PRODUCTION_AXES), agg_mode=agg_mode,
              agg_bf16=agg_bf16, state_dtype=opt_state_dtype(n_params))
    _, sizes = _argument_sizes(cfg, params, shape.kind, B, S,
                               cache_len=S, window=window, mem_len=mem_len,
                               state_dtype=kw["state_dtype"], device="meta")
    del params
    groups = cfg.n_scan_groups()
    saved = attn_mod.Q_CHUNK
    if q_chunk:
        attn_mod.Q_CHUNK = q_chunk
    try:
        if shape.kind != "decode" and _token_loops(cfg) and S > TRACE_SEQ:
            units = S // TRACE_SEQ
            a, b = (trace_step(cfg, init_params(cfg), shape.kind, B,
                               n * TRACE_SEQ, **kw)[0] for n in (1, 2))
            ana = extend(a, b, units - 2)
            rec["planned_by"] = (f"sequence: traced at {TRACE_SEQ} and "
                                 f"{2 * TRACE_SEQ} tokens, extended to {S}")
        elif groups > 3:
            a, b = (trace_step(depth_config(cfg, g),
                               init_params(depth_config(cfg, g)),
                               shape.kind, B, S, **kw)[0] for g in (2, 3))
            ana = extend(a, b, groups - 3)
            rec["planned_by"] = (f"depth: traced at 2 and 3 of {groups} "
                                 f"groups of {list(cfg.scan_pattern)}, "
                                 f"extended")
        else:
            ana = trace_step(cfg, init_params(cfg), shape.kind, B, S,
                             **kw)[0]
            rec["planned_by"] = "trace"
    finally:
        attn_mod.Q_CHUNK = saved
    plan = make_plan(ana, sizes, B if shape.kind == "decode" else B * S)
    rec["trace_s"] = round(obs.clock() - t0, 2)
    rec.update(plan)
    rec["tokens_per_step"] = rec.pop("tokens")
    rec["model_flops"] = rl.model_flops(n_active, rec["tokens_per_step"],
                                        training=shape.kind == "train")
    flops = rec["trace_analysis"]["flops_per_device"]
    if flops > 0:
        rec["useful_flops_ratio"] = rec["model_flops"] / flops
    rec["bound_s"] = bound_s(plan)
    rec["status"] = "ok"
    return rec


def append_result(rec: dict, out_path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    # replace any previous record for the same key
    keyf = ("arch", "shape", "mesh", "agg_mode", "variant")
    results = [r for r in results
               if tuple(r.get(k) for k in keyf)
               != tuple(rec.get(k) for k in keyf)]
    results.append(rec)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)


def summary(rec: dict) -> str:
    """One line: bound, bottleneck, planned peak, fits."""
    r, mp = rec["roofline"], rec["memory_plan"]
    return (f"bound {rec['bound_s']:.6e} s ({r['bottleneck']}; compute "
            f"{r['compute_s']:.3e} s, memory {r['memory_s']:.3e} s; eager "
            f"bytes {r['eager_memory_s']:.3e} s), planned "
            f"peak {mp['peak_bytes'] / 2**30:.2f} GiB of "
            f"{mp['limit_bytes'] / 2**30:.2f}, fits {mp['fits']}"
            + f" [{rec['planned_by']}]")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(sp.SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--agg", default="fednc_naive",
                    choices=["plain", "fednc_naive", "fednc_blocked"])
    ap.add_argument("--all", action="store_true",
                    help="plan every (arch x shape) on this mesh")
    ap.add_argument("--keep-hlo", action="store_true")
    ap.add_argument("--moe-shard", default="dmodel",
                    choices=["dmodel", "dff"])
    ap.add_argument("--mla-absorbed", action="store_true")
    ap.add_argument("--attn-bf16", action="store_true")
    ap.add_argument("--moe-act-shard", action="store_true")
    ap.add_argument("--grad-kshard", action="store_true")
    ap.add_argument("--agg-bf16", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=0)
    ap.add_argument("--variant", default="baseline",
                    help="label for iteration records")
    ap.add_argument("--out", default=DEFAULT_OUT)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refused = {"multi_pod": args.multi_pod, "keep_hlo": args.keep_hlo,
               "moe_shard": args.moe_shard != "dmodel",
               "attn_bf16": args.attn_bf16,
               "moe_act_shard": args.moe_act_shard,
               "grad_kshard": args.grad_kshard}
    for name, given in refused.items():
        if given:
            raise ValueError(NOT_ON_ONE_CARD[name])
    if args.all:
        pairs = [(a, s) for a in ARCHITECTURES for s in sp.SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        raise SystemExit("give --arch and --shape, or --all")

    n_ok = 0
    t0 = obs.clock()
    for arch, shape in pairs:
        label = f"{arch} x {shape} ({MESH})"
        try:
            rec = run_pair(arch, shape, agg_mode=args.agg,
                           mla_absorbed=args.mla_absorbed,
                           agg_bf16=args.agg_bf16, q_chunk=args.q_chunk,
                           variant=args.variant)
            n_ok += 1
            print(f"[OK] {label}: {summary(rec)} (traced in "
                  f"{rec['trace_s']} s)", flush=True)
        except Exception as e:      # a failed pair is recorded, not fatal
            rec = {"arch": arch, "shape": shape, "mesh": MESH,
                   "agg_mode": args.agg, "variant": args.variant,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-3000:]}
            print(f"[FAIL] {label}: {type(e).__name__}: {e}", flush=True)
        append_result(rec, args.out)
    print(f"done: {n_ok}/{len(pairs)} ok in {obs.clock() - t0:.1f} s",
          flush=True)
    return 0 if n_ok == len(pairs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
