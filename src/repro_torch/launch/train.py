"""FL-LM training driver.

The port of `repro.launch.train`: federated training of an --arch
config on one device.  The global batch splits into K client shards,
each computes its gradient, FedNC codes the K gradients across the
client axis, and the decoded mean updates the global model (AdamW,
linear warm-up over 10 steps then cosine).  Tokens come from the
planted-bigram stream of `data.tokens` (seed 0); a config with a
frontend (Llama-3.2-Vision, SeamlessM4T) is fed zero memory embeddings
(batch, `num_frontend_tokens`, d_model), as the reference feeds it.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 50 --batch 8 --seq 128 --agg fednc_blocked

trains the default architecture, `xlstm-125m` (its reduced config);
``--arch`` names another (`qwen3-4b`, `recurrentgemma-9b`, ...).  It
runs on ``--device`` (``cuda`` by default; ``--device cpu`` runs the
kernels' plain versions).  The mesh flags keep the reference's names;
one card is the mesh (`launch.mesh`: --mesh-data 0 or 1, --mesh-model
1), and a larger one raises.
"""
from __future__ import annotations

import argparse
import gc
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.packets import tree_flatten
from repro_torch.data.tokens import make_token_stream
from repro_torch.launch.mesh import check_one_card
from repro_torch.launch.steps import AGG_MODES, make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, linear_warmup_cosine

SEED = 0          # initial weights, the token stream and the mixing draws


@dataclass
class TrainRun:
    params: Any
    opt_state: Any
    losses: list[float] = field(default_factory=list)
    step_s: list[float] = field(default_factory=list)   # synchronized


def train(cfg, params, *, steps: int, batch: int, seq: int,
          clients: int = 4, agg: str = "fednc_blocked", lr: float = 3e-4,
          log_every: int = 10, log: Callable[[str], None] = print
          ) -> TrainRun:
    """The driver's loop: `steps` FedNC steps of `params` (on their
    device) over the token stream.  Each step's wall ends when its loss
    reaches the host, so it covers the device's work."""
    device = params["embed"]["table"].device
    opt = adamw(linear_warmup_cosine(lr, 10, steps))
    step_fn = make_train_step(cfg, opt, num_clients=clients, agg_mode=agg)
    stream = make_token_stream(cfg.vocab_size, seed=SEED)
    gen = torch.Generator().manual_seed(SEED)
    run = TrainRun(params, opt.init(params))
    del params            # the run holds the weights each step replaces
    t0 = obs.clock()
    for i in range(steps):
        b = stream.batch(batch, seq)
        tb = {k: torch.from_numpy(v).long().to(device) for k, v in b.items()}
        if cfg.frontend:
            tb["memory"] = torch.zeros(
                (batch, cfg.num_frontend_tokens, cfg.d_model),
                dtype=cfg.dtype, device=device)
        ts = obs.clock()
        run.params, run.opt_state, loss = step_fn(run.params, run.opt_state,
                                                  tb, gen)
        run.losses.append(float(loss))
        run.step_s.append(obs.clock() - ts)
        if i == 0:
            # the first remat call imports torch's compiler stack, and
            # an import there leaves the calling frames in a reference
            # cycle that holds the step's gradient stack until the
            # collector runs: free it before the next step allocates
            gc.collect()
        if (i + 1) % log_every == 0:
            dt = obs.clock() - t0
            log(f"step {i + 1:5d} loss="
                f"{np.mean(run.losses[-log_every:]):.4f} "
                f"({dt / (i + 1):.2f}s/step)")
    log(f"final loss {np.mean(run.losses[-5:]):.4f} "
        f"(first {np.mean(run.losses[:5]):.4f})")
    return run


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--agg", default="fednc_blocked", choices=AGG_MODES)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data axis size (0 = all devices: one card)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main(argv=None) -> TrainRun:
    args = build_parser().parse_args(argv)
    # the data axis spans every device (0): one card here
    check_one_card(args.mesh_data or 1, args.mesh_model)
    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    device = torch.device(args.device)
    print(f"arch={cfg.name} device={device} agg={args.agg} "
          f"clients={args.clients}")
    params = tf.init_lm(torch.Generator(device=device).manual_seed(SEED),
                        cfg, device=device)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    print(f"n_params={n_params / 1e6:.1f}M")
    run = train(cfg, params, steps=args.steps, batch=args.batch,
                seq=args.seq, clients=args.clients, agg=args.agg,
                lr=args.lr, log_every=args.log_every,
                log=lambda s: print(s, flush=True))
    if args.ckpt:
        from repro_torch.checkpoint import save_pytree
        save_pytree(args.ckpt, run.params,
                    metadata={"arch": cfg.name, "steps": args.steps})
        print("saved", args.ckpt)
    return run


if __name__ == "__main__":
    main()
