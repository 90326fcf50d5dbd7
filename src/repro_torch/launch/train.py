"""Training launcher: real steps of any model family on one device.

Example (on the CUDA card, the reduced config):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --steps 50 --batch 8 --seq 128
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.data import make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import model
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule


def train_loop(params, cfg, *, steps: int, batch: int, seq: int, lr: float, seed: int,
               log_every: int):
    """``steps`` AdamW steps on the synthetic stream of ``seed`` from
    ``params`` (updated in place), warm-up 10 and a cosine to ``steps``;
    prints the reference launcher's step lines.  Returns ``(params,
    opt_state, losses)``."""
    device = params.embed.device
    opt = adamw_init(params, cfg.opt_dtype)
    data = make_batch_iterator(cfg, batch, seq, seed=seed)
    t0 = time.time()
    losses = []
    for i in range(steps):
        b = {k: torch.as_tensor(v, device=device) for k, v in next(data).items()}
        loss, grads = loss_and_grads(params, b, cfg)
        rate = cosine_schedule(opt["step"], peak_lr=lr, warmup=10, total=steps)
        params, opt = adamw_update(params, grads, opt, lr=rate)
        losses.append(float(loss))
        if i % log_every == 0 or i == steps - 1:
            print(f"[train] step {i:4d} loss {losses[-1]:.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    return params, opt, losses


def main(argv=None, device=None):
    """Parse ``argv`` (the command line when ``None``) and train on
    ``device`` (``None`` means the CUDA card).  Returns whether the loss of
    the last five steps fell below that of the first five."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = SMOKES[args.arch] if args.smoke else ARCHS[args.arch]
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    params = model.init_params(cfg, torch.Generator(dev).manual_seed(args.seed), device=dev)
    params, _, losses = train_loop(params, cfg, steps=args.steps, batch=args.batch,
                                   seq=args.seq, lr=args.lr, seed=args.seed,
                                   log_every=args.log_every)

    if args.checkpoint:
        save_checkpoint(args.checkpoint, model.params_to_tree(params, cfg), step=args.steps)
        print(f"[train] saved checkpoint to {args.checkpoint}")

    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'LEARNING' if last < first - 0.1 else 'flat'})")
    return last < first


if __name__ == "__main__":
    main()
