"""Serving launcher: batched requests through the MIG-scheduled engine.

Example (on the CUDA card, the reduced config):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 24 --gpus 4 --policy mfi
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import SMOKES
from repro_torch.core import mig
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.serving import Request, ServingEngine
from repro_torch.sim import distributions


def main(argv=None, device=None):
    """Parse ``argv`` (the command line when ``None``) and serve on
    ``device`` (``None`` means the CUDA card)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="mfi")
    ap.add_argument("--distribution", default="uniform")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = SMOKES[args.arch]
    params = model.init_params(cfg, torch.Generator(dev).manual_seed(args.seed), device=dev)
    rng = np.random.default_rng(args.seed)

    profiles = distributions.sample_profiles(args.distribution, args.requests, rng)
    requests = [
        Request(
            request_id=i,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens,
            profile=mig.PROFILE_NAMES[profiles[i]],
        )
        for i in range(args.requests)
    ]

    engine = ServingEngine(
        cfg, params, num_slots=args.slots,
        max_len=args.prompt_len + args.new_tokens + 1,
        num_gpus=args.gpus, policy=args.policy, device=dev,
    )
    t0 = time.time()
    stats = engine.run(requests)
    dt = time.time() - t0
    done = sum(r.finished and r.admitted for r in requests)
    toks = sum(len(r.output or []) for r in requests)
    print(f"[serve] policy={args.policy} served={done}/{args.requests} "
          f"tokens={toks} in {dt:.1f}s ({toks/max(dt,1e-9):.1f} tok/s)")
    print(f"[serve] scheduler stats: {stats}")


if __name__ == "__main__":
    main()
