"""The training step of the dense, vlm and moe families, without sharding rules.

``train_step(params, opt_state, batch, cfg)`` is the train branch of the
reference's ``launch/steps.py::build_step``: loss and gradients (over
``cfg.grad_accum`` micro-batches), the cosine schedule at the optimizer's
step, and AdamW.  ``build_step``, ``rules_for`` and the prefill/decode
lowerings wait for the launch tooling (ROADMAP.md §1 item 13).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw_update, cosine_schedule


def loss_and_grads(params: Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss (detached) and its gradient by parameter name."""
    with params.trainable():
        named = dict(params.named_parameters())
        loss = model.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


def train_step(params: Transformer, opt_state, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig):
    """One optimizer step; ``params`` and the moments are updated in place.
    Returns ``(params, opt_state, {"loss": float32 tensor})``.

    With ``cfg.grad_accum = na > 1`` the batch splits into ``na``
    consecutive micro-batches; the loss accumulates ``loss / na`` in
    float32 and the gradients ``g / na`` in the parameters' dtype, from
    zeros, as the reference's scan does.
    """
    na = cfg.grad_accum
    if na == 1:
        loss, grads = loss_and_grads(params, batch, cfg)
    else:
        micro = {k: v.reshape((na, v.shape[0] // na) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=params.embed.device)
        grads = {k: torch.zeros_like(p) for k, p in params.named_parameters()}
        for i in range(na):
            l, g = loss_and_grads(params, {k: v[i] for k, v in micro.items()}, cfg)
            loss = loss + l / na
            for k, acc in grads.items():
                acc.add_(g[k] / na)
    lr = cosine_schedule(opt_state["step"], peak_lr=3e-4, warmup=2000, total=100_000)
    params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
    return params, opt_state, {"loss": loss}
