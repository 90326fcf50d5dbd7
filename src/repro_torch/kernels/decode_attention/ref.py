"""Plain torch version of the ``decode_attention`` kernel.

One new query token per batch row attends to a GQA KV cache: ``q (B, H, D)``
against ``k, v (B, S, K, D)``, ``H = G·K`` (query head ``h`` reads KV head
``h // G``), keys ``t < length[b]`` valid.  Logits, softmax and the weighted
sum are float32 whatever the input type; the result is cast to q's dtype.

A row with no valid key gives 0, as the TPU kernel does (its normaliser
``l == 0`` is replaced by 1); a plain softmax over all ``-inf`` would give
NaN there.  The wrapper in ``decode_attention.py`` uses this function for
CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel against it.
"""

from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,  # (B, S, K, D)
    length: torch.Tensor,  # (B,) int32 valid KV length
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, h, d = q.shape
    s, kheads = k.shape[1], k.shape[2]
    if h % kheads:
        raise ValueError(f"query heads {h} not divisible by KV heads {kheads}")
    g = h // kheads
    if scale is None:
        scale = d ** -0.5

    qf = q.float().reshape(b, kheads, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < length.to(q.device).long()[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)  # exp(-inf) = 0 on the masked keys
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, h, d).to(q.dtype)
