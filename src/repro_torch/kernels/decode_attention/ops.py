"""Public entry of GQA decode attention, as the JAX package names it."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.decode_attention import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def gqa_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    length: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """GQA decode attention: (B,H,D) × (B,S,K,D) KV cache -> (B,H,D).

    ``length=None`` means every one of the S slots is valid.
    ``use_kernel=True`` goes through the kernel's wrapper (the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors);
    ``use_kernel=False`` runs the plain torch version on any device.
    """
    if length is None:
        length = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=q.device)
    if not use_kernel:
        return decode_attention_ref(q, k, v, length, scale=scale)
    return decode_attention(q, k, v, length, scale=scale)
