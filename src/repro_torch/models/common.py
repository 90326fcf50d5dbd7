"""Shared layer library: parameter definitions, norms, RoPE, attention.

The port's counterpart of the JAX package's ``models/common.py`` for the
serving path:

* every parameter is declared once as a :class:`ParamDef` and
  :func:`materialize` draws the whole tree with the reference's scheme
  (normal × ``scale / sqrt(fan_in)``, zeros, ones, per-leaf dtype
  override) from an explicit ``torch.Generator``;
* activations keep the reference's layouts: (batch, seq, ...), attention
  heads (B, S, H, D), KV caches (B, S, KV, D);
* prefill attention (:func:`blockwise_attention`) is plain torch, as the
  reference's is plain jnp; single-token decode attention
  (:func:`decode_gqa_attention`) goes through the hand-written
  ``decode_attention`` kernel's wrapper.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops

# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"  # "normal" | "zeros" | "ones"
    scale: float = 1.0    # stddev multiplier for "normal" (fan-in applied)
    dtype: Optional[str] = None  # override model dtype (e.g. norms in f32)


def materialize(tree, dtype: torch.dtype, generator: Optional[torch.Generator],
                device: torch.device):
    """ParamDef tree -> tree of tensors on ``device``.

    Leaves are drawn in sorted-key order, each as float32 normals on the
    generator's device, then scaled, cast and moved.  ``device="meta"``
    builds the shapes and dtypes without memory or a generator.
    """
    def leaf(d: ParamDef) -> torch.Tensor:
        dt = getattr(torch, d.dtype) if d.dtype else dtype
        if device.type == "meta":
            return torch.empty(d.shape, dtype=dt, device=device)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * std).to(device=device, dtype=dt)

    def walk(t):
        if isinstance(t, ParamDef):
            return leaf(t)
        return {k: walk(t[k]) for k in sorted(t)}

    return walk(tree)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rms_norm_def(d: int) -> ParamDef:
    return ParamDef((d,), init="zeros", dtype="float32")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D); positions (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (B, S, half)
    angles = angles[..., None, :]                  # (B, S, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def blockwise_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
) -> torch.Tensor:
    """Causal GQA attention of a prompt at scale ``D ** -0.5`` (the
    forward of the reference's flash attention, whose backward the serving
    path never runs).

    Logits and softmax statistics are float32; the unnormalised
    probabilities are cast to v's dtype for the value product, which
    accumulates in float32, and the sum is divided by the normaliser — the
    reference's arithmetic when the prompt fits one of its KV tiles
    (``attn_blk`` = 512 keys), and its result up to rounding otherwise.
    """
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * d ** -0.5
    pos = torch.arange(s, device=q.device)
    logits = logits.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)  # finite: every query sees key 0
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float()) / l
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def decode_gqa_attention(
    q: torch.Tensor,        # (B, H, D) single token
    k_cache: torch.Tensor,  # (B, C, KV, D) linear cache
    v_cache: torch.Tensor,
    length: torch.Tensor,   # (B,) int32: pos + 1
) -> torch.Tensor:
    """Single-token decode attention over a linear KV cache.

    The reference masks slot ``i`` of a linear cache valid when
    ``kv_pos = i <= pos``, i.e. when ``i < pos + 1``: exactly the
    ``decode_attention`` kernel's per-row length mask with
    ``length = pos + 1``.  So this calls the kernel's wrapper, which
    launches the CUDA kernel for CUDA tensors (its plain version on the
    CPU).  Ring caches (sliding-window layers) are not served here.
    """
    return decode_ops.gqa_decode_attention(q, k_cache, v_cache, length)


def mask_padded_logits(logits: torch.Tensor, valid_vocab: int) -> torch.Tensor:
    """-1e30 over embedding-padding rows (see ModelConfig.padded_vocab)."""
    v = logits.shape[-1]
    if v == valid_vocab:
        return logits
    mask = torch.arange(v, device=logits.device) < valid_vocab
    return torch.where(mask, logits, torch.full_like(logits, -1e30))
