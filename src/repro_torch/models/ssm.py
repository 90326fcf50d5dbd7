"""Mamba-2 (SSD, state-space duality) block: the chunked scan for training
and prefill, and the O(1)-state decode step.  [arXiv:2405.21060]

The port's counterpart of the JAX package's ``models/ssm.py``.  The
sequence splits into chunks of Q tokens: within a chunk the SSD is a
masked, decayed attention-like product (the "quadratic mode"), and a
(B, H, N, P) state carries the chunks' contributions across chunks (the
"linear mode"), as a Python loop over the chunks where the reference runs
``lax.scan``.  Plain torch, as the reference is plain jnp: neither
reaches a hand-written kernel.

The reference's dtype placement is kept, because it moves the bits in
bfloat16: the depthwise conv runs in float32 and is cast back to the
model dtype; in prefill ``silu`` then runs on the cast conv output, in
decode it runs in float32 before the cast.  ``softplus`` is
``logaddexp(x, 0)`` (``jax.nn.softplus``).  The scan itself is float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import sharding
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

ParamDef = common.ParamDef


def ssm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The reference's per-segment projections (z / x / BC / dt), the two
    depthwise convs with their biases, float32 ``a_log``/``d_skip``/
    ``dt_bias``, the gated norm and the output projection."""
    d = cfg.d_model
    di = cfg.ssm_dinner
    n = cfg.ssm_state
    h = cfg.ssm_nheads
    cw = cfg.conv_width
    return {
        "w_z": ParamDef((d, di), ("dmodel", "ssm_inner")),
        "w_x": ParamDef((d, di), ("dmodel", "ssm_inner")),
        "w_bc": ParamDef((d, 2 * n), ("dmodel", None)),   # shared across heads
        "w_dt": ParamDef((d, h), ("dmodel", "ssm_heads")),
        "conv_x": ParamDef((cw, di), (None, "ssm_inner"), scale=1.0),
        "conv_bc": ParamDef((cw, 2 * n), (None, None), scale=1.0),
        "conv_b_x": ParamDef((di,), ("ssm_inner",), init="zeros"),
        "conv_b_bc": ParamDef((2 * n,), (None,), init="zeros"),
        "a_log": ParamDef((h,), ("ssm_heads",), init="zeros", dtype="float32"),
        "d_skip": ParamDef((h,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros", dtype="float32"),
        "norm": common.rms_norm_def(di),
        "out_proj": ParamDef((di, d), ("ssm_inner", "dmodel")),
    }


def _project(p, x: torch.Tensor, cfg: ModelConfig):
    """x (B, L, D) -> (z, xs, B, C, dt), the inner channels split over
    ``ssm_inner`` and the heads over ``ssm_heads``; the weights gathered
    over the FSDP shard at the use site (``transformer._gathered``)."""
    n = cfg.ssm_state

    def g(w, ax):
        return sharding.constraint(w, None, ax)

    z = sharding.constraint(x @ g(p.w_z, "ssm_inner"), "batch", None, "ssm_inner")
    xs = sharding.constraint(x @ g(p.w_x, "ssm_inner"), "batch", None, "ssm_inner")
    bc = x @ g(p.w_bc, None)
    dt = sharding.constraint(x @ g(p.w_dt, "ssm_heads"), "batch", None, "ssm_heads")
    return z, xs, bc[..., :n], bc[..., n:], dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by explicit shifts, summed in float32 in the
    reference's order and cast back. x: (B, L, C), w: (W, C)."""
    cw, length = w.shape[0], x.shape[1]
    xf, wf = x.float(), w.float()
    out = torch.zeros_like(xf)
    for k in range(cw):
        shift = cw - 1 - k
        xk = torch.nn.functional.pad(xf, (0, 0, shift, 0))[:, :length]
        out = out + xk * wf[k]
    return (out + b.float()).to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_scan(x_c: torch.Tensor, dt_c: torch.Tensor, a: torch.Tensor, b_c: torch.Tensor,
             c_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD in float32 over ``nc`` chunks of ``Q`` tokens.

    x_c (B, nc, Q, H, P), dt_c (B, nc, Q, H), a (H,) negative, b_c and c_c
    (B, nc, Q, N) (one group, shared by the heads).  Returns the output
    without the skip term, (B, nc, Q, H, P), and the state after the last
    chunk, (B, H, N, P).

    The reference's products in a heads-first layout: the intra-chunk
    scores are (B, nc, H, Q, Q), so both chunk products are batched
    matrix products with no transposed copy of them, and its two
    three-operand contractions are taken one product at a time, so no
    (B, nc, Q, H, N, P) intermediate forms (~670 MB a chunk at
    mamba2-2.7b's widths).
    """
    bsz, nc, q, h, pdim = x_c.shape
    n = b_c.shape[-1]
    dt_t = dt_c.transpose(2, 3)                 # (B, nc, H, Q)
    cum = torch.cumsum(dt_t * a[:, None], dim=-1)  # inclusive
    total = cum[..., -1:]                       # (B, nc, H, 1)
    x_t = x_c.permute(0, 1, 3, 2, 4)            # (B, nc, H, Q, P)

    # intra-chunk: y_i = sum_j (C_i · B_j) · exp(cum_i - cum_j) · dt_j x_j, i >= j,
    # with dt_j folded into x_j, so the (B, nc, H, Q, Q) tensors are the
    # decay (in the exponent's buffer) and the scores only
    cb = c_c @ b_c.transpose(-1, -2)            # (B, nc, Q, Q)
    seg = cum[..., :, None] - cum[..., None, :]  # (B, nc, H, Qi, Qj)
    mask = torch.ones((q, q), dtype=torch.bool, device=x_c.device).tril()
    # mask the exponent, not the result: exp of a masked entry would be inf
    # and the backward pass would carry inf · 0
    decay = seg.masked_fill_(~mask, float("-inf")).exp_()
    y = (cb[:, :, None] * decay) @ (dt_t[..., None] * x_t)  # (B, nc, H, Q, P)

    # each chunk's state: sum_j exp(total - cum_j)·dt_j · B_j ⊗ x_j
    w_j = torch.exp(total - cum) * dt_t         # (B, nc, H, Q)
    states = b_c.transpose(-1, -2)[:, :, None] @ (w_j[..., None] * x_t)  # (B, nc, H, N, P)
    chunk_decay = torch.exp(total[..., 0])      # (B, nc, H)

    # across chunks: the state before each chunk
    s = torch.zeros((bsz, h, n, pdim), dtype=torch.float32, device=x_c.device)
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(prevs, dim=1)         # (B, nc, H, N, P)

    # inter-chunk output: C_i · S_prev · exp(cum_i)
    y = y + (c_c[:, :, None] @ s_prevs) * torch.exp(cum)[..., None]
    return y.permute(0, 1, 3, 2, 4), s


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig, *, return_cache: bool = False):
    """Chunked SSD forward. x: (B, L, D) -> (B, L, D), with chunks of
    ``q = min(ssm_chunk, L)`` tokens; ``L % q`` must be 0.

    With ``return_cache=True`` also returns the decode cache: the final
    SSM state (B, H, N, P) float32 and the conv's last ``W - 1`` inputs
    before activation (B, W - 1, C), left-padded with zeros when
    ``L < W - 1``, so decoding can continue at position L.
    """
    bsz, l, _ = x.shape
    di, n, h, pdim = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    q = min(cfg.ssm_chunk, l)
    if l % q:
        raise ValueError(f"the sequence {l} is not a multiple of the SSD chunk {q}")
    nc = l // q

    z, xs, b_, c_, dt = _project(p, x, cfg)
    conv_x_in = xs
    conv_bc_in = torch.cat([b_, c_], dim=-1)
    xs = common.silu(_causal_conv(conv_x_in, p.conv_x, p.conv_b_x))
    bc = common.silu(_causal_conv(conv_bc_in, p.conv_bc, p.conv_b_bc))

    dt = softplus(dt.float() + p.dt_bias)  # (B, L, H)
    a = -torch.exp(p.a_log)                # (H,)
    # chunk views, heads split over the model axis: the intra-chunk decay
    # and score tensors are the SSD's memory hot-spot and must not replicate
    heads = ("batch", None, None, "ssm_heads")
    x_c = sharding.constraint(xs.reshape(bsz, l, h, pdim).float(), "batch", None, "ssm_heads",
                              None).reshape(bsz, nc, q, h, pdim)
    x_c = sharding.constraint(x_c, *heads, None)
    dt_c = sharding.constraint(dt.reshape(bsz, nc, q, h), *heads)
    bcf = bc.float().reshape(bsz, nc, q, 2 * n)
    y, s_last = _scan(x_c, dt_c, a, bcf[..., :n], bcf[..., n:])
    y = sharding.constraint(y, *heads, None)

    y = y + p.d_skip[None, None, :, None] * x_c
    y = y.reshape(bsz, l, di).to(x.dtype)

    # gated norm + out proj (the Mamba-2 block's tail)
    y = common.rms_norm(y * common.silu(z), p.norm)
    out = y @ sharding.constraint(p.out_proj, "ssm_inner", None)
    if not return_cache:
        return out
    cw = cfg.conv_width
    conv_in = torch.cat([conv_x_in, conv_bc_in], dim=-1)
    if l >= cw - 1:
        conv_tail = conv_in[:, l - (cw - 1):]
    else:
        conv_tail = torch.nn.functional.pad(conv_in, (0, 0, cw - 1 - l, 0))
    return out, {"state": s_last, "conv": conv_tail}


def _scan(x_c, dt_c, a, b_c, c_c):
    """:func:`ssd_scan`, on a mesh on each rank's batch rows and heads
    (``local_map``; the scan's in-place exponent and its loop over chunks
    are per row and head).  B and C are shared by the heads, so they are
    split by batch only (``sharding.local`` sums the gradients of what a
    rank reads whole and uses in part: B and C over heads, A over rows)."""
    if not sharding.is_dtensor(x_c):
        return ssd_scan(x_c, dt_c, a, b_c, c_c)
    from torch.distributed.tensor import Replicate, Shard

    xp = tuple(p if p in (Shard(0), Shard(3)) else Replicate() for p in x_c.placements)
    heads = [p == Shard(3) for p in xp]
    rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in xp)
    ap = tuple(Shard(0) if hd else Replicate() for hd in heads)
    sp = tuple(Shard(0) if p == Shard(0) else Shard(1) if hd else Replicate()
               for p, hd in zip(xp, heads))
    return sharding.local(ssd_scan, (xp, sp), (xp, xp, ap, rows, rows), x_c, dt_c, a, b_c, c_c)


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, device=None
                   ) -> Dict[str, torch.Tensor]:
    """A zero state (B, H, N, P) float32 and conv history (B, W - 1, C)."""
    di, n, h, pdim = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    return {
        "state": torch.zeros((batch, h, n, pdim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * n), dtype=dtype, device=device),
    }


def ssm_decode_step(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Single-token SSD step. x: (B, D) -> (B, D) and the new cache
    ``{"state", "conv"}`` (new tensors; the caller may write them back)."""
    bsz, _ = x.shape
    di, n, h, pdim = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim

    z, xs, b_, c_, dt = _project(p, x[:, None, :], cfg)
    z, dt = z[:, 0], dt[:, 0]
    conv_in = torch.cat([xs, b_, c_], dim=-1)[:, 0]  # (B, C)
    conv_w = torch.cat([p.conv_x, p.conv_bc], dim=-1).float()
    conv_b = torch.cat([p.conv_b_x, p.conv_b_bc], dim=-1).float()

    # conv history (B, W - 1, C) and the current token
    hist = torch.cat([cache["conv"], conv_in[:, None, :]], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", hist.float(), conv_w)
    conv_out = common.silu(conv_out + conv_b).to(x.dtype)
    new_conv = hist[:, 1:]

    xs = conv_out[:, :di]
    b_ = conv_out[:, di:di + n].float()
    c_ = conv_out[:, di + n:].float()
    dt = softplus(dt.float() + p.dt_bias)  # (B, H)
    dec = torch.exp(dt * -torch.exp(p.a_log))

    xh = xs.reshape(bsz, h, pdim).float()
    state = (cache["state"] * dec[:, :, None, None]
             + b_[:, None, :, None] * (dt[:, :, None] * xh)[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", c_, state) + p.d_skip[None, :, None] * xh
    y = y.reshape(bsz, di).to(x.dtype)
    y = common.rms_norm(y * common.silu(z), p.norm)
    return y @ p.out_proj, {"state": state, "conv": new_conv}
