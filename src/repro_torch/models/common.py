"""Shared layer library: parameter definitions, norms, RoPE, attention, loss.

The port's counterpart of the JAX package's ``models/common.py`` for the
serving and training paths:

* every parameter is declared once as a :class:`ParamDef` and
  :func:`materialize` draws the whole tree with the reference's scheme
  (normal × ``scale / sqrt(fan_in)``, zeros, ones, per-leaf dtype
  override) from an explicit ``torch.Generator``;
* activations keep the reference's layouts: (batch, seq, ...), attention
  heads (B, S, H, D), KV caches (B, S, KV, D);
* prefill and training attention (:func:`blockwise_attention`, flash
  attention over query and KV tiles with the reference's custom backward,
  causal with an optional sliding window) is plain torch, as the
  reference's is plain jnp; single-token decode
  attention (:func:`decode_gqa_attention`) goes through the hand-written
  ``decode_attention`` kernel's wrapper;
* training adds the layer rematerialisation (:func:`remat_scan`) and the
  S-chunked cross-entropy (:func:`chunked_ce_loss`).  The reference's
  ``grad_dtype_barrier`` applies only under a sharding rule, which the
  port does not have (ROADMAP.md §1 item 13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def _tile_logits(qt, kt, scale, qstart: int, kstart: int, causal: bool,
                 window: Optional[int]):
    """Masked float32 logits of one (Q-tile, KV-tile) pair whose first query
    and key sit at positions ``qstart`` and ``kstart``.

    qt: (B, KV, G, bq, D); kt: (B, KV, bk, D) -> (B, KV, G, bq, bk).  Both
    operands are upcast before the product (the reference's
    ``preferred_element_type=float32``).  The reference's mask: a key is
    valid when ``kpos >= 0`` (left padding of the local path), when
    ``kpos <= qpos`` (causal) and, with a window, when
    ``kpos > qpos - window``.  A tile none of whose keys breaks a rule has
    nothing to mask, so the mask is built only where one does.
    """
    logits = torch.einsum("bkgqd,bksd->bkgqs", qt.float(), kt.float()) * scale
    bq, bk = qt.shape[3], kt.shape[2]
    negative = kstart < 0
    future = causal and kstart + bk - 1 > qstart
    stale = window is not None and kstart <= qstart + bq - 1 - window
    if negative or future or stale:
        qpos = qstart + torch.arange(bq, device=qt.device)[:, None]
        kpos = kstart + torch.arange(bk, device=qt.device)[None, :]
        valid = kpos >= 0
        if causal:
            valid = valid & (qpos >= kpos)
        if window is not None:
            valid = valid & (kpos > qpos - window)
        logits = logits.masked_fill(~valid, float("-inf"))
    return logits


def _flash_forward(qt, kts, vts, qstart: int, kstart: int, nk: int, scale: float,
                   causal: bool, window: Optional[int]):
    """The online-softmax scan of one query tile over KV tiles ``0..nk-1``
    (tile ``j``'s first key at position ``kstart + j·bk``).
    Returns ``(o, lse)`` in float32: (B, KV, G, bq, D), (B, KV, G, bq, 1)."""
    b, kv, g, bq, d = qt.shape
    blk_k = kts.shape[3]
    dev = qt.device
    m = torch.full((b, kv, g, bq, 1), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, bq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv, g, bq, d), dtype=torch.float32, device=dev)
    for j in range(nk):
        kt, vt = kts[j], vts[j]
        logits = _tile_logits(qt, kt, scale, qstart, kstart + j * blk_k, causal, window)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(logits), torch.exp(logits - safe), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgqs,bksd->bkgqd",
                                         p.to(vt.dtype).float(), vt.float())
        m = m_new
    o = acc / torch.where(l == 0, 1.0, l)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-38)), float("-inf"))
    return o, lse


class _FlashQTile(torch.autograd.Function):
    """Flash attention of ONE query tile against the KV tiles it can see.

    The residuals are only ``(o, lse)``: the backward pass recomputes each
    tile's logits (with the same masks) from ``lse``, so autograd never
    stores (bq × bk) probabilities, and training attention memory stays
    O(S·D) rather than O(S²).  ``kts``/``vts`` hold KV tiles, (nk, B, KV,
    bk, D), the first key of tile ``j`` at position ``kstart + j·bk``; only
    the first ``nk`` are read (causal tiles past the diagonal add p = 0 at
    alpha = 1, so skipping them changes no bit), and their gradients are
    zero.
    """

    @staticmethod
    def forward(ctx, qt, kts, vts, qstart: int, kstart: int, nk: int, scale: float,
                causal: bool, window: Optional[int]):
        o, lse = _flash_forward(qt, kts, vts, qstart, kstart, nk, scale, causal, window)
        ctx.save_for_backward(qt, kts, vts, o, lse)
        ctx.args = (qstart, kstart, nk, scale, causal, window)
        return o.to(qt.dtype)

    @staticmethod
    def backward(ctx, do):
        qt, kts, vts, o, lse = ctx.saved_tensors
        qstart, kstart, nk, scale, causal, window = ctx.args
        blk_k = kts.shape[3]
        dev = qt.device
        dof = do.float()
        dsum = torch.sum(dof * o, dim=-1, keepdim=True)  # (B, KV, G, bq, 1)
        qtf = qt.float()
        lse_safe = torch.where(torch.isfinite(lse), lse, 0.0)
        dq = torch.zeros(qt.shape, dtype=torch.float32, device=dev)
        dks = torch.zeros_like(kts)
        dvs = torch.zeros_like(vts)
        for j in range(nk):
            ktf, vtf = kts[j].float(), vts[j].float()
            logits = _tile_logits(qtf, ktf, scale, qstart, kstart + j * blk_k, causal, window)
            p = torch.where(torch.isfinite(logits), torch.exp(logits - lse_safe), 0.0)
            dvs[j] = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
            dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vtf)
            ds = p * (dp - dsum) * scale
            dq = dq + torch.einsum("bkgqs,bksd->bkgqd", ds, ktf)
            dks[j] = torch.einsum("bkgqs,bkgqd->bksd", ds, qtf)
        return dq.to(qt.dtype), dks, dvs, None, None, None, None, None, None


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    blk_q: int = 512,
    blk_k: int = 512,
) -> torch.Tensor:
    """Flash attention with GQA at scale ``D ** -0.5`` over query tiles of
    ``blk_q``, causal and with an optional sliding window, differentiable
    through :class:`_FlashQTile`.  The reference's two paths:

    * global: KV tiles of ``blk_k`` (the window, if any, masked inside the
      tiles); each query tile reads the tiles up to its diagonal;
    * local, taken with a window when ``Sk > blk_q + window``: K and V are
      left-padded by ``window`` zero rows, and query tile ``i`` reads the
      one ``(blk_q + window)``-key span that starts at position
      ``i·blk_q - window`` as a single KV tile (the padding masked by
      ``kpos >= 0``), so a local layer costs O(S·window), not O(S²).

    Logits and the softmax statistics are float32; the unnormalised
    probabilities are cast to v's dtype for the value product, which
    accumulates in float32.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5
    blk_q = min(blk_q, sq)
    blk_k = min(blk_k, sk)
    if sq % blk_q or sk % blk_k:
        raise ValueError(f"tiles must divide the sequences: {sq} % {blk_q}, {sk} % {blk_k}")
    nq = sq // blk_q

    qg = q.reshape(b, nq, blk_q, kv, g, d).permute(1, 0, 3, 4, 2, 5)  # (nq, B, KV, G, bq, D)
    out = []
    if window is not None and sk > blk_q + window:
        span = blk_q + window
        pad = (0, 0, 0, 0, window, 0)
        kp = torch.nn.functional.pad(k, pad).permute(0, 2, 1, 3)  # (B, KV, window + Sk, D)
        vp = torch.nn.functional.pad(v, pad).permute(0, 2, 1, 3)
        for i in range(nq):
            qstart = i * blk_q
            kt = kp[:, :, qstart:qstart + span][None]  # (1, B, KV, span, D)
            vt = vp[:, :, qstart:qstart + span][None]
            out.append(_FlashQTile.apply(qg[i], kt, vt, qstart, qstart - window, 1, scale,
                                         causal, window))
    else:
        nk = sk // blk_k
        kts = k.reshape(b, nk, blk_k, kv, d).permute(1, 0, 3, 2, 4)  # (nk, B, KV, bk, D)
        vts = v.reshape(b, nk, blk_k, kv, d).permute(1, 0, 3, 2, 4)
        for i in range(nq):
            qstart = i * blk_q
            # KV tiles holding a key at or before the tile's last query (on
            # this path Sk <= blk_q + window, so every tile holds a key of
            # some query's window)
            seen = min(nk, (qstart + blk_q - 1) // blk_k + 1) if causal else nk
            out.append(_FlashQTile.apply(qg[i], kts, vts, qstart, 0, seen, scale, causal,
                                         window))
    o = torch.stack(out)  # (nq, B, KV, G, bq, D)
    return o.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, d).to(q.dtype)


def decode_gqa_attention(
    q: torch.Tensor,        # (B, H, D) single token
    k_cache: torch.Tensor,  # (B, C, KV, D) linear or ring cache
    v_cache: torch.Tensor,
    length: torch.Tensor,   # (B,) int32: one past the last valid slot
    *,
    start: Optional[torch.Tensor] = None,  # (B,) int32: the first valid slot
) -> torch.Tensor:
    """Single-token decode attention over the slots ``[start, length)`` of
    a KV cache.

    The reference masks each slot by its position, window and the current
    position (``transformer.DecodeSpan`` turns that into the slot range,
    for linear caches and the rings of sliding-window layers); the softmax
    does not depend on the order of the slots.  So this calls the
    ``decode_attention`` kernel's wrapper, which launches the CUDA kernel
    for CUDA tensors (its plain version on the CPU).
    """
    return decode_ops.gqa_decode_attention(q, k_cache, v_cache, length, start=start)


def mask_padded_logits(logits: torch.Tensor, valid_vocab: int) -> torch.Tensor:
    """-1e30 over embedding-padding rows (see ModelConfig.padded_vocab)."""
    v = logits.shape[-1]
    if v == valid_vocab:
        return logits
    mask = torch.arange(v, device=logits.device) < valid_vocab
    return torch.where(mask, logits, torch.full_like(logits, -1e30))


# ---------------------------------------------------------------------------
# Training: layer rematerialisation, loss
# ---------------------------------------------------------------------------


def _sqrt_factor(n: int) -> int:
    """Largest divisor of n that is <= sqrt(n)."""
    best = 1
    f = 1
    while f * f <= n:
        if n % f == 0:
            best = f
        f += 1
    return best


def remat_scan(body: Callable, x: torch.Tensor, xs: Sequence, *, train: bool) -> torch.Tensor:
    """``x = body(x, xs[i])`` for every ``i`` in order, with sqrt(N)
    two-level rematerialisation when training.

    Training a stack of N layers normally keeps every layer's activations;
    here each layer is checkpointed (only its input is kept) and the layers
    are split into ``outer × inner`` super-groups, each checkpointed too,
    which bounds the live checkpoints at outer + inner ≈ 2·sqrt(N).  This
    changes memory, not numbers.  Inference (``train=False``) runs plain.
    """
    if not train:
        for item in xs:
            x = body(x, item)
        return x
    n = len(xs)
    o = _sqrt_factor(n)
    i = n // o

    def inner(x, items):
        for item in items:
            x = checkpoint(body, x, item, use_reentrant=False)
        return x

    if o == 1:
        return inner(x, xs)
    for g in range(o):
        x = checkpoint(inner, x, xs[g * i:(g + 1) * i], use_reentrant=False)
    return x


def _ce_chunk(xt: torch.Tensor, embed: torch.Tensor, lt: torch.Tensor,
              valid_vocab: Optional[int]):
    """Summed cross-entropy and label count of one S-chunk (float32)."""
    logits = torch.einsum("bsd,vd->bsv", xt.float(), embed.float())
    if valid_vocab is not None:
        logits = mask_padded_logits(logits, valid_vocab)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(lt, min=0).long()[..., None])[..., 0]
    mask = (lt >= 0).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def chunked_ce_loss(
    x: torch.Tensor,       # (B, S, D) final hidden states
    embed: torch.Tensor,   # (Vp, D) tied softmax weights (padded vocab)
    labels: torch.Tensor,  # (B, S) int, -1 = ignore
    chunk: int = 512,
    valid_vocab: Optional[int] = None,
) -> torch.Tensor:
    """Mean cross-entropy over valid labels with S-chunked float32 logits.

    Each chunk is recomputed in the backward pass (a checkpoint), so
    (B, S, V) logits never exist; at most one chunk's (B, chunk, V) do.
    """
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        part, count = checkpoint(_ce_chunk, x[:, c:c + chunk], embed, labels[:, c:c + chunk],
                                 valid_vocab, use_reentrant=False)
        loss_sum = loss_sum + part
        n = n + count
    return loss_sum / torch.clamp(n, min=1.0)
