"""Mixture-of-Experts layer: float32 top-k router + per-row capacity dispatch.

The port's counterpart of the JAX package's ``models/moe.py``.  Dispatch
keeps the reference's sort/gather design (static shapes, no one-hot
dispatch products, no host sync): the ``(token, choice)`` entries of each
batch row are sorted by expert with a stable sort, each expert keeps its
first ``cap`` entries (GShard drops, per row), and every data movement is a
batched gather.  The expert products are plain batched torch products, as
the reference's are plain einsums outside any Pallas kernel.

Two details decide which entries survive, and both follow the reference
exactly rather than the torch idiom:

* **top-k ties.** ``jax.lax.top_k`` puts the lower expert index first among
  equal probabilities; ``torch.topk`` does not promise an order.
  :func:`top_k` is a stable descending sort, sliced.
* **the slot search.** The reference inverts ``slot`` (kept entries'
  ``expert·cap + position``, dropped ones ``E·cap``) with
  ``jnp.searchsorted``, whose default is a fixed-depth bisection.  Dropped
  entries sit between the experts' kept runs, so ``slot`` is not sorted
  and the bisection can miss a kept slot; that entry's expert output is
  then zeroed (``slot_hit`` false) while its routing weight still counts.
  ``torch.searchsorted`` misses other slots, so :func:`scan_searchsorted`
  replays jnp's bisection step for step.

The reference's ``grad_dtype_barrier`` on the router input applies only
under its ``bf16_grad`` sharding rule, which the port does not have
(ROADMAP.md §1 item 13); its ``sharding.constraint`` calls have no
counterpart on one device.
"""

from __future__ import annotations

import math
import types
from typing import Dict, NamedTuple

import torch

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

ParamDef = common.ParamDef


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The router ``(d, E)`` in float32; experts ``w_up``/``w_gate`` ``(E,
    d, f)`` (the gate only for swiglu/geglu) and ``w_down`` ``(E, f, d)``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = {
        "router": ParamDef((d, e), dtype="float32"),
        "w_up": ParamDef((e, d, f)),
        "w_down": ParamDef((e, f, d)),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((e, d, f))
    return defs


def _expert_ffn_batched(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Batched expert MLP. x: (B, E, C, D) -> (B, E, C, D)."""
    up = torch.einsum("becd,edf->becf", x, p.w_up)
    if cfg.mlp == "swiglu":
        h = common.silu(torch.einsum("becd,edf->becf", x, p.w_gate)) * up
    elif cfg.mlp == "geglu":
        h = common.gelu(torch.einsum("becd,edf->becf", x, p.w_gate)) * up
    else:
        h = common.gelu(up)
    return torch.einsum("becf,efd->becd", h, p.w_down)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, the lower index first among equal values."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def scan_searchsorted(a: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(a, query)`` (side ``"left"``, its default
    ``method="scan"``) for each row of ``a`` (B, n) and ``query`` (B, Q):
    ``ceil(log2(n + 1))`` bisection levels from ``low = 0, high = n``,
    ``mid = (low + high) // 2``, ``high = mid`` where ``query <= a[mid]``
    and ``low = mid`` elsewhere; returns ``high``.  On a sorted row this is
    the left insertion point; on an unsorted one it is where this
    bisection ends, which is what the reference computes."""
    n = a.shape[-1]
    low = torch.zeros(query.shape, dtype=torch.int64, device=a.device)
    high = torch.full(query.shape, n, dtype=torch.int64, device=a.device)
    for _ in range(math.ceil(math.log2(n + 1))):
        mid = (low + high) // 2
        left = query <= torch.gather(a, -1, mid)
        low = torch.where(left, low, mid)
        high = torch.where(left, mid, high)
    return high


def capacity(cfg: ModelConfig, s: int) -> int:
    """Per-row slots of each expert: ``int(s·k/E·capacity_factor)`` rounded
    up to a multiple of 4 and at least ``k`` for a sequence, and
    ``max(1, k // E + 1)`` for one token (decode)."""
    e, k = cfg.n_experts, cfg.topk
    cap = int(s * k / e * cfg.capacity_factor)
    return max(k, -(-cap // 4) * 4) if s > 1 else max(1, k // e + 1)


class Dispatch(NamedTuple):
    """One batch row's routing, the reference's intermediate arrays (B
    rows each; ``n = s·k`` entries, ``E·cap`` slots)."""

    idx: torch.Tensor            # (B, s, k) chosen experts, lax's order
    w_s: torch.Tensor            # (B, n) float32 weights, sorted by expert
    keep: torch.Tensor           # (B, n) sorted entry within its expert's capacity
    slot: torch.Tensor           # (B, n) its slot, E·cap where dropped
    entry_of_slot: torch.Tensor  # (B, E·cap) the bisection's entry, clamped to n - 1
    slot_hit: torch.Tensor       # (B, E·cap) that entry holds the slot
    tok_of_slot: torch.Tensor    # (B, E·cap) the token that fills the slot
    inv_order: torch.Tensor      # (B, n) sorted position of entry t·k + j
    cap: int


def dispatch(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> Dispatch:
    """The router in float32, softmax, top-k, renormalised weights, then
    the stable sort by expert, each entry's position within its expert,
    the capacity drops and the slot search (``src/repro/models/moe.py``
    ``moe_layer``, up to its token gather)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.topk
    n = s * k
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, k)  # (B, S, k)
    w = w / torch.sum(w, dim=-1, keepdim=True)

    # (token-in-row, slot) pairs sorted by expert, per row
    eid = idx.reshape(b, n)
    order = torch.sort(eid, dim=-1, stable=True).indices
    eid_s = torch.gather(eid, -1, order)
    tid_s = torch.div(order, k, rounding_mode="floor")  # entry t·k + j belongs to token t
    w_s = torch.gather(w.reshape(b, n), -1, order)

    # position of each entry within its expert (per row)
    counts = torch.zeros((b, e), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, eid, torch.ones_like(eid))
    start = torch.cumsum(counts, dim=-1) - counts  # exclusive prefix (B, E)
    pos = torch.arange(n, device=x.device)[None, :] - torch.gather(start, -1, eid_s)

    cap = capacity(cfg, s)
    keep = pos < cap
    slot = torch.where(keep, eid_s * cap + pos, torch.full_like(pos, e * cap))

    # invert: which sorted entry fills each slot (exact-match gather)
    slot_ids = torch.arange(e * cap, device=x.device).expand(b, e * cap)
    entry_of_slot = torch.clamp(scan_searchsorted(slot, slot_ids), max=n - 1)
    slot_hit = torch.gather(slot, -1, entry_of_slot) == slot_ids
    tok_of_slot = torch.gather(tid_s, -1, entry_of_slot)

    # the inverse permutation of ``order`` (the reference's argsort of it)
    inv_order = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=x.device).expand(b, n))
    return Dispatch(idx, w_s, keep, slot, entry_of_slot, slot_hit, tok_of_slot, inv_order, cap)


def moe_layer(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), dispatched per batch row with capacity
    ``capacity(cfg, S)`` per expert; overflow entries drop."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.topk
    r = dispatch(p.router, x, cfg)
    cap = r.cap

    expert_in = torch.gather(x, 1, r.tok_of_slot[..., None].expand(b, e * cap, d))
    expert_in = torch.where(r.slot_hit[..., None], expert_in, torch.zeros((), dtype=x.dtype,
                                                                           device=x.device))
    expert_out = _expert_ffn_batched(p, expert_in.reshape(b, e, cap, d), cfg).reshape(b, e * cap, d)

    # route outputs back: sorted entry -> its slot -> original (token, k) lane
    back = torch.clamp(r.slot, max=e * cap - 1)
    out_sorted = torch.gather(expert_out, 1, back[..., None].expand(b, s * k, d))
    out_sorted = out_sorted * (r.w_s * r.keep).to(x.dtype)[..., None]
    contrib = torch.gather(out_sorted, 1, r.inv_order[..., None].expand(b, s * k, d))
    return torch.sum(contrib.reshape(b, s, k, d), dim=2)


def moe_layer_ref(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense-dispatch oracle (no capacity drops): every expert on every
    token, weighted by its routing weight (0 where not chosen)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf.float() @ p.router.float(), dim=-1)
    w, idx = top_k(probs, cfg.topk)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    y = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        pe = types.SimpleNamespace(**{name: getattr(p, name)[e][None]
                                      for name in ("w_up", "w_gate", "w_down") if hasattr(p, name)})
        he = _expert_ffn_batched(pe, xf[None, None], cfg)[0, 0]
        weight = torch.sum(torch.where(idx == e, w, 0.0), dim=-1)  # (T,)
        y = y + he * weight.to(xf.dtype)[:, None]
    return y.reshape(b, s, d)
