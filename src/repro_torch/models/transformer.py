"""Decoder-only transformer for training, prefill and decode.

The port's counterpart of the JAX package's ``models/transformer.py`` for
the dense, vlm, moe, ssm and hybrid families (the encdec family,
:mod:`repro_torch.models.encdec`, reuses its attention and MLP blocks).
The reference stacks its layers into scan groups (``n_local``
sliding-window + ``n_global`` full-attention layers, leading ``(n_groups,
n_layer)`` parameter axes) and runs ``lax.scan`` over them; here the
parameters are held by :class:`Transformer`, an ``nn.Module`` with one
:class:`Params` module per layer in an ``nn.ModuleList`` in depth order
(each group's local layers, then its global ones), and the stack is a
Python loop over it (each layer rematerialised when training).  The
parameter definitions (:func:`model_defs`) keep the reference's stacked
tree (``groups/local``, ``groups/global``, ``pos_embed``,
``vision_proj``), so the same tree (drawn here, or carried over from the
reference) builds the module.

Layer options: RoPE, learned positions (``pos == "learned"``: a
``pos_embed`` (32,768, D) table added to the embeddings) or none, qk-norm,
post-norms, swiglu/geglu/gelu MLPs, sliding-window (local) layers, the
vision prefix (``frontend == "vision"``: projected patch embeddings in
front of the tokens), the mixture-of-experts MLP (``family == "moe"``,
:mod:`repro_torch.models.moe`), the Mamba-2 SSD layer (``family ==
"ssm"``: ``ln1`` and the SSD block, no attention and no MLP) and the
hybrid layer (``family == "hybrid"``: attention and SSD heads side by side
on the same ``ln1`` output, each normed and averaged, then the MLP;
:mod:`repro_torch.models.ssm`).

Cache: ``{"local": {...}, "global": {...}}`` (``"local"`` only where the
groups have local layers), each leaf ``(layers of that kind, B, ...)``
with the element order of the reference's ``(n_groups, n_local |
n_global, B, ...)`` leaves.  A kind with attention holds ``"k"`` and
``"v"`` ``(…, B, C, KV, hd)``; with the ssm and hybrid families it holds
the SSD state ``"state"`` ``(…, B, H, N, P)`` float32 and the conv
history ``"conv"`` ``(…, B, W - 1, C)`` in the model dtype.  A global
layer's KV cache is linear (slot = position); a local layer's is a ring
of ``C = min(window, seq_len)`` slots (slot = position % C), or a linear
cache grown past the window by ``model.pad_cache`` when the prompt was no
longer than the window.  :func:`decode` writes the new token's keys,
values, state and conv history into the cache in place (the reference
returns an updated copy) and returns it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch import sharding
from repro_torch.models import common, moe, ssm
from repro_torch.models.config import ModelConfig

ParamDef = common.ParamDef


# ---------------------------------------------------------------------------
# Param definitions
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * hd), ("dmodel", "attn_flat")),
        "wk": ParamDef((d, kv * hd), ("dmodel", "attn_flat")),
        "wv": ParamDef((d, kv * hd), ("dmodel", "attn_flat")),
        "wo": ParamDef((h * hd, d), ("attn_flat", "dmodel")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = common.rms_norm_def(hd)
        defs["k_norm"] = common.rms_norm_def(hd)
    return defs


def mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    defs = {"w_up": ParamDef((d, f), ("dmodel", "ff")),
            "w_down": ParamDef((f, d), ("ff", "dmodel"))}
    if cfg.mlp in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d, f), ("dmodel", "ff"))
    return defs


def layer_defs(cfg: ModelConfig) -> Dict[str, object]:
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": common.rms_norm_def(d), "ssm": ssm.ssm_defs(cfg)}
    defs = {"ln1": common.rms_norm_def(d), "attn": attn_defs(cfg),
            "ln2": common.rms_norm_def(d),
            "mlp": moe.moe_defs(cfg) if cfg.family == "moe" else mlp_defs(cfg)}
    if cfg.family == "hybrid":
        defs["ssm"] = ssm.ssm_defs(cfg)
        defs["attn_out_norm"] = common.rms_norm_def(d)
        defs["ssm_out_norm"] = common.rms_norm_def(d)
    if cfg.post_norm:
        defs["post_ln1"] = common.rms_norm_def(d)
        defs["post_ln2"] = common.rms_norm_def(d)
    return defs


def _stack(defs, n: int):
    if isinstance(defs, ParamDef):
        return ParamDef((n,) + defs.shape, (None,) + defs.axes, defs.init, defs.scale,
                        defs.dtype)
    return {k: _stack(v, n) for k, v in defs.items()}


def model_defs(cfg: ModelConfig) -> Dict[str, object]:
    """The reference's parameter tree: ``groups/local`` and
    ``groups/global`` leaves carry the leading ``(n_groups, n_local)`` and
    ``(n_groups, n_global)`` axes (so the fan-in of a stacked "normal" leaf
    is ``n_groups``, as in the reference's initialiser); ``pos_embed``
    (32,768, D) with learned positions; ``vision_proj`` (D, D) with the
    vision frontend."""
    n_local, n_global = cfg.group_pattern
    group = {"local": _stack(layer_defs(cfg), n_local)} if n_local else {}
    group["global"] = _stack(layer_defs(cfg), n_global)
    defs = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "dmodel"), scale=1.0),
        "groups": _stack(group, cfg.n_groups),
        "final_norm": common.rms_norm_def(cfg.d_model),
    }
    if cfg.pos == "learned":
        defs["pos_embed"] = ParamDef((32768, cfg.d_model), (None, "dmodel"), scale=1.0)
    if cfg.frontend == "vision":
        defs["vision_proj"] = ParamDef((cfg.d_model, cfg.d_model), ("dmodel", "dmodel_act"))
    return defs


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """``"local"`` or ``"global"`` for each layer in depth order: each
    group's ``n_local`` sliding-window layers, then its ``n_global`` ones."""
    n_local, n_global = cfg.group_pattern
    return (["local"] * n_local + ["global"] * n_global) * cfg.n_groups


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Params(nn.Module):
    """A dict of frozen tensors as a module: tensors become parameters,
    nested dicts sub-modules (``p.attn.wq``)."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))


class FrozenModel(nn.Module):
    """A model whose parameters are frozen (``requires_grad=False``), so
    serving records no autograd graph; training differentiates inside
    :meth:`trainable`."""

    @contextlib.contextmanager
    def trainable(self):
        """Parameters require gradients inside the block and are frozen
        again when it ends."""
        self.requires_grad_(True)
        try:
            yield self
        finally:
            self.requires_grad_(False)


class Transformer(FrozenModel):
    """The model's parameters: ``embed``, ``layers`` (one :class:`Params`
    per layer, in depth order, :func:`layer_kinds`), ``final_norm``, with
    learned positions ``pos_embed`` and with the vision frontend
    ``vision_proj``; frozen (:class:`FrozenModel`).
    """

    def __init__(self, cfg: ModelConfig, tree: Dict[str, object]):
        super().__init__()
        for name in ("embed", "final_norm", "pos_embed", "vision_proj"):
            if name in tree:
                self.register_parameter(name, nn.Parameter(tree[name], requires_grad=False))
        n_local, n_global = cfg.group_pattern

        def layer(g: int, j: int, t):
            if isinstance(t, dict):
                return {k: layer(g, j, v) for k, v in t.items()}
            return t[g, j]

        groups = tree["groups"]
        self.layers = nn.ModuleList(
            Params(layer(g, j, groups[kind]))
            for g in range(cfg.n_groups)
            for kind, n in (("local", n_local), ("global", n_global)) for j in range(n))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _gathered(w: torch.Tensor, *axes) -> torch.Tensor:
    """The FSDP weight gather: drop the ``dmodel`` shard at the use site, so
    that the (small) weights are all-gathered once a layer rather than the
    (large) partial sums of the contraction all-reduced (the reference's
    ``transformer._gathered``)."""
    return sharding.constraint(w, *axes)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n·hd) as (B, S, n, hd).  On a mesh whose dims split the flat
    axis into pieces that are not whole heads (``n`` not a multiple of the
    dim's size; GSPMD splits ``n`` and ``hd`` together there), that dim is
    gathered first: DTensor unflattens only whole shards."""
    b, s = x.shape[:2]
    if sharding.is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        mesh = x.device_mesh
        pl = [Replicate() if p == Shard(2) and n % mesh.size(m) else p
              for m, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(b, s, n, hd)


def _qkv(p: Params, h_in: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Projections, (qk-norm,) RoPE, for training and prefill (B, S, D) and
    for one decode token (B, 1, D): the reference's ``_qkv`` and the
    projections of its ``attention_decode``, which the port shares."""
    b, s, _ = h_in.shape
    hn, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    flat = ("batch", None, "attn_flat")
    q = sharding.constraint(h_in @ _gathered(p.wq, None, "attn_flat"), *flat)
    k = sharding.constraint(h_in @ _gathered(p.wk, None, "attn_flat"), *flat)
    v = sharding.constraint(h_in @ _gathered(p.wv, None, "attn_flat"), *flat)
    q, k, v = _split_heads(q, hn, hd), _split_heads(k, kv, hd), _split_heads(v, kv, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, p.q_norm)
        k = common.rms_norm(k, p.k_norm)
    if cfg.pos == "rope":
        q = common.rope(q, positions, cfg.rope_theta)
        k = common.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    window: Optional[int], positions):
    """Causal attention sub-block for training and prefill, sliding-window
    when ``window`` is set. Returns (out, (k, v)).

    Under the ``attn_tp`` rule the KV heads are repeated to the full
    query-head count before the flash tiles, as the reference's
    Megatron-style GQA tensor parallelism does; the cache keeps the KV
    heads."""
    q, k, v = _qkv(p, x, cfg, positions)
    cache_kv = (k, v)
    if sharding.active_rule("attn_tp"):
        g = cfg.n_heads // cfg.n_kv_heads
        if g > 1:
            k = _repeat_heads(k, g)
            v = _repeat_heads(v, g)
        heads = ("batch", None, "heads_tp", None)
        q, k, v = (sharding.constraint(t, *heads) for t in (q, k, v))
    o = common.blockwise_attention(q, k, v, causal=True, window=window,
                                   blk_q=cfg.attn_blk, blk_k=cfg.attn_blk)
    b, s = o.shape[:2]
    o = sharding.constraint(o, "batch", None, "heads_tp", None)
    out = o.reshape(b, s, -1) @ _gathered(p.wo, "attn_flat", None)
    return sharding.constraint(out, "batch", None, "dmodel_act"), cache_kv


def _repeat_heads(x: torch.Tensor, g: int) -> torch.Tensor:
    """Each KV head repeated ``g`` times along axis 2 (``jnp.repeat``); on
    a mesh on each rank's shard, with the head axis gathered first
    (``repeat_interleave`` has no DTensor sharding rule)."""
    if not sharding.is_dtensor(x):
        return torch.repeat_interleave(x, g, dim=2)
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(Replicate() if p == Shard(2) else p for p in x.placements)
    return sharding.local(lambda t: torch.repeat_interleave(t, g, dim=2), pl, (pl,), x)


class DecodeSpan:
    """Where one decode step writes its keys and values in a cache of
    ``C`` slots and which slots it reads: ``slot``, and the kernel's
    per-row ``length`` and ``start`` (``None`` for 0), built once a step
    and shared by the layers of one kind.

    The reference masks slot ``i`` valid when its position
    ``kv_pos = pos - ((pos - i) % C)`` (a ring; ``kv_pos = i`` for a linear
    cache) satisfies ``0 <= kv_pos <= pos`` and, in a local layer,
    ``kv_pos > pos - window`` (``common.py::decode_gqa_attention``).  As a
    range of slots that is:

    * a global layer (linear, ``slot = pos``): ``[0, pos + 1)``;
    * a local ring of ``C <= window`` slots (``slot = pos % C``): every
      slot written so far, ``[0, min(pos + 1, C))`` — the window is wider
      than the ring;
    * a local cache of ``C > window`` slots (a prompt no longer than the
      window, grown by ``pad_cache``; ``slot = pos`` while ``pos < C``):
      ``[max(0, pos - window + 1), pos + 1)``.  Past ``C`` such a ring's
      window would wrap into two ranges, so that raises; the serving
      engine stops at ``max_len - 1``.
    """

    def __init__(self, c: int, pos: int, window: Optional[int], batch: int,
                 device: torch.device):
        lo, hi = 0, pos + 1
        if window is not None:
            if c <= window:
                hi = min(hi, c)
            elif pos >= c:
                raise ValueError(f"decode position {pos} past a {c}-slot cache wider than "
                                 f"the window {window}")
            else:
                lo = max(0, pos - window + 1)
        elif pos >= c:
            raise ValueError(f"decode position {pos} past a {c}-slot cache")
        self.slot = pos % c
        self.length = torch.full((batch,), hi, dtype=torch.int32, device=device)
        self.start = (torch.full((batch,), lo, dtype=torch.int32, device=device)
                      if lo else None)


def attention_decode(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cfg: ModelConfig, *, pos: int,
                     span: DecodeSpan) -> torch.Tensor:
    """Single-token attention. x: (B, D); caches (B, C, KV, hd), written in
    place at ``span.slot``; the kernel reads slots ``[span.start,
    span.length)``."""
    b = x.shape[0]
    positions = sharding.replicated(
        torch.full((b, 1), pos, dtype=torch.int32, device=x.device), like=x)
    q, k_new, v_new = _qkv(p, x[:, None, :], cfg, positions)
    write_slot(k_cache, span.slot, k_new[:, 0])
    write_slot(v_cache, span.slot, v_new[:, 0])
    o = common.decode_gqa_attention(q[:, 0], k_cache, v_cache, span.length, start=span.start)
    return o.reshape(b, -1) @ p.wo


def write_slot(cache: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``cache[:, slot] = new`` in place: cache (B, C, KV, hd), new (B, KV,
    hd), cast to the cache's dtype.

    On a DTensor cache ``new`` is redistributed to the cache's split and
    written into each rank's own shard; a cache split along its slots
    (``kv_seq``) is written by the rank that holds ``slot`` alone, at its
    local index, so the cache is never replicated for the write."""
    if not sharding.is_dtensor(cache):
        cache[:, slot] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    # the cache's split, without the slot axis: its axis d > 1 is new's d - 1
    pl = [Replicate() if p == Shard(1) or not p.is_shard() else
          (Shard(p.dim - 1) if p.dim > 1 else p) for p in cache.placements]
    local_new = new.redistribute(cache.device_mesh, pl).to_local().to(cache.dtype)
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    i = slot - offset[1]
    if 0 <= i < shape[1]:
        cache.to_local()[:, i] = local_new


def mlp_block(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    ff = ("batch", None, "ff")
    up = sharding.constraint(x @ _gathered(p.w_up, None, "ff"), *ff)
    if cfg.mlp == "swiglu":
        h = common.silu(sharding.constraint(x @ _gathered(p.w_gate, None, "ff"), *ff)) * up
    elif cfg.mlp == "geglu":
        h = common.gelu(sharding.constraint(x @ _gathered(p.w_gate, None, "ff"), *ff)) * up
    else:
        h = common.gelu(up)
    return sharding.constraint(h @ _gathered(p.w_down, "ff", None), "batch", None, "dmodel_act")


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's MLP, or its experts with the moe family, on (B, S, D) or
    one decode token (B, D); the token goes through as a sequence of one,
    as in the reference (``moe.capacity``'s decode branch)."""
    block = moe.moe_layer if cfg.family == "moe" else mlp_block
    if h.dim() == 2:
        return block(p, h[:, None, :], cfg)[:, 0]
    return block(p, h, cfg)


def _residual(p: Params, x: torch.Tensor, attn_out: torch.Tensor, cfg: ModelConfig):
    """Post-attention half of a layer: (post-norm,) residual, norm, MLP or
    experts, (post-norm,) residual."""
    if cfg.post_norm:
        attn_out = common.rms_norm(attn_out, p.post_ln1)
    x = x + attn_out
    m = _ffn(p.mlp, common.rms_norm(x, p.ln2), cfg)
    if cfg.post_norm:
        m = common.rms_norm(m, p.post_ln2)
    return x + m


def _mix(p: Params, attn_out: torch.Tensor, ssm_out: torch.Tensor) -> torch.Tensor:
    """The hybrid layer's two heads, each normed, averaged."""
    return 0.5 * (common.rms_norm(attn_out, p.attn_out_norm)
                  + common.rms_norm(ssm_out, p.ssm_out_norm))


def layer_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  window: Optional[int], positions, want_cache: bool = False):
    """One layer, training or prefill. Returns (x, cache entry): with
    ``want_cache``, the layer's keys and values ``{"k", "v"}`` (B, S, KV,
    hd) where it has attention and its SSD cache ``{"state", "conv"}``
    where it has an SSD block; else None."""
    h_in = common.rms_norm(x, p.ln1)
    entry: Dict[str, torch.Tensor] = {}

    def ssd(p_ssm):
        if not want_cache:
            return ssm.ssm_forward(p_ssm, h_in, cfg)
        y, cache = ssm.ssm_forward(p_ssm, h_in, cfg, return_cache=True)
        entry.update(cache)
        return y

    if cfg.family == "ssm":
        x = x + ssd(p.ssm)
    else:
        attn_out, (entry["k"], entry["v"]) = attention_block(
            p.attn, h_in, cfg, window=window, positions=positions)
        if cfg.family == "hybrid":
            attn_out = _mix(p, attn_out, ssd(p.ssm))
        x = _residual(p, x, attn_out, cfg)
    return x, entry if want_cache else None


def _ssd_decode(p: Params, h_in: torch.Tensor, cache: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> torch.Tensor:
    """The SSD block's decode step; the new state and conv history are
    written into the layer's cache in place."""
    y, new = ssm.ssm_decode_step(p, h_in, cache, cfg)
    cache["state"].copy_(new["state"])
    cache["conv"].copy_(new["conv"])
    return y


def layer_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, pos: int, span: Optional[DecodeSpan]) -> torch.Tensor:
    """One layer, single-token decode. x: (B, D); ``cache`` holds this
    layer's leaves (``k``/``v`` (B, C, KV, hd), ``state``/``conv``), which
    are written in place."""
    h_in = common.rms_norm(x, p.ln1)
    if cfg.family == "ssm":
        return x + _ssd_decode(p.ssm, h_in, cache, cfg)
    attn_out = attention_decode(p.attn, h_in, cache["k"], cache["v"], cfg, pos=pos, span=span)
    if cfg.family == "hybrid":
        attn_out = _mix(p, attn_out, _ssd_decode(p.ssm, h_in, cache, cfg))
    return _residual(p, x, attn_out, cfg)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: Optional[torch.device] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zeroed caches: ``global`` of ``n_groups·n_global`` layers and, with
    local layers, ``local``; where the layers have attention, ``{"k",
    "v"}: (layers, B, C, KV, hd)`` with ``C = seq_len`` (global) or
    ``min(window, seq_len)`` ring slots (local); where they have an SSD
    block, ``state`` (layers, B, H, N, P) float32 and ``conv`` (layers,
    B, W - 1, C) in the model dtype."""
    n_local, n_global = cfg.group_pattern
    kinds = {"global": (n_global, seq_len)}
    if n_local:
        kinds = {"local": (n_local, min(cfg.window, seq_len)), **kinds}
    out = {}
    for kind, (n, c) in kinds.items():
        layers = cfg.n_groups * n
        leaves = {}
        if cfg.family != "ssm":
            for name in ("k", "v"):
                leaves[name] = torch.zeros((layers, batch, c, cfg.n_kv_heads, cfg.head_dim),
                                           dtype=cfg.torch_dtype, device=device)
        if cfg.family in ("ssm", "hybrid"):
            for name, t in ssm.ssm_init_cache(cfg, batch, cfg.torch_dtype, device).items():
                leaves[name] = t.expand((layers,) + t.shape).contiguous()
        out[kind] = leaves
    return out


# ---------------------------------------------------------------------------
# Full model: embed -> layers -> norm
# ---------------------------------------------------------------------------


def embed_inputs(params: Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token embedding, behind the projected patch embeddings with the
    vision frontend, plus ``pos_embed[:s]`` with learned positions.
    Returns (x, positions)."""
    tokens = batch["tokens"]
    x = embed_tokens(params.embed, tokens).to(cfg.torch_dtype) * (cfg.d_model ** 0.5)
    if cfg.frontend == "vision":
        px = batch["patches"].to(cfg.torch_dtype) @ params.vision_proj  # (B, P, D) stub embeds
        x = torch.cat([px, x], dim=1)
    b, s, _ = x.shape
    positions = sharding.replicated(torch.arange(s, device=x.device)[None, :].expand(b, s),
                                    like=x)
    if cfg.pos == "learned":
        x = x + params.pos_embed[:s][None].to(x.dtype)
    return sharding.constraint(x, "batch", None, "dmodel_act"), positions


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table (a gather, ``embed[tokens]``).

    On a mesh the table's FSDP (``dmodel``) shard is gathered first, as at
    every other weight's use site, and each rank looks its tokens up in
    its own slice of the vocabulary (``local_map``): rows of other slices
    are zero, and the slices' rows are summed (an all-reduce of the rows,
    exact: one row and zeros).  DTensor's own embedding rule leaves a
    masked partial sum that its redistributions and backward cannot take
    on this torch."""
    if not sharding.is_dtensor(embed):
        return torch.nn.functional.embedding(tokens.long(), embed)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    table = _gathered(embed, "vocab", None)
    tokens = sharding.replicated(tokens, like=table)
    mesh = table.device_mesh
    vocab = [p == Shard(0) for p in table.placements]
    tp = [Shard(0) if v else Replicate() for v in vocab]
    kp = [Shard(0) if p == Shard(0) and not v else Replicate()
          for p, v in zip(tokens.placements, vocab)]
    op = [Partial() if v else k for v, k in zip(vocab, kp)]
    (n, _), (lo, _) = compute_local_shape_and_global_offset(table.shape, mesh, tp)

    def lookup(t, tok):
        idx = tok.long() - lo
        inside = (idx >= 0) & (idx < n)
        rows = torch.nn.functional.embedding(torch.where(inside, idx, 0), t)
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype))

    rows = sharding.local(lookup, op, (tp, kp), table, tokens)
    return rows.redistribute(mesh, [Replicate() if p.is_partial() else p for p in op])


def _ring(x: torch.Tensor, window: int) -> torch.Tensor:
    """A local layer's prefill keys or values (B, L, KV, hd) as its ring
    cache (the reference's ``_prefill_cache_from``): the last
    ``w = min(window, L)`` positions, position ``t`` at slot ``t % w``
    (the tail rolled by ``L % w``).  On a mesh on each rank's shard, the
    sequence gathered first (``roll`` has no DTensor sharding rule)."""
    length = x.shape[1]
    w = min(window, length)

    def ring(t):
        return torch.roll(t[:, length - w:], shifts=length % w, dims=1)

    if not sharding.is_dtensor(x):
        return ring(x)
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(Replicate() if p == Shard(1) else p for p in x.placements)
    return sharding.local(ring, pl, (pl,), x)


def forward(params: Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            train: bool = False, return_cache: bool = False):
    """Run the decoder stack. Returns (hidden (B,S,D), cache or None).

    ``train=True`` rematerialises the layers (:func:`common.remat_scan`) for
    the backward pass, one checkpoint a layer (the reference's are its scan
    groups: a group of hymba-1.5b's sixteen layers would keep all sixteen
    layers' SSD tensors at once; the numbers are the same); it returns no
    cache.
    """
    if train and return_cache:
        raise ValueError("a training forward returns no cache")
    x, positions = embed_inputs(params, batch, cfg)
    layers = list(zip(params.layers, layer_kinds(cfg)))
    caches: Dict[str, Dict[str, List[torch.Tensor]]] = {}

    def body(x, layer):
        p, kind = layer
        window = cfg.window if kind == "local" else None
        x, entry = layer_forward(p, x, cfg, window=window, positions=positions,
                                 want_cache=return_cache)
        if return_cache:
            if window is not None and "k" in entry:
                entry["k"], entry["v"] = _ring(entry["k"], window), _ring(entry["v"], window)
            leaves = caches.setdefault(kind, {})
            for name, t in entry.items():
                leaves.setdefault(name, []).append(t)
        return x

    x = common.remat_scan(body, x, layers, train=train)
    x = common.rms_norm(x, params.final_norm)
    if not return_cache:
        return x, None
    return x, {kind: {name: torch.stack(ts) for name, ts in leaves.items()}
               for kind, leaves in caches.items()}


def logits_of(params: Transformer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied-embedding logits in float32 (the reference's
    ``preferred_element_type=f32``), padding rows masked."""
    logits = x.float() @ params.embed.float().T
    return common.mask_padded_logits(logits, cfg.vocab)


def _check_ssd_cache(cache: Dict[str, Dict[str, torch.Tensor]], cfg: ModelConfig,
                     batch: int) -> None:
    """Refuse SSD leaves that ``model.pad_cache`` grew.

    ``pad_cache`` keeps the reference's rule: it grows every cache leaf
    whose axis -3 equals the prompt length.  That axis of ``state``
    (…, B, H, N, P) is the head count H, and of ``conv`` (…, B, W - 1, C)
    the batch B, so a prompt of H or B tokens pads them, and the
    reference's first decode step then fails on the shapes.  Decoding such
    a state here would be wrong, so it raises too.
    """
    want = {"state": (batch, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim),
            "conv": (batch, cfg.conv_width - 1, cfg.ssm_dinner + 2 * cfg.ssm_state)}
    for kind, leaves in cache.items():
        for name, shape in want.items():
            if name in leaves and tuple(leaves[name].shape[1:]) != shape:
                raise ValueError(
                    f"the {kind} layers' SSD {name!r} cache is {tuple(leaves[name].shape[1:])}, "
                    f"not {shape}: model.pad_cache grew its axis -3 because it equals the "
                    f"prompt length (the reference's rule, under which the reference's decode "
                    f"fails here too); a prompt of {cfg.ssm_nheads} (H) or {batch} (B) tokens "
                    f"cannot be decoded")


def decode(params: Transformer, cache: Dict[str, Dict[str, torch.Tensor]], token: torch.Tensor,
           pos: int, cfg: ModelConfig):
    """One decode step. token: (B,) at position ``pos`` (a Python int, one
    for the whole batch; with the vision frontend positions count the patch
    prefix). Returns (logits (B, V), cache updated in place)."""
    x = embed_tokens(params.embed, token).to(cfg.torch_dtype) * (cfg.d_model ** 0.5)
    if cfg.pos == "learned":
        x = x + params.pos_embed[pos][None].to(x.dtype)
    b = x.shape[0]
    _check_ssd_cache(cache, cfg, b)
    spans = {kind: DecodeSpan(leaves["k"].shape[2], pos,
                              cfg.window if kind == "local" else None, b, x.device)
             for kind, leaves in cache.items() if "k" in leaves}
    index = dict.fromkeys(cache, 0)
    for p, kind in zip(params.layers, layer_kinds(cfg)):
        i = index[kind]
        index[kind] = i + 1
        x = layer_decode(p, x, {name: t[i] for name, t in cache[kind].items()}, cfg, pos=pos,
                         span=spans.get(kind))
    x = common.rms_norm(x, params.final_norm)
    return sharding.constraint(logits_of(params, x, cfg), "batch", "vocab"), cache
