"""Decoder-only transformer for training, prefill and decode.

The port's counterpart of the JAX package's ``models/transformer.py`` for
the dense, vlm and moe families.  The reference stacks its layers into scan
groups (``n_local`` sliding-window + ``n_global`` full-attention layers,
leading ``(n_groups, n_layer)`` parameter axes) and runs ``lax.scan`` over
them; here the parameters are held by :class:`Transformer`, an
``nn.Module`` with one :class:`Params` module per layer in an
``nn.ModuleList`` in depth order (each group's local layers, then its
global ones), and the stack is a Python loop over it (rematerialised in
groups when training).  The parameter definitions (:func:`model_defs`)
keep the reference's stacked tree (``groups/local``, ``groups/global``,
``vision_proj``), so the same tree (drawn here, or carried over from the
reference) builds the module.

Ported layer options: RoPE, qk-norm, post-norms, swiglu/geglu/gelu MLPs,
sliding-window (local) layers, and the vision prefix (``frontend ==
"vision"``: projected patch embeddings in front of the tokens), and the
mixture-of-experts MLP (``family == "moe"``, :mod:`repro_torch.models.moe`).
The ssm/hybrid/encdec families and learned positions raise
``NotImplementedError`` (ROADMAP.md §1 item 6).

KV cache: ``{"local": {"k", "v"}, "global": {"k", "v"}}`` (``"local"``
only where the groups have local layers), each ``(layers of that kind, B,
C, KV, hd)`` with the element order of the reference's ``(n_groups,
n_local | n_global, B, C, KV, hd)`` leaves.  A global layer's cache is
linear (slot = position); a local layer's is a ring of
``C = min(window, seq_len)`` slots (slot = position % C), or a linear
cache grown past the window by ``model.pad_cache`` when the prompt was no
longer than the window.  :func:`decode` writes the new token's keys and
values into it in place (the reference returns an updated copy) and
returns it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.models import common, moe
from repro_torch.models.config import ModelConfig

ParamDef = common.ParamDef


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md §1 item 6)")
    if cfg.pos != "rope":
        raise NotImplementedError(
            f"positions {cfg.pos!r} are not ported yet; only RoPE (ROADMAP.md §1 item 6)")


# ---------------------------------------------------------------------------
# Param definitions
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * hd)),
        "wk": ParamDef((d, kv * hd)),
        "wv": ParamDef((d, kv * hd)),
        "wo": ParamDef((h * hd, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = common.rms_norm_def(hd)
        defs["k_norm"] = common.rms_norm_def(hd)
    return defs


def mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    defs = {"w_up": ParamDef((d, f)), "w_down": ParamDef((f, d))}
    if cfg.mlp in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d, f))
    return defs


def layer_defs(cfg: ModelConfig) -> Dict[str, object]:
    d = cfg.d_model
    defs = {"ln1": common.rms_norm_def(d), "attn": attn_defs(cfg),
            "ln2": common.rms_norm_def(d),
            "mlp": moe.moe_defs(cfg) if cfg.family == "moe" else mlp_defs(cfg)}
    if cfg.post_norm:
        defs["post_ln1"] = common.rms_norm_def(d)
        defs["post_ln2"] = common.rms_norm_def(d)
    return defs


def _stack(defs, n: int):
    if isinstance(defs, ParamDef):
        return ParamDef((n,) + defs.shape, defs.init, defs.scale, defs.dtype)
    return {k: _stack(v, n) for k, v in defs.items()}


def model_defs(cfg: ModelConfig) -> Dict[str, object]:
    """The reference's parameter tree: ``groups/local`` and
    ``groups/global`` leaves carry the leading ``(n_groups, n_local)`` and
    ``(n_groups, n_global)`` axes (so the fan-in of a stacked "normal" leaf
    is ``n_groups``, as in the reference's initialiser); ``vision_proj``
    (D, D) with the vision frontend."""
    _check_supported(cfg)
    n_local, n_global = cfg.group_pattern
    group = {"local": _stack(layer_defs(cfg), n_local)} if n_local else {}
    group["global"] = _stack(layer_defs(cfg), n_global)
    defs = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), scale=1.0),
        "groups": _stack(group, cfg.n_groups),
        "final_norm": common.rms_norm_def(cfg.d_model),
    }
    if cfg.frontend == "vision":
        defs["vision_proj"] = ParamDef((cfg.d_model, cfg.d_model))
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


class Transformer(nn.Module):
    """The model's parameters: ``embed``, ``layers`` (one :class:`Params`
    per layer, in depth order, :func:`layer_kinds`), ``final_norm`` and,
    with the vision frontend, ``vision_proj``.

    They are frozen (``requires_grad=False``), so serving records no
    autograd graph; training differentiates inside :meth:`trainable`.
    """

    def __init__(self, cfg: ModelConfig, tree: Dict[str, object]):
        super().__init__()
        _check_supported(cfg)
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.final_norm = nn.Parameter(tree["final_norm"], requires_grad=False)
        if cfg.frontend == "vision":
            self.vision_proj = nn.Parameter(tree["vision_proj"], requires_grad=False)
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

    @contextlib.contextmanager
    def trainable(self):
        """Parameters require gradients inside the block and are frozen
        again when it ends."""
        self.requires_grad_(True)
        try:
            yield self
        finally:
            self.requires_grad_(False)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _qkv(p: Params, h_in: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, s, _ = h_in.shape
    hn, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h_in @ p.wq).reshape(b, s, hn, hd)
    k = (h_in @ p.wk).reshape(b, s, kv, hd)
    v = (h_in @ p.wv).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, p.q_norm)
        k = common.rms_norm(k, p.k_norm)
    q = common.rope(q, positions, cfg.rope_theta)
    k = common.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    window: Optional[int], positions):
    """Causal attention sub-block for training and prefill, sliding-window
    when ``window`` is set. Returns (out, (k, v))."""
    q, k, v = _qkv(p, x, cfg, positions)
    o = common.blockwise_attention(q, k, v, causal=True, window=window,
                                   blk_q=cfg.attn_blk, blk_k=cfg.attn_blk)
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ p.wo, (k, v)


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
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, x[:, None, :], cfg, positions)
    k_cache[:, span.slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, span.slot] = v_new[:, 0].to(v_cache.dtype)
    o = common.decode_gqa_attention(q[:, 0], k_cache, v_cache, span.length, start=span.start)
    return o.reshape(b, -1) @ p.wo


def mlp_block(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = x @ p.w_up
    if cfg.mlp == "swiglu":
        h = common.silu(x @ p.w_gate) * up
    elif cfg.mlp == "geglu":
        h = common.gelu(x @ p.w_gate) * up
    else:
        h = common.gelu(up)
    return h @ p.w_down


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's MLP, or its experts with the moe family, on (B, S, D) or
    one decode token (B, D); the token is routed as a sequence of one
    (``moe.capacity``'s decode branch)."""
    if cfg.family != "moe":
        return mlp_block(p, h, cfg)
    if h.dim() == 2:
        return moe.moe_layer(p, h[:, None, :], cfg)[:, 0]
    return moe.moe_layer(p, h, cfg)


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


def layer_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  window: Optional[int], positions):
    """One layer, training or prefill. Returns (x, (k, v))."""
    attn_out, kv = attention_block(p.attn, common.rms_norm(x, p.ln1), cfg,
                                   window=window, positions=positions)
    return _residual(p, x, attn_out, cfg), kv


def layer_decode(p: Params, x: torch.Tensor, k_cache, v_cache, cfg: ModelConfig, *,
                 pos: int, span: DecodeSpan) -> torch.Tensor:
    """One layer, single-token decode. x: (B, D)."""
    attn_out = attention_decode(p.attn, common.rms_norm(x, p.ln1), k_cache, v_cache,
                                cfg, pos=pos, span=span)
    return _residual(p, x, attn_out, cfg)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: Optional[torch.device] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zeroed KV caches: ``global`` ``{"k", "v"}: (n_groups·n_global, B,
    seq_len, KV, hd)`` and, with local layers, ``local`` of
    ``min(window, seq_len)`` ring slots."""
    _check_supported(cfg)
    n_local, n_global = cfg.group_pattern
    kinds = {"global": (n_global, seq_len)}
    if n_local:
        kinds = {"local": (n_local, min(cfg.window, seq_len)), **kinds}
    return {kind: {name: torch.zeros((cfg.n_groups * n, batch, c, cfg.n_kv_heads, cfg.head_dim),
                                     dtype=cfg.torch_dtype, device=device)
                   for name in ("k", "v")}
            for kind, (n, c) in kinds.items()}


# ---------------------------------------------------------------------------
# Full model: embed -> layers -> norm
# ---------------------------------------------------------------------------


def embed_inputs(params: Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token embedding, behind the projected patch embeddings with the
    vision frontend. Returns (x, positions)."""
    tokens = batch["tokens"]
    x = params.embed[tokens.long()].to(cfg.torch_dtype) * (cfg.d_model ** 0.5)
    if cfg.frontend == "vision":
        px = batch["patches"].to(cfg.torch_dtype) @ params.vision_proj  # (B, P, D) stub embeds
        x = torch.cat([px, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return x, positions


def _ring(x: torch.Tensor, window: int) -> torch.Tensor:
    """A local layer's prefill keys or values (B, L, KV, hd) as its ring
    cache (the reference's ``_prefill_cache_from``): the last
    ``w = min(window, L)`` positions, position ``t`` at slot ``t % w``
    (the tail rolled by ``L % w``)."""
    length = x.shape[1]
    w = min(window, length)
    return torch.roll(x[:, length - w:], shifts=length % w, dims=1)


def forward(params: Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            train: bool = False, return_cache: bool = False):
    """Run the decoder stack. Returns (hidden (B,S,D), cache or None).

    ``train=True`` rematerialises the layer groups (:func:`common.remat_scan`)
    for the backward pass; it returns no cache.
    """
    if train and return_cache:
        raise ValueError("a training forward returns no cache")
    x, positions = embed_inputs(params, batch, cfg)
    kinds = layer_kinds(cfg)
    per_group = len(kinds) // cfg.n_groups
    layers = list(zip(params.layers, kinds))
    groups = [layers[g * per_group:(g + 1) * per_group] for g in range(cfg.n_groups)]
    caches: Dict[str, Dict[str, list]] = {}

    def group_body(x, group):
        for p, kind in group:
            window = cfg.window if kind == "local" else None
            x, (k, v) = layer_forward(p, x, cfg, window=window, positions=positions)
            if return_cache:
                if window is not None:
                    k, v = _ring(k, window), _ring(v, window)
                kv = caches.setdefault(kind, {"k": [], "v": []})
                kv["k"].append(k)
                kv["v"].append(v)
        return x

    x = common.remat_scan(group_body, x, groups, train=train)
    x = common.rms_norm(x, params.final_norm)
    if not return_cache:
        return x, None
    return x, {kind: {name: torch.stack(ts) for name, ts in kv.items()}
               for kind, kv in caches.items()}


def logits_of(params: Transformer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied-embedding logits in float32 (the reference's
    ``preferred_element_type=f32``), padding rows masked."""
    logits = x.float() @ params.embed.float().T
    return common.mask_padded_logits(logits, cfg.vocab)


def decode(params: Transformer, cache: Dict[str, Dict[str, torch.Tensor]], token: torch.Tensor,
           pos: int, cfg: ModelConfig):
    """One decode step. token: (B,) at position ``pos`` (a Python int, one
    for the whole batch; with the vision frontend positions count the patch
    prefix). Returns (logits (B, V), cache updated in place)."""
    x = params.embed[token.long()].to(cfg.torch_dtype) * (cfg.d_model ** 0.5)
    b = x.shape[0]
    spans = {kind: DecodeSpan(kv["k"].shape[2], pos, cfg.window if kind == "local" else None,
                              b, x.device)
             for kind, kv in cache.items()}
    index = dict.fromkeys(cache, 0)
    for p, kind in zip(params.layers, layer_kinds(cfg)):
        i = index[kind]
        index[kind] = i + 1
        x = layer_decode(p, x, cache[kind]["k"][i], cache[kind]["v"][i], cfg, pos=pos,
                         span=spans[kind])
    x = common.rms_norm(x, params.final_norm)
    return logits_of(params, x, cfg), cache
