"""Decoder-only transformer, dense family, for training, prefill and decode.

The port's counterpart of the JAX package's ``models/transformer.py``.
The reference stacks its layers into scan groups (``n_local``
sliding-window + ``n_global`` full-attention layers, leading
``(n_groups, n_layer)`` parameter axes) and runs ``lax.scan`` over them;
here the parameters are held by :class:`Transformer`, an ``nn.Module``
with one :class:`Params` module per layer in an ``nn.ModuleList``, and the
stack is a Python loop over it (rematerialised in groups when training).
The parameter definitions (:func:`model_defs`) keep the reference's
stacked tree, so the same tree (drawn here, or carried over from the
reference) builds the module.

Only the llama-style dense layer is ported: full attention over a linear
KV cache, RoPE, no qk-norm or post-norms, a swiglu/geglu/gelu MLP.  The
sliding-window layers' ring cache, the other layer options and the
moe/ssm/hybrid/encdec/vlm families raise ``NotImplementedError``
(ROADMAP.md §1).

KV cache: ``{"k": (L, B, C, KV, hd), "v": ...}`` — one tensor per
projection, layers stacked, the same element order as the reference's
``(n_groups, n_global, B, C, KV, hd)`` leaves.  :func:`decode` writes the
new token's keys and values into it in place (the reference returns an
updated copy) and returns it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

ParamDef = common.ParamDef


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md §1 item 6)")
    if cfg.group_pattern[0]:
        raise NotImplementedError(
            "sliding-window layers (ring KV cache) are not ported yet "
            "(ROADMAP.md §1 item 6)")
    if cfg.pos != "rope" or cfg.qk_norm or cfg.post_norm:
        raise NotImplementedError(
            "only RoPE layers without qk-norm or post-norms are ported (ROADMAP.md §1 item 6)")


# ---------------------------------------------------------------------------
# Param definitions
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((d, h * hd)),
        "wk": ParamDef((d, kv * hd)),
        "wv": ParamDef((d, kv * hd)),
        "wo": ParamDef((h * hd, d)),
    }


def mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    defs = {"w_up": ParamDef((d, f)), "w_down": ParamDef((f, d))}
    if cfg.mlp in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d, f))
    return defs


def layer_defs(cfg: ModelConfig) -> Dict[str, object]:
    d = cfg.d_model
    return {"ln1": common.rms_norm_def(d), "attn": attn_defs(cfg),
            "ln2": common.rms_norm_def(d), "mlp": mlp_defs(cfg)}


def _stack(defs, n: int):
    if isinstance(defs, ParamDef):
        return ParamDef((n,) + defs.shape, defs.init, defs.scale, defs.dtype)
    return {k: _stack(v, n) for k, v in defs.items()}


def model_defs(cfg: ModelConfig) -> Dict[str, object]:
    """The reference's parameter tree: ``groups/global`` leaves carry the
    leading ``(n_groups, n_global)`` axes (so the fan-in of a stacked
    "normal" leaf is ``n_groups``, as in the reference's initialiser)."""
    _check_supported(cfg)
    _, n_global = cfg.group_pattern
    return {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), scale=1.0),
        "groups": _stack({"global": _stack(layer_defs(cfg), n_global)}, cfg.n_groups),
        "final_norm": common.rms_norm_def(cfg.d_model),
    }


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
    per layer, in depth order) and ``final_norm``.

    They are frozen (``requires_grad=False``), so serving records no
    autograd graph; training differentiates inside :meth:`trainable`.
    """

    def __init__(self, cfg: ModelConfig, tree: Dict[str, object]):
        super().__init__()
        _check_supported(cfg)
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.final_norm = nn.Parameter(tree["final_norm"], requires_grad=False)
        stacked = tree["groups"]["global"]
        _, n_global = cfg.group_pattern

        def layer(g: int, j: int, t):
            if isinstance(t, dict):
                return {k: layer(g, j, v) for k, v in t.items()}
            return t[g, j]

        self.layers = nn.ModuleList(
            Params(layer(g, j, stacked))
            for g in range(cfg.n_groups) for j in range(n_global))

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
    q = common.rope((h_in @ p.wq).reshape(b, s, hn, hd), positions, cfg.rope_theta)
    k = common.rope((h_in @ p.wk).reshape(b, s, kv, hd), positions, cfg.rope_theta)
    v = (h_in @ p.wv).reshape(b, s, kv, hd)
    return q, k, v


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions):
    """Full causal attention sub-block for training and prefill. Returns
    (out, (k, v))."""
    q, k, v = _qkv(p, x, cfg, positions)
    o = common.blockwise_attention(q, k, v, causal=True, blk_q=cfg.attn_blk, blk_k=cfg.attn_blk)
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ p.wo, (k, v)


def attention_decode(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cfg: ModelConfig, *, pos: int,
                     length: torch.Tensor) -> torch.Tensor:
    """Single-token attention. x: (B, D); caches (B, C, KV, hd), written in
    place at slot ``pos``; ``length`` is ``pos + 1`` for every row."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, x[:, None, :], cfg, positions)
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    o = common.decode_gqa_attention(q[:, 0], k_cache, v_cache, length)
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


def _residual(p: Params, x: torch.Tensor, attn_out: torch.Tensor, cfg: ModelConfig):
    """Post-attention half of a layer: residual, norm, MLP, residual."""
    x = x + attn_out
    return x + mlp_block(p.mlp, common.rms_norm(x, p.ln2), cfg)


def layer_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions):
    """One layer, training or prefill. Returns (x, (k, v))."""
    attn_out, kv = attention_block(p.attn, common.rms_norm(x, p.ln1), cfg, positions=positions)
    return _residual(p, x, attn_out, cfg), kv


def layer_decode(p: Params, x: torch.Tensor, k_cache, v_cache, cfg: ModelConfig, *,
                 pos: int, length: torch.Tensor) -> torch.Tensor:
    """One layer, single-token decode. x: (B, D)."""
    attn_out = attention_decode(p.attn, common.rms_norm(x, p.ln1), k_cache, v_cache,
                                cfg, pos=pos, length=length)
    return _residual(p, x, attn_out, cfg)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Zeroed linear KV cache ``{"k", "v"}: (L, B, seq_len, KV, hd)``."""
    _check_supported(cfg)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
            for name in ("k", "v")}


# ---------------------------------------------------------------------------
# Full model: embed -> layers -> norm
# ---------------------------------------------------------------------------


def embed_inputs(params: Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token embedding. Returns (x, positions)."""
    tokens = batch["tokens"]
    x = params.embed[tokens.long()].to(cfg.torch_dtype) * (cfg.d_model ** 0.5)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return x, positions


def forward(params: Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            train: bool = False, return_cache: bool = False):
    """Run the decoder stack. Returns (hidden (B,S,D), cache or None).

    ``train=True`` rematerialises the layer groups (:func:`common.remat_scan`)
    for the backward pass; it returns no cache.
    """
    if train and return_cache:
        raise ValueError("a training forward returns no cache")
    x, positions = embed_inputs(params, batch, cfg)
    n_global = cfg.group_pattern[1]
    groups = [params.layers[g * n_global:(g + 1) * n_global] for g in range(cfg.n_groups)]
    ks, vs = [], []

    def group_body(x, layers):
        for p in layers:
            x, (k, v) = layer_forward(p, x, cfg, positions=positions)
            if return_cache:
                ks.append(k)
                vs.append(v)
        return x

    x = common.remat_scan(group_body, x, groups, train=train)
    x = common.rms_norm(x, params.final_norm)
    if not return_cache:
        return x, None
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def logits_of(params: Transformer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied-embedding logits in float32 (the reference's
    ``preferred_element_type=f32``), padding rows masked."""
    logits = x.float() @ params.embed.float().T
    return common.mask_padded_logits(logits, cfg.vocab)


def decode(params: Transformer, cache: Dict[str, torch.Tensor], token: torch.Tensor,
           pos: int, cfg: ModelConfig):
    """One decode step. token: (B,) at position ``pos`` (a Python int, one
    for the whole batch). Returns (logits (B, V), cache updated in place)."""
    x = params.embed[token.long()].to(cfg.torch_dtype) * (cfg.d_model ** 0.5)
    length = torch.full((x.shape[0],), pos + 1, dtype=torch.int32, device=x.device)
    for i, p in enumerate(params.layers):
        x = layer_decode(p, x, cache["k"][i], cache["v"][i], cfg, pos=pos, length=length)
    x = common.rms_norm(x, params.final_norm)
    return logits_of(params, x, cfg), cache
