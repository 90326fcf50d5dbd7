"""Whisper-style encoder-decoder (the audio family).  [arXiv:2212.04356]

The port's counterpart of the JAX package's ``models/encdec.py``.  The
mel + conv frontend is a stub there and here: the model consumes
precomputed frame embeddings (B, S_enc, D).  The bidirectional encoder
(sinusoidal positions, non-causal attention), the causal decoder with
learned positions and the cross-attention onto the encoder's keys and
values are ported.

The reference stacks each layer stack's parameters on one leading layer
axis and scans it; here :class:`EncDec` holds one
:class:`~repro_torch.models.transformer.Params` module per layer in two
``nn.ModuleList``\\ s, and each stack is a Python loop (each layer
rematerialised when training).  The parameter definitions
(:func:`model_defs`) keep the reference's tree, so the same tree (drawn
here, or carried over from the reference) builds the module.

Cache: ``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each leaf (L, B, S,
KV, hd) as the reference's: the decoder's self-attention keys and values
(linear, slot = position) and the encoder states' cross-attention keys
and values.  :func:`decode` writes the self cache in place and never
writes the cross cache.  Decode attends over every slot of the cross
cache, as the reference does (``kv_pos = arange(S_enc)``, ``pos =
S_enc``): a cross cache that ``model.pad_cache`` grew (frames = prompt
length) adds its zero keys to the softmax there and here.

Shapes: the assigned sequence length S splits into S_enc = S_dec = S // 2
(``model.init_cache``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch import sharding
from repro_torch.models import common, transformer
from repro_torch.models.config import ModelConfig

ParamDef = common.ParamDef
Params = transformer.Params


# ---------------------------------------------------------------------------
# Param definitions
# ---------------------------------------------------------------------------


def enc_layer_defs(cfg: ModelConfig) -> Dict[str, object]:
    d = cfg.d_model
    return {"ln1": common.rms_norm_def(d), "attn": transformer.attn_defs(cfg),
            "ln2": common.rms_norm_def(d), "mlp": transformer.mlp_defs(cfg)}


def dec_layer_defs(cfg: ModelConfig) -> Dict[str, object]:
    d = cfg.d_model
    return {"ln1": common.rms_norm_def(d), "self_attn": transformer.attn_defs(cfg),
            "ln_x": common.rms_norm_def(d), "cross_attn": transformer.attn_defs(cfg),
            "ln2": common.rms_norm_def(d), "mlp": transformer.mlp_defs(cfg)}


def model_defs(cfg: ModelConfig) -> Dict[str, object]:
    """The reference's tree: ``enc_layers`` and ``dec_layers`` with one
    leading layer axis (so the fan-in of a stacked "normal" leaf is the
    layer count, as in the reference's initialiser), the two norms and the
    learned decoder positions ``pos_embed`` (32,768, D)."""
    return {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "dmodel"), scale=1.0),
        "enc_layers": transformer._stack(enc_layer_defs(cfg), cfg.n_enc_layers),
        "dec_layers": transformer._stack(dec_layer_defs(cfg), cfg.n_layers),
        "enc_norm": common.rms_norm_def(cfg.d_model),
        "final_norm": common.rms_norm_def(cfg.d_model),
        "pos_embed": ParamDef((32768, cfg.d_model), (None, "dmodel"), scale=1.0),
    }


class EncDec(transformer.FrozenModel):
    """The model's parameters: ``embed``, ``pos_embed``, ``enc_norm``,
    ``final_norm`` and one :class:`Params` per layer in ``enc_layers`` and
    ``dec_layers``; frozen (:class:`~repro_torch.models.transformer.FrozenModel`)."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, object]):
        super().__init__()
        for name in ("embed", "pos_embed", "enc_norm", "final_norm"):
            self.register_parameter(name, nn.Parameter(tree[name], requires_grad=False))

        def layer(i: int, t):
            if isinstance(t, dict):
                return {k: layer(i, v) for k, v in t.items()}
            return t[i]

        for stack, n in (("enc_layers", cfg.n_enc_layers), ("dec_layers", cfg.n_layers)):
            self.add_module(stack, nn.ModuleList(Params(layer(i, tree[stack])) for i in range(n)))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, w: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """``x @ w`` (B, S, n·hd) as (B, S, n, hd)."""
    b, s, _ = x.shape
    return (x @ w).reshape(b, s, n, hd)


def _attend(p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Non-causal attention of q onto (k, v), through the output
    projection."""
    b, s = q.shape[:2]
    o = common.blockwise_attention(q, k, v, causal=False, blk_q=cfg.attn_blk, blk_k=cfg.attn_blk)
    return o.reshape(b, s, -1) @ p.wo


def _enc_layer(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = common.rms_norm(x, p.ln1)
    hn, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a = p.attn
    x = x + _attend(a, _heads(h, a.wq, hn, hd), _heads(h, a.wk, kv, hd), _heads(h, a.wv, kv, hd),
                    cfg)
    return x + transformer.mlp_block(p.mlp, common.rms_norm(x, p.ln2), cfg)


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig, *,
           train: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> encoder states (B, S_enc, D):
    the frames and the sinusoidal table, each cast to the model dtype, then
    added; the layers (rematerialised when training); ``enc_norm``."""
    _, s, d = frames.shape
    table = torch.from_numpy(common.sincos_positions(s, d)).to(frames.device, cfg.torch_dtype)
    x = frames.to(cfg.torch_dtype) + sharding.replicated(table, like=frames)[None]
    x = sharding.constraint(x, "batch", None, "dmodel_act")
    x = common.remat_scan(lambda xc, p: _enc_layer(p, xc, cfg), x, list(params.enc_layers),
                          train=train)
    return common.rms_norm(x, params.enc_norm)


def _cross_kv(p: Params, enc_states: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross-attention keys and values of the encoder
    states: (B, S_enc, KV, hd) each."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return (_heads(enc_states, p.cross_attn.wk, kv, hd),
            _heads(enc_states, p.cross_attn.wv, kv, hd))


def _dec_layer(p: Params, x: torch.Tensor, enc_k: torch.Tensor, enc_v: torch.Tensor,
               cfg: ModelConfig, positions: torch.Tensor):
    """A decoder layer for training and prefill. Returns (x, (self_k, self_v))."""
    h = common.rms_norm(x, p.ln1)
    attn_out, (k, v) = transformer.attention_block(p.self_attn, h, cfg, window=None,
                                                   positions=positions)
    x = x + attn_out
    hq = common.rms_norm(x, p.ln_x)
    x = x + _attend(p.cross_attn, _heads(hq, p.cross_attn.wq, cfg.n_heads, cfg.head_dim),
                    enc_k, enc_v, cfg)
    x = x + transformer.mlp_block(p.mlp, common.rms_norm(x, p.ln2), cfg)
    return x, (k, v)


def dec_forward(params: EncDec, tokens: torch.Tensor, enc_states: torch.Tensor,
                cfg: ModelConfig, *, train: bool = False, return_cache: bool = False):
    """The decoder over the whole token sequence (B, S_dec). Returns (hidden
    (B, S_dec, D), cache or None); ``train=True`` rematerialises each layer
    and returns no cache.  Each layer computes its cross keys and values
    once, for its attention and the cache (the reference computes the
    cache's a second time, outside its scan)."""
    if train and return_cache:
        raise ValueError("a training forward returns no cache")
    b, s = tokens.shape
    x = transformer.embed_tokens(params.embed, tokens).to(cfg.torch_dtype) * (cfg.d_model ** 0.5)
    x = x + params.pos_embed[:s][None].to(x.dtype)
    positions = sharding.replicated(torch.arange(s, device=x.device)[None, :].expand(b, s),
                                    like=x)
    leaves: Dict[str, List[torch.Tensor]] = {"k": [], "v": [], "cross_k": [], "cross_v": []}

    def body(xc, p):
        ek, ev = _cross_kv(p, enc_states, cfg)
        xc, (k, v) = _dec_layer(p, xc, ek, ev, cfg, positions)
        if return_cache:
            for name, t in zip(leaves, (k, v, ek, ev)):
                leaves[name].append(t)
        return xc

    x = common.remat_scan(body, x, list(params.dec_layers), train=train)
    x = common.rms_norm(x, params.final_norm)
    if not return_cache:
        return x, None
    cache = {"self": {"k": torch.stack(leaves["k"]), "v": torch.stack(leaves["v"])},
             "cross": {"k": torch.stack(leaves["cross_k"]), "v": torch.stack(leaves["cross_v"])}}
    return x, cache


def init_cache(cfg: ModelConfig, batch: int, dec_len: int, enc_len: int,
               device: Optional[torch.device] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zeroed ``self`` (L, B, dec_len, KV, hd) and ``cross`` (L, B, enc_len,
    KV, hd) caches in the model dtype."""
    def z(s):
        return torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim),
                           dtype=cfg.torch_dtype, device=device)

    return {"self": {"k": z(dec_len), "v": z(dec_len)},
            "cross": {"k": z(enc_len), "v": z(enc_len)}}


def decode(params: EncDec, cache: Dict[str, Dict[str, torch.Tensor]], token: torch.Tensor,
           pos: int, cfg: ModelConfig):
    """One decoder token (B,) at position ``pos`` (a Python int). Returns
    (logits (B, V) float32, cache with its self cache updated in place).

    Both attentions go through ``decode_attention``: the self-attention
    over the slots ``[0, pos + 1)`` of its linear cache, the
    cross-attention over every slot of the cross cache."""
    x = transformer.embed_tokens(params.embed, token).to(cfg.torch_dtype) * (cfg.d_model ** 0.5)
    x = x + params.pos_embed[pos][None].to(x.dtype)
    b = x.shape[0]
    sk, sv = cache["self"]["k"], cache["self"]["v"]
    ck, cv = cache["cross"]["k"], cache["cross"]["v"]
    span = transformer.DecodeSpan(sk.shape[2], pos, None, b, x.device)
    cross_len = torch.full((b,), ck.shape[2], dtype=torch.int32, device=x.device)
    for i, p in enumerate(params.dec_layers):
        h = common.rms_norm(x, p.ln1)
        x = x + transformer.attention_decode(p.self_attn, h, sk[i], sv[i], cfg, pos=pos, span=span)
        hq = common.rms_norm(x, p.ln_x)
        q = (hq @ p.cross_attn.wq).reshape(b, cfg.n_heads, cfg.head_dim)
        o = common.decode_gqa_attention(q, ck[i], cv[i], cross_len)
        x = x + o.reshape(b, -1) @ p.cross_attn.wo
        x = x + transformer.mlp_block(p.mlp, common.rms_norm(x, p.ln2)[:, None, :], cfg)[:, 0]
    x = common.rms_norm(x, params.final_norm)
    return sharding.constraint(transformer.logits_of(params, x, cfg), "batch", "vocab"), cache
