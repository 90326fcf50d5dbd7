"""Model API of every family (dense, vlm, moe, ssm, hybrid and encdec).

  * ``param_defs(cfg)`` / ``abstract_params(cfg)`` /
    ``init_params(cfg, generator, device=None)`` / ``param_specs(cfg)``
  * ``params_from_numpy(tree, cfg, device=None)`` — the JAX package's
    parameter tree, as numpy arrays, carried over into the port's module;
    ``params_to_tree(params, cfg)`` the way back (checkpoints, tests);
    ``opt_state_from_numpy(state, cfg, device=None)`` the reference's
    AdamW state carried over
  * ``loss_fn(params, batch, cfg)``  — next-token cross-entropy (training)
  * ``prefill(params, batch, cfg)``  — returns (last-token logits, cache)
  * ``decode_step(params, cache, token, pos, cfg)``
  * ``init_cache(cfg, batch, seq_len, device=None)`` / ``pad_cache``

Entry points take ``device=None``, meaning the CUDA card; they raise when
there is none.  Pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch import sharding
from repro_torch.device import resolve_device
from repro_torch.models import common, encdec, transformer
from repro_torch.models.common import materialize
from repro_torch.models.config import ModelConfig

#: the module of a model: the decoder stack, or the encoder-decoder
Model = Union[transformer.Transformer, encdec.EncDec]


def param_defs(cfg: ModelConfig):
    if cfg.encdec:
        return encdec.model_defs(cfg)
    return transformer.model_defs(cfg)


def _module(cfg: ModelConfig, tree) -> Model:
    return (encdec.EncDec if cfg.encdec else transformer.Transformer)(cfg, tree)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator], device=None) -> Model:
    """Random parameters with the reference's initialiser scheme, drawn
    from ``generator`` (on the generator's own device) and placed on
    ``device``.  ``device="meta"`` gives shapes and dtypes only and needs
    no generator."""
    dev = resolve_device(device)
    tree = materialize(param_defs(cfg), cfg.torch_dtype, generator, dev)
    return _module(cfg, tree)


def abstract_params(cfg: ModelConfig) -> Model:
    """The parameters as meta tensors: shapes and dtypes, no memory."""
    return init_params(cfg, None, device="meta")


def param_specs(cfg: ModelConfig):
    """PartitionSpec tree (the reference's parameter tree) under the
    active sharding rules."""
    return common.param_partition_specs(param_defs(cfg))


def specs_by_name(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                  tree) -> Dict[str, sharding.PartitionSpec]:
    """A spec tree shaped as the reference's parameter tree
    (:func:`param_specs`) keyed as ``params.named_parameters()`` (or as a
    ``{name: tensor}`` mapping so keyed, an AdamW moment): a layer's
    leaf (``layers.i.…``, ``enc_layers.i.…``, ``dec_layers.i.…``) takes its
    stacked leaf's spec without the stacking axes, which the rules never
    split (a decoder's local and global layers share their definitions)."""
    named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    out = {}
    for name, p in named:
        parts = name.split(".")
        if parts[0] == "layers":
            node, parts = next(iter(tree["groups"].values())), parts[2:]
        elif parts[0] in ("enc_layers", "dec_layers"):
            node, parts = tree[parts[0]], parts[2:]
        else:
            node = tree
        for part in parts:
            node = node[part]
        out[name] = sharding.PartitionSpec(*tuple(node)[len(node) - p.dim():])
    return out


def _tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.require(a, requirements=["C", "W"])  # torch wants writable memory
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits over
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> Model:
    """The reference's ``init_params`` tree (leaves as numpy arrays, bf16
    leaves as ``ml_dtypes.bfloat16``, or as tensors) as the port's module;
    the stacked layer leaves (leading ``(n_groups, n_local | n_global)``
    axes, or the encdec family's one layer axis) become one module per
    layer."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _tensor(t, dev)

    return _module(cfg, walk(tree))


def _restack(named: Dict[str, torch.Tensor], prefixes: List[str], lead) -> Dict[str, object]:
    """The leaves under each of ``prefixes`` (one layer's names each),
    stacked in that order and reshaped to ``lead + shape``, as a tree."""
    stacked: Dict[str, object] = {}
    for path in (k[len(prefixes[0]):] for k in named if k.startswith(prefixes[0])):
        t = torch.stack([named[p + path].detach() for p in prefixes])
        node = stacked
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t.reshape(tuple(lead) + t.shape[1:])
    return stacked


def params_to_tree(params: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: ModelConfig):
    """The inverse of :func:`params_from_numpy`: the reference's tree of
    detached tensors (``embed``, ``final_norm``, ``groups/local/...`` and
    ``groups/global/...`` with leading ``(n_groups, n_local | n_global)``
    axes, ``pos_embed``, ``vision_proj``; the encdec family's
    ``enc_layers/...`` and ``dec_layers/...`` with one leading layer axis,
    ``enc_norm``).  ``params`` is the module or a ``{name: tensor}``
    mapping keyed as its ``named_parameters()`` (an AdamW moment)."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)
    if cfg.encdec:
        stacks = {"enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers}
        tree = {name: t.detach() for name, t in named.items()
                if name.split(".")[0] not in stacks}
        for stack, n in stacks.items():
            tree[stack] = _restack(named, [f"{stack}.{i}." for i in range(n)], (n,))
        return tree
    kinds = transformer.layer_kinds(cfg)
    groups = {}
    for kind in dict.fromkeys(kinds):
        index = [i for i, k in enumerate(kinds) if k == kind]
        groups[kind] = _restack(named, [f"layers.{i}." for i in index],
                                (cfg.n_groups, len(index) // cfg.n_groups))
    tree = {name: t.detach() for name, t in named.items() if not name.startswith("layers.")}
    return {**tree, "groups": groups}


def opt_state_from_numpy(state, cfg: ModelConfig, device=None) -> Dict[str, object]:
    """The reference's AdamW state (``m`` and ``v`` trees shaped as the
    parameters', ``step``; numpy leaves) as the port's: moments keyed as
    the module's ``named_parameters()``, ``step`` an int32 tensor."""
    dev = resolve_device(device)

    def named(tree):
        return {k: p.detach()
                for k, p in params_from_numpy(tree, cfg, dev).named_parameters()}

    return {"m": named(state["m"]), "v": named(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=dev)}


def loss_fn(params: Model, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy (float32): ``tokens`` (B, S) and
    ``labels`` (B, S), -1 = ignore; with the vision frontend also
    ``patches`` (B, P, D), whose positions the loss ignores (labels cover
    the text only); with the encdec family also ``frames`` (B, S_enc, D),
    which the encoder reads (labels cover the decoder's tokens).  Under
    the ``bf16_grad`` rule the final hidden states pass
    :func:`common.grad_dtype_barrier` before the loss."""
    if cfg.encdec:
        enc = encdec.encode(params, batch["frames"], cfg, train=True)
        x, _ = encdec.dec_forward(params, batch["tokens"], enc, cfg, train=True)
        if sharding.active_rule("bf16_grad"):
            x = common.grad_dtype_barrier(x)
        return common.chunked_ce_loss(x, params.embed, batch["labels"], valid_vocab=cfg.vocab)
    x, _ = transformer.forward(params, batch, cfg, train=True)
    if sharding.active_rule("bf16_grad"):
        x = common.grad_dtype_barrier(x)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        pad = torch.full((labels.shape[0], cfg.num_patches), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return common.chunked_ce_loss(x, params.embed, labels, valid_vocab=cfg.vocab)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed decode caches: the decoder stack's (``transformer.init_cache``),
    or the encdec family's ``self`` and ``cross`` caches of ``seq_len // 2``
    slots each (the reference's split of S into S_dec = S_enc = S // 2)."""
    dev = resolve_device(device)
    if cfg.encdec:
        half = seq_len // 2
        return encdec.init_cache(cfg, batch, dec_len=half, enc_len=half, device=dev)
    return transformer.init_cache(cfg, batch, seq_len, dev)


def pad_cache(cache, prefill_len: int, max_len: int):
    """Grow every cache leaf whose axis -3 has ``prefill_len`` entries to
    ``max_len`` (zeros after the prompt), the reference's rule on every
    leaf: the global layers' linear KV caches, and a local layer's ring
    when the prompt was no longer than its window (its ``min(window,
    prefill_len)`` slots are then the prompt's, in order).  Leaves of
    another length (rings of a longer prompt) pass through unchanged.

    The rule reaches the encdec family's cross cache too: when the frame
    count equals the prompt length it grows by zero keys and values, and
    the decode's cross-attention, which reads every slot of that cache as
    the reference's does, gives each zero key a logit of 0.

    The rule reaches the SSD leaves too: axis -3 of ``state`` (…, B, H, N,
    P) is the head count H and of ``conv`` (…, B, W - 1, C) the batch B, so
    a prompt of H or B tokens grows them, and the first decode step then
    raises (``transformer._check_ssd_cache``), where the reference's fails
    on the shapes."""
    if isinstance(cache, dict):
        return {name: pad_cache(x, prefill_len, max_len) for name, x in cache.items()}
    if cache.shape[-3] != prefill_len:
        return cache
    shape = cache.shape[:-3] + (max_len,) + cache.shape[-2:]
    y = torch.zeros(shape, dtype=cache.dtype, device=cache.device)
    y[..., :prefill_len, :, :] = cache
    return y


def prefill(params: Model, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Process the full prompt (``tokens``; ``patches`` with the vision
    frontend; ``frames`` with the encdec family, which the encoder reads
    first); returns (last-token logits (B, V) float32, cache)."""
    if cfg.encdec:
        enc = encdec.encode(params, batch["frames"], cfg)
        x, cache = encdec.dec_forward(params, batch["tokens"], enc, cfg, return_cache=True)
    else:
        x, cache = transformer.forward(params, batch, cfg, return_cache=True)
    logits = transformer.logits_of(params, x[:, -1], cfg)
    return sharding.constraint(logits, "batch", "vocab"), cache


def decode_step(params: Model, cache, token: torch.Tensor, pos: int, cfg: ModelConfig):
    """One new token (B,) at position ``pos`` -> (logits (B, V), cache);
    the cache is updated in place.  With the vision frontend, positions
    count the ``num_patches`` patch slots of the prefill; with the encdec
    family they count the decoder's tokens only."""
    if cfg.encdec:
        return encdec.decode(params, cache, token, pos, cfg)
    return transformer.decode(params, cache, token, pos, cfg)
