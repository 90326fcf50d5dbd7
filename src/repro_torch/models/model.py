"""Model API of the dense, vlm and moe families: training loss and serving.

  * ``param_defs(cfg)`` / ``init_params(cfg, generator, device=None)``
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

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.models.common import materialize
from repro_torch.models.config import ModelConfig


def param_defs(cfg: ModelConfig):
    return transformer.model_defs(cfg)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator], device=None
                ) -> transformer.Transformer:
    """Random parameters with the reference's initialiser scheme, drawn
    from ``generator`` (on the generator's own device) and placed on
    ``device``.  ``device="meta"`` gives shapes and dtypes only and needs
    no generator."""
    dev = resolve_device(device)
    tree = materialize(param_defs(cfg), cfg.torch_dtype, generator, dev)
    return transformer.Transformer(cfg, tree)


def _tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.require(a, requirements=["C", "W"])  # torch wants writable memory
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits over
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> transformer.Transformer:
    """The reference's ``init_params`` tree (leaves as numpy arrays, bf16
    leaves as ``ml_dtypes.bfloat16``, or as tensors) as the port's module;
    the stacked ``(n_groups, n_local | n_global, …)`` layer leaves become
    one module per layer."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _tensor(t, dev)

    return transformer.Transformer(cfg, walk(tree))


def params_to_tree(params: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: ModelConfig):
    """The inverse of :func:`params_from_numpy`: the reference's tree
    (``embed``, ``final_norm``, ``groups/local/...`` and
    ``groups/global/...`` with leading ``(n_groups, n_local | n_global)``
    axes, ``vision_proj``) of detached tensors.  ``params`` is the module
    or a ``{name: tensor}`` mapping keyed as its ``named_parameters()`` (an
    AdamW moment)."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)
    kinds = transformer.layer_kinds(cfg)
    groups: Dict[str, Dict[str, object]] = {}
    for kind in dict.fromkeys(kinds):
        index = [i for i, k in enumerate(kinds) if k == kind]
        lead = (cfg.n_groups, len(index) // cfg.n_groups)
        prefix = f"layers.{index[0]}."
        stacked = groups[kind] = {}
        for path in (k[len(prefix):] for k in named if k.startswith(prefix)):
            t = torch.stack([named[f"layers.{i}.{path}"].detach() for i in index])
            node = stacked
            *parents, leaf = path.split(".")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = t.reshape(lead + t.shape[1:])
    tree = {name: named[name].detach() for name in named if not name.startswith("layers.")}
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


def loss_fn(params: transformer.Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy (float32): ``tokens`` (B, S) and
    ``labels`` (B, S), -1 = ignore; with the vision frontend also
    ``patches`` (B, P, D), whose positions the loss ignores (labels cover
    the text only)."""
    if cfg.encdec:
        raise NotImplementedError(
            "the encdec loss is not ported yet (ROADMAP.md §1 item 6 (b))")
    x, _ = transformer.forward(params, batch, cfg, train=True)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        pad = torch.full((labels.shape[0], cfg.num_patches), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return common.chunked_ce_loss(x, params.embed, labels, valid_vocab=cfg.vocab)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    return transformer.init_cache(cfg, batch, seq_len, resolve_device(device))


def pad_cache(cache, prefill_len: int, max_len: int):
    """Grow every KV cache of ``prefill_len`` slots to ``max_len`` (zeros
    after the prompt), as the reference does: the global layers' linear
    caches, and a local layer's ring when the prompt was no longer than its
    window (its ``min(window, prefill_len)`` slots are then the prompt's,
    in order).  Caches of another length (rings of a longer prompt) pass
    through unchanged."""
    if isinstance(cache, dict):
        return {name: pad_cache(x, prefill_len, max_len) for name, x in cache.items()}
    if cache.shape[-3] != prefill_len:
        return cache
    shape = cache.shape[:-3] + (max_len,) + cache.shape[-2:]
    y = torch.zeros(shape, dtype=cache.dtype, device=cache.device)
    y[..., :prefill_len, :, :] = cache
    return y


def prefill(params: transformer.Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Process the full prompt (``tokens``, and ``patches`` with the vision
    frontend); returns (last-token logits (B, V) float32, cache)."""
    x, cache = transformer.forward(params, batch, cfg, return_cache=True)
    return transformer.logits_of(params, x[:, -1], cfg), cache


def decode_step(params: transformer.Transformer, cache, token: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """One new token (B,) at position ``pos`` -> (logits (B, V), cache);
    the cache is updated in place.  With the vision frontend, positions
    count the ``num_patches`` patch slots of the prefill."""
    return transformer.decode(params, cache, token, pos, cfg)
