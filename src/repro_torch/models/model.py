"""Model API of the dense family: training loss and serving.

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
    the stacked ``(n_groups, n_global, …)`` layer leaves become one module
    per layer."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _tensor(t, dev)

    return transformer.Transformer(cfg, walk(tree))


def params_to_tree(params: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: ModelConfig):
    """The inverse of :func:`params_from_numpy`: the reference's tree
    (``embed``, ``final_norm``, ``groups/global/...`` with leading
    ``(n_groups, n_global)`` axes) of detached tensors.  ``params`` is the
    module or a ``{name: tensor}`` mapping keyed as its
    ``named_parameters()`` (an AdamW moment)."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)
    lead = (cfg.n_groups, cfg.group_pattern[1])
    stacked: Dict[str, object] = {}
    for path in (k[len("layers.0."):] for k in named if k.startswith("layers.0.")):
        t = torch.stack([named[f"layers.{i}.{path}"].detach() for i in range(cfg.n_layers)])
        node = stacked
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t.reshape(lead + t.shape[1:])
    return {"embed": named["embed"].detach(), "final_norm": named["final_norm"].detach(),
            "groups": {"global": stacked}}


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
    """Mean next-token cross-entropy (float32) of a dense-family batch:
    ``tokens`` (B, S) and ``labels`` (B, S), -1 = ignore."""
    if cfg.encdec or cfg.frontend == "vision":
        raise NotImplementedError(
            "the encdec and vlm losses are not ported yet (ROADMAP.md §1 item 6 (b))")
    x, _ = transformer.forward(params, batch, cfg, train=True)
    return common.chunked_ce_loss(x, params.embed, batch["labels"], valid_vocab=cfg.vocab)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    return transformer.init_cache(cfg, batch, seq_len, resolve_device(device))


def pad_cache(cache: Dict[str, torch.Tensor], prefill_len: int, max_len: int):
    """Grow the linear KV caches from ``prefill_len`` to ``max_len`` slots
    (zeros after the prompt)."""
    out = {}
    for name, x in cache.items():
        if x.shape[-3] != prefill_len:
            raise ValueError(f"cache {name!r} holds {x.shape[-3]} slots, not {prefill_len}")
        shape = x.shape[:-3] + (max_len,) + x.shape[-2:]
        y = torch.zeros(shape, dtype=x.dtype, device=x.device)
        y[..., :prefill_len, :, :] = x
        out[name] = y
    return out


def prefill(params: transformer.Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Process the full prompt; returns (last-token logits (B, V) float32,
    cache)."""
    x, cache = transformer.forward(params, batch, cfg, return_cache=True)
    return transformer.logits_of(params, x[:, -1], cfg), cache


def decode_step(params: transformer.Transformer, cache, token: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """One new token (B,) at position ``pos`` -> (logits (B, V), cache);
    the cache is updated in place."""
    return transformer.decode(params, cache, token, pos, cfg)
