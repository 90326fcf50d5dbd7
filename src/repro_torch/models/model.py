"""Model API of the serving path (dense family).

  * ``param_defs(cfg)`` / ``init_params(cfg, generator, device=None)``
  * ``params_from_numpy(tree, cfg, device=None)`` — the JAX package's
    parameter tree, as numpy arrays, carried over into the port's module
  * ``prefill(params, batch, cfg)``  — returns (last-token logits, cache)
  * ``decode_step(params, cache, token, pos, cfg)``
  * ``init_cache(cfg, batch, seq_len, device=None)`` / ``pad_cache``

Entry points take ``device=None``, meaning the CUDA card; they raise when
there is none.  Pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
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


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])  # torch wants writable memory
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits over
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> transformer.Transformer:
    """The reference's ``init_params`` tree (leaves as numpy arrays, bf16
    leaves as ``ml_dtypes.bfloat16``) as the port's module; the stacked
    ``(n_groups, n_global, …)`` layer leaves become one module per layer."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _tensor(np.asarray(t), dev)

    return transformer.Transformer(cfg, walk(tree))


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
