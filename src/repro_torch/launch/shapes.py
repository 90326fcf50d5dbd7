"""The assigned input shapes and their batch, cache and decode specs as
``meta`` tensors (shapes and dtypes, no memory): the port's counterpart
of the JAX package's ``launch/shapes.py``.

Shape-to-batch mapping per family:
  * decoder-only: tokens (B, S)
  * vlm: 256 patch embeddings + (S - 256) text tokens  (total budget = S)
  * audio (enc-dec): encoder frames S//2 + decoder tokens S//2
Decode shapes build a serve_step over a KV cache of the full seq_len.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: InputShape, *, with_labels: bool):
    """Meta tensors of the data batch of a train/prefill step."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = cfg.torch_dtype
    if cfg.encdec:
        half = s // 2
        out = {"frames": _spec((b, half, cfg.d_model), dt), "tokens": _spec((b, half), i32)}
        if with_labels:
            out["labels"] = _spec((b, half), i32)
        return out
    if cfg.frontend == "vision":
        text = s - cfg.num_patches
        out = {"patches": _spec((b, cfg.num_patches, cfg.d_model), dt),
               "tokens": _spec((b, text), i32)}
        if with_labels:
            out["labels"] = _spec((b, text), i32)
        return out
    out = {"tokens": _spec((b, s), i32)}
    if with_labels:
        out["labels"] = _spec((b, s), i32)
    return out


def cache_specs(cfg: ModelConfig, shape: InputShape):
    """The decode cache as meta tensors (``model.init_cache`` on meta: no
    allocation).  The port stacks a kind's layers on one leading axis
    where the reference keeps ``(n_groups, n_local | n_global)``."""
    return model.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def decode_specs(cfg: ModelConfig, shape: InputShape):
    b = shape.global_batch
    return {
        "cache": cache_specs(cfg, shape),
        "token": _spec((b,), torch.int32),
        "pos": _spec((), torch.int32),
    }
