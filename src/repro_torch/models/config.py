"""Model configuration shared by all architecture families.

The port's copy of the JAX package's :class:`ModelConfig`, field for
field, so one configuration describes the same model in both packages.
The port runs the dense, vlm and moe families
(``repro_torch.models.transformer``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None  # default: d_model // n_heads
    qk_norm: bool = False
    post_norm: bool = False         # gemma3-style post-attn/post-mlp norms
    mlp: str = "swiglu"             # "swiglu" | "geglu" | "gelu"
    pos: str = "rope"               # "rope" | "learned" | "sincos" | "none"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True

    # local:global attention pattern — layers are grouped as
    # [n_local × sliding-window, n_global × full]; n_layers must be divisible
    # by (n_local + n_global).  None -> all layers full attention.
    local_global: Optional[Tuple[int, int]] = None
    window: int = 1024              # sliding-window size for local layers

    # MoE
    n_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256

    # blockwise-attention tile size (the reference's memory/perf knob)
    attn_blk: int = 512
    # gradient-accumulation microbatches per train step (memory knob)
    grad_accum: int = 1

    # hybrid (Hymba): parallel attention + SSM heads in every layer
    hybrid: bool = False

    # encoder-decoder (Whisper)
    encdec: bool = False
    n_enc_layers: int = 0

    # modality frontend stub: embeddings provided directly by input_specs()
    frontend: Optional[str] = None  # None | "audio" | "vision"
    num_patches: int = 256          # vision: tokens contributed by the stub

    dtype: str = "bfloat16"
    # AdamW moment dtype ("float32" normally; "bfloat16" for very large models)
    opt_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.local_global is not None:
            g = sum(self.local_global)
            if self.n_layers % g:
                raise ValueError(
                    f"n_layers={self.n_layers} not divisible by group {g}"
                )
        if self.family == "moe" and (self.n_experts <= 0 or self.topk <= 0):
            raise ValueError("moe family needs n_experts/topk")

    # -- derived ------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 (the reference's
        layout, kept so parameters carry over); logits beyond ``vocab`` are
        masked at decode."""
        return -(-self.vocab // 256) * 256

    @property
    def group_pattern(self) -> Tuple[int, int]:
        """(n_local, n_global) per scan group; (0, 1) means all-global."""
        return self.local_global if self.local_global else (0, 1)

    @property
    def n_groups(self) -> int:
        return self.n_layers // sum(self.group_pattern)

    @property
    def ssm_dinner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_dinner // self.ssm_headdim

    def param_count(self) -> int:
        """Total parameters (N for roofline 6·N·D), the reference's count:
        the unpadded vocabulary's embedding rows."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.head_dim
        h, kv = self.n_heads, self.n_kv_heads
        attn = d * hd * (h + 2 * kv) + h * hd * d  # qkv + out
        if self.qk_norm:
            attn += 2 * hd
        gated = self.mlp in ("swiglu", "geglu")
        mlp = d * f * (3 if gated else 2)
        if self.family == "moe":
            mlp = self.n_experts * mlp + d * self.n_experts  # + router
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, n, hh = self.ssm_dinner, self.ssm_state, self.ssm_nheads
            # in_proj (z,x,B,C,dt) + conv + out_proj + A/D/dt_bias + gated norm
            ssm = d * (2 * di + 2 * n + hh) + self.conv_width * (di + 2 * n) \
                + di * d + 3 * hh + di
        norms = 2 * d * (2 if self.post_norm else 1)
        if self.family == "ssm":
            per_layer = ssm + norms
        elif self.family == "hybrid":
            per_layer = attn + ssm + mlp + norms + d  # + fusion norms approx
        else:
            per_layer = attn + mlp + norms
        total = self.n_layers * per_layer + v * d + d  # embed + final norm
        if self.encdec:
            enc_layer = attn + mlp + norms
            total += self.n_enc_layers * (enc_layer + attn + d)  # + cross-attn
        if self.frontend == "vision":
            total += d * d  # projector
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: topk of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        gated = self.mlp in ("swiglu", "geglu")
        expert = d * f * (3 if gated else 2)
        dense_total = self.param_count()
        return int(dense_total - self.n_layers * (self.n_experts - self.topk) * expert)
