"""Architecture config: grok-1-314b [hf:xai-org/grok-1].

The published widths (the JAX package's ``CONFIG``: 8 swiglu experts, 2
chosen a token, bfloat16 AdamW moments, 8 gradient-accumulation
micro-batches) and its reduced ``SMOKE`` configuration.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072,
    n_experts=8, topk=2, mlp="swiglu",
    opt_dtype="bfloat16",  # optimizer state dominates HBM at 314B params,
    grad_accum=8
)

SMOKE = ModelConfig(
    name="grok-smoke", family="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, n_experts=4, topk=2, mlp="swiglu", dtype="float32",
)
