"""Architecture config: gemma3-12b [hf:google/gemma-3 family].

The published widths (the JAX package's ``CONFIG``) and its reduced
``SMOKE`` configuration: post-norms, a geglu MLP, and groups of five
sliding-window layers (ring KV caches of ``window`` slots) before one
full-attention layer.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    mlp="geglu", post_norm=True,
    local_global=(5, 1), window=1024, rope_theta=1_000_000.0,
    grad_accum=4
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, mlp="geglu", post_norm=True,
    local_global=(1, 1), window=32, dtype="float32",
)
