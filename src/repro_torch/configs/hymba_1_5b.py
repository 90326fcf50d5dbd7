"""Architecture config: hymba-1.5b [arXiv:2411.13676].

The published widths (the JAX package's ``CONFIG``) and its reduced
``SMOKE`` configuration: every layer runs an attention head group and a
Mamba-2 (SSD) head side by side on the same input, in groups of fifteen
sliding-window layers (window 1,024) before one global layer.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    local_global=(15, 1), window=1024, mlp="swiglu",
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, ssm_state=16, ssm_headdim=32, ssm_chunk=32,
    local_global=(1, 1), window=32, mlp="swiglu", dtype="float32",
)
