"""Architecture config: qwen3-14b [hf:Qwen/Qwen3-8B family].

The published widths (the JAX package's ``CONFIG``) and its reduced
``SMOKE`` configuration: the dense layer with qk-norm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936,
    qk_norm=True, mlp="swiglu", rope_theta=1_000_000.0,
    grad_accum=4
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, qk_norm=True, mlp="swiglu", dtype="float32",
)
