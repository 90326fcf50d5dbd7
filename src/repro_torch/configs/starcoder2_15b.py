"""Architecture config: starcoder2-15b [arXiv:2402.19173].

The published widths (the JAX package's ``CONFIG``) and its reduced
``SMOKE`` configuration: the dense layer with a plain gelu MLP.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152,
    mlp="gelu", rope_theta=100_000.0,
    grad_accum=4
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, mlp="gelu", dtype="float32",
)
