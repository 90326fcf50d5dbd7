"""Architecture config: paligemma-3b [arXiv:2407.07726].

The published widths (the JAX package's ``CONFIG``) and its reduced
``SMOKE`` configuration: the dense layer behind a vision prefix of
``num_patches`` stub patch embeddings projected by ``vision_proj``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216,
    mlp="geglu", frontend="vision", num_patches=256,
)

SMOKE = ModelConfig(
    name="paligemma-smoke", family="vlm",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, head_dim=64,
    d_ff=512, vocab=512, mlp="geglu", frontend="vision", num_patches=16,
    dtype="float32",
)
