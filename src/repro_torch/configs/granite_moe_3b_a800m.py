"""Architecture config: granite-moe-3b-a800m [hf:ibm-granite/granite-3.0 family].

The published widths (the JAX package's ``CONFIG``) and its reduced
``SMOKE`` configuration: 40 swiglu experts, 8 chosen a token.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, topk=8, mlp="swiglu",
)

SMOKE = ModelConfig(
    name="granite-smoke", family="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=128, vocab=512, n_experts=4, topk=2, mlp="swiglu", dtype="float32",
)
