"""Architecture config: llama3.2-1b [hf:meta-llama/Llama-3.2-1B].

The published widths (the JAX package's ``CONFIG``), its sliding-window
variant ``CONFIG_SW`` (groups of fifteen local layers with 4,096-slot
ring KV caches before one global layer) and the reduced ``SMOKE``
configuration, which the registry gives both.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256,
    mlp="swiglu", rope_theta=500_000.0,
)

# Beyond-paper variant enabling long_500k on a dense family: sliding-window
# attention (1:1 local:global would still be quadratic at the globals, so the
# variant is fully local).
CONFIG_SW = ModelConfig(
    name="llama3.2-1b-sw", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256,
    mlp="swiglu", rope_theta=500_000.0,
    local_global=(15, 1), window=4096,
)

SMOKE = ModelConfig(
    name="llama-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, mlp="swiglu", dtype="float32",
)
