"""Architecture config: llama3.2-1b [hf:meta-llama/Llama-3.2-1B].

The published widths (the JAX package's ``CONFIG``) and its reduced
``SMOKE`` configuration.  The sliding-window variant ``llama3.2-1b-sw``
is not ported: its local layers keep a ring cache that the port's decode
path does not serve yet.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256,
    mlp="swiglu", rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, mlp="swiglu", dtype="float32",
)
