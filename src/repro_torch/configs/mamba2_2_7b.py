"""Architecture config: mamba2-2.7b [arXiv:2405.21060].

The published widths (the JAX package's ``CONFIG``) and its reduced
``SMOKE`` configuration: 64 Mamba-2 (SSD) layers, no attention and no
positions; two gradient-accumulation micro-batches a training step.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, conv_width=4, ssm_chunk=256,
    pos="none",
    grad_accum=2
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=256, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=512, ssm_state=32, ssm_headdim=32, ssm_chunk=32,
    pos="none", dtype="float32",
)
