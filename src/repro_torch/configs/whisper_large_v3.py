"""Architecture config: whisper-large-v3 [arXiv:2212.04356].

The published widths (the JAX package's ``CONFIG``) and its reduced
``SMOKE`` configuration: an encoder-decoder of 32 + 32 layers over stub
frame embeddings, 20 heads with 20 KV heads (G = 1), gelu MLPs, learned
decoder positions and sinusoidal encoder ones.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866,
    encdec=True, n_enc_layers=32, pos="learned", mlp="gelu",
    frontend="audio",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab=512, encdec=True, n_enc_layers=2, pos="learned",
    mlp="gelu", frontend="audio", dtype="float32",
)
