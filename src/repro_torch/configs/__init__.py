"""Architecture registry: the JAX package's registry, entry for entry.

``ARCHS`` (the published widths), ``SMOKES`` (the reduced configs),
``ASSIGNED`` (the ten assigned architectures, without the local
sliding-window variant) and ``LONG_CONTEXT_OK`` (the architectures with
sub-quadratic attention), with the reference's keys and entries:
``llama3.2-1b`` and its sliding-window variant, ``qwen3-14b`` (qk-norm),
``gemma3-12b`` (post-norms, 5:1 local/global groups), ``starcoder2-15b``
(gelu), ``paligemma-3b`` (the vision prefix), ``granite-moe-3b-a800m``
and ``grok-1-314b`` (experts), ``mamba2-2.7b`` (Mamba-2 SSD layers),
``hymba-1.5b`` (attention and SSD heads side by side) and
``whisper-large-v3`` (the encoder-decoder, learned positions).
"""

from repro_torch.configs import (
    gemma3_12b,
    granite_moe_3b_a800m,
    grok_1_314b,
    hymba_1_5b,
    llama3_2_1b,
    mamba2_2_7b,
    paligemma_3b,
    qwen3_14b,
    starcoder2_15b,
    whisper_large_v3,
)

ARCHS = {
    "qwen3-14b": qwen3_14b.CONFIG,
    "paligemma-3b": paligemma_3b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "llama3.2-1b-sw": llama3_2_1b.CONFIG_SW,  # beyond-paper sliding-window variant
    "whisper-large-v3": whisper_large_v3.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
    "gemma3-12b": gemma3_12b.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
}

# the 10 officially assigned ids (excludes local variants)
ASSIGNED = [
    "qwen3-14b", "paligemma-3b", "grok-1-314b", "llama3.2-1b",
    "whisper-large-v3", "mamba2-2.7b", "gemma3-12b", "starcoder2-15b",
    "hymba-1.5b", "granite-moe-3b-a800m",
]

SMOKES = {
    "qwen3-14b": qwen3_14b.SMOKE,
    "paligemma-3b": paligemma_3b.SMOKE,
    "grok-1-314b": grok_1_314b.SMOKE,
    "llama3.2-1b": llama3_2_1b.SMOKE,
    "llama3.2-1b-sw": llama3_2_1b.SMOKE,
    "whisper-large-v3": whisper_large_v3.SMOKE,
    "mamba2-2.7b": mamba2_2_7b.SMOKE,
    "gemma3-12b": gemma3_12b.SMOKE,
    "starcoder2-15b": starcoder2_15b.SMOKE,
    "hymba-1.5b": hymba_1_5b.SMOKE,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.SMOKE,
}

# archs with sub-quadratic attention, eligible for the long_500k shape
# (pure full-attention archs skip it)
LONG_CONTEXT_OK = {"mamba2-2.7b", "hymba-1.5b", "gemma3-12b", "llama3.2-1b-sw"}


def get_config(arch: str):
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; options: {sorted(ARCHS)}")
