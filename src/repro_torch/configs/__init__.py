"""Architecture registry of the architectures the port runs.

The dense-layer and mixture-of-experts architectures of the JAX
package's registry, with the same keys and entries: ``llama3.2-1b`` and
its sliding-window variant, ``qwen3-14b`` (qk-norm), ``gemma3-12b``
(post-norms, 5:1 local/global groups), ``starcoder2-15b`` (gelu),
``paligemma-3b`` (the vision prefix), ``granite-moe-3b-a800m`` and
``grok-1-314b`` (experts).  The ssm, hybrid and encoder-decoder
architectures are listed in ROADMAP.md.
"""

from repro_torch.configs import (
    gemma3_12b,
    granite_moe_3b_a800m,
    grok_1_314b,
    llama3_2_1b,
    paligemma_3b,
    qwen3_14b,
    starcoder2_15b,
)

ARCHS = {
    "qwen3-14b": qwen3_14b.CONFIG,
    "paligemma-3b": paligemma_3b.CONFIG,
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "llama3.2-1b-sw": llama3_2_1b.CONFIG_SW,
    "gemma3-12b": gemma3_12b.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
}

SMOKES = {
    "qwen3-14b": qwen3_14b.SMOKE,
    "paligemma-3b": paligemma_3b.SMOKE,
    "llama3.2-1b": llama3_2_1b.SMOKE,
    "llama3.2-1b-sw": llama3_2_1b.SMOKE,
    "gemma3-12b": gemma3_12b.SMOKE,
    "starcoder2-15b": starcoder2_15b.SMOKE,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.SMOKE,
    "grok-1-314b": grok_1_314b.SMOKE,
}


def get_config(arch: str):
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; options: {sorted(ARCHS)}")
