"""Architecture registry of the architectures the port runs.

Only ``llama3.2-1b`` so far (dense family, linear KV cache); the other
architectures of the JAX package's registry are listed in ROADMAP.md.
"""

from repro_torch.configs import llama3_2_1b

ARCHS = {
    "llama3.2-1b": llama3_2_1b.CONFIG,
}

SMOKES = {
    "llama3.2-1b": llama3_2_1b.SMOKE,
}


def get_config(arch: str):
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; options: {sorted(ARCHS)}")
