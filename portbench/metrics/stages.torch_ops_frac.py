"""Stages: share of the kernels' device time spent in kernels that are not
the program's own CUDA kernels (the stages' plain torch operations)."""


def read(ctx):
    total = sum(d for _, _, d in ctx["kernels"])
    if total <= 0:
        return None
    own = sum(d for name, _, d in ctx["kernels"]
              if any(k in name for k in ctx["own_kernels"]))
    return (total - own) / total
