"""Event loop: device kernels launched per engine event (every replica
steps each event together), from the profiler's kernel records."""


def read(ctx):
    if not ctx["events"] or not ctx["kernels"]:
        return None
    return len(ctx["kernels"]) / ctx["events"]
