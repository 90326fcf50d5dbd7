"""Device: share of the traced window in which no operation ran on the
card (the union of kernel, copy and fill intervals against the window)."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 1.0 - ctx["busy_s"] / ctx["window_s"]
