"""Chunked driver: share of the traced window the host spent staging the
stream's chunks into pinned buffers and queueing their copies
(``simulate_chunked``'s ``h2d_seconds``)."""


def read(ctx):
    if ctx["window_s"] <= 0 or "h2d_seconds" not in ctx["stats"]:
        return None
    return ctx["stats"]["h2d_seconds"] / ctx["window_s"]
