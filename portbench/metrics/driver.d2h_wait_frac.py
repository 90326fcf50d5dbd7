"""Chunked driver: share of the traced window the host spent waiting for
chunks' traces to come back (``simulate_chunked``'s ``d2h_seconds``)."""


def read(ctx):
    if ctx["window_s"] <= 0 or "d2h_seconds" not in ctx["stats"]:
        return None
    return ctx["stats"]["d2h_seconds"] / ctx["window_s"]
