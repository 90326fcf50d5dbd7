"""``fragscore``: F(m) of a batch of occupancy rows (the rescore of the
rows a drain or a commit touched)."""

NAME = "fragscore_kernel"


def work(*, rows: int, windows: int, slices: int):
    """One launch over ``rows`` occupancy rows ``(rows, S)`` int32 against
    the placement table ``W (N, S)``, ``V (N,)`` float32; one float32 F per
    row.  Per row and window: the occupied count (S multiply-adds) and the
    counted, eligible and weighted terms (3 operations)."""
    flops = rows * windows * (2 * slices + 3)
    nbytes = rows * slices * 4 + windows * slices * 4 + windows * 4 + rows * 4
    return flops, nbytes


def per_event(g: dict):
    """The drain rescores the drained ring row's ``ring_cols`` entries of
    every replica; each commit rescores one row per replica (the arrival;
    the queue head's admission; a migrated victim's landing row)."""
    commits = 1 + int(g["queued"]) + int(g["defrag"])
    rows = [g["R"] * g["ring_cols"]] + [g["R"]] * commits
    return [dict(rows=q, windows=g["N"], slices=g["S"]) for q in rows]
