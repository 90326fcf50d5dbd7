"""``select_from_base``: each replica's whole MFI decision (ΔF of every
anchor dry-run and the masked lexicographic argmin) in one launch."""

NAME = "select_from_base_kernel"


def work(*, R: int, M: int, N: int, A: int, K: int, P: int, L: int):
    """Reads the window counts ``base (R, M, N)`` float32, ``free`` int32
    and ``f`` float32 ``(R, M)``, the request ``pid (R,)``, ``midx (M,)``
    and the tables (``V (K, N)``, ``maskwin (K, P, A, N)``, the anchor
    rows, values, validity and class sizes); writes gpu, anchor index and
    ok per replica.  Per candidate ``(r, m, a)``: the window count after
    the dry run, the counted, eligible and weighted terms per window, and
    ``L`` key comparisons."""
    flops = R * M * A * (4 * N + L)
    nbytes = (R * M * N * 4 + 2 * R * M * 4 + R * 4 + M * 4 + K * N * 4
              + K * P * A * N * 4 + K * P * A * (4 + 4 + 1) + K * P * 4 + R * 9)
    return flops, nbytes


def per_event(g: dict):
    """One decision per arrival; the queued protocol decides its wait
    queue's head too."""
    shape = dict(R=g["R"], M=g["M"], N=g["N"], A=g["A"], K=g["K"], P=g["P"], L=g["L"])
    return [shape] * (1 + int(g["queued"]))
