"""``migrate_refine``: both refinements of the single-migration search
(per class the best and runner-up untouched GPU rows; per victim its
patched row) in one launch."""

NAME = "migrate_refine_kernel"


def work(*, R: int, M: int, C: int, N: int, A: int, K: int, P: int, L: int):
    """Reads ``base (R, M, N)``, ``free``/``f (R, M)``, the victims' patched
    rows ``base2 (R, C, N)``, ``free2``/``f2 (R, C)``, their GPU, class and
    model ``(R, C)`` int32 and the tables; writes per class the two best
    rows (gpu, ok, anchor, keys) and per victim its patched row's winner
    (anchor, ok, keys).  Per candidate (every class on every untouched row,
    every victim's class on its patched row): the window terms and ``L``
    key comparisons."""
    flops = (R * P * M * A + R * C * A) * (4 * N + L)
    reads = (R * M * N * 4 + 2 * R * M * 4 + R * C * N * 4 + 2 * R * C * 4 + 3 * R * C * 4
             + M * 4 + K * N * 4 + K * P * A * N * 4 + K * P * A * (4 + 4 + 1) + K * P * 4)
    writes = 2 * R * P * (4 + 1 + 4 + L * 4) + R * C * (4 + 1 + L * 4)
    return flops, reads + writes


def per_event(g: dict):
    """One search per event of a defrag scheduler, over the live victims
    (at most ``C_live = min(ring cells, M·S)``: every running workload
    holds a slice)."""
    if not g["defrag"]:
        return []
    return [dict(R=g["R"], M=g["M"], C=g["C_live"], N=g["N"], A=g["A"], K=g["K"],
                 P=g["P"], L=g["L"])]
