"""Plain torch versions of the five fragscore kernels.

Each function computes exactly what its CUDA kernel in ``csrc/fragscore.cu``
computes, on the same operands, in plain tensor ops.  The wrappers in
:mod:`repro_torch.kernels.fragscore.fragscore` call these for tensors that
lie on the CPU; on the card ``chip_smoke.py`` holds each kernel equal to
its plain version.  Every score is integer-valued, hence exact in float32:
equality, not tolerance, is the contract.

``mfi_delta`` takes the single-decision API's operands instead: raw
``occ (M, S)`` int32 occupancy of same-model GPUs, the model's placement
table ``w (N, S)``/``v (N,)`` and the requested class's padded anchor
windows ``profile_masks (A, S)`` with ``profile_valid (A,)``, all float32.

Operand layout of the other four (the engine's own, ``R`` replicas of an
``M``-GPU fleet of ``K`` device models, ``N`` padded placement windows,
``A`` padded anchors, ``P`` demand classes):

* ``base (R, M, N)`` float32 — occupied-slice count per placement window;
* ``free (R, M)`` int32 — free memory slices per GPU;
* ``f (R, M)`` float32 — current F(m) per GPU;
* ``pid (R,)`` int32 — each replica's demand class (``>= 0``);
* ``midx (M,)`` int32 — each GPU's device-model index;
* ``V (K, N)``, ``maskwin (K, P, A, N)``, ``profile_mem (K, P)`` float32,
  ``profile_rows``/``profile_anchors (K, P, A)`` int32,
  ``profile_valid (K, P, A)`` bool — the stacked per-model tables;
* for the migrate search, per victim ``c`` of each replica's ``C`` live
  ring entries: ``base2 (R, C, N)`` float32, ``free2 (R, C)`` int32 and
  ``f2 (R, C)`` float32 — the victim's GPU after evacuation and the
  request's placement — and ``rg``/``rp``/``kc (R, C)`` int32, its GPU,
  demand class and device model.
"""

from __future__ import annotations

import torch

#: refinement sentinel of the masked lexicographic argmin (the reference's
#: ``_BIG``); every real key value is far below it
BIG = 1e9

#: effective key bases the fused select kernel evaluates, in its code order
FUSED_KEY_CODES = ("frag-delta", "free-slices", "gpu", "anchor")


def fragscore_ref(
    occ: torch.Tensor, w: torch.Tensor, v: torch.Tensor, metric: str = "blocked"
) -> torch.Tensor:
    """F(m) of every occupancy row: ``occ (Q, S)`` any int/float dtype,
    ``w (N, S)`` placement windows, ``v (N,)`` window sizes -> ``(Q,)``
    float32."""
    occf = occ.to(torch.float32)
    inwin = occf @ w.T  # (Q, N) occupied count per window
    if metric == "blocked":
        counted = inwin > 0
    elif metric == "partial":
        counted = (inwin > 0) & (inwin < v[None, :])
    else:
        raise ValueError(f"unknown metric {metric!r}")
    free = occf.shape[-1] - occf.sum(dim=-1, keepdim=True)
    eligible = v[None, :] <= free
    return torch.where(counted & eligible, v[None, :], 0.0).sum(dim=-1)


#: the ``mfi_delta`` kernel's own infeasibility sentinel (the reference's)
MFI_BIG = 1e30


def mfi_delta_ref(
    occ: torch.Tensor,
    w: torch.Tensor,
    v: torch.Tensor,
    profile_masks: torch.Tensor,
    profile_valid: torch.Tensor,
    metric: str = "blocked",
) -> torch.Tensor:
    """ΔF of placing the requested class at each anchor of every GPU,
    ``(M, A)`` float32, exactly :data:`MFI_BIG` where the placement is
    infeasible (the window overlaps occupancy, or the anchor is padding).

    The reference's arithmetic: ``F(min(occ + mask, 1)) − F(occ)`` with
    float32 window counts, so any occupancy values give its answer.
    """
    occf = occ.to(torch.float32)
    m, s = occf.shape
    a = profile_masks.shape[0]
    masks = profile_masks.to(torch.float32)
    f_before = fragscore_ref(occf, w, v, metric)                       # (M,)
    overlap = (occf[:, None, :] * masks[None]).sum(dim=-1)             # (M, A)
    feasible = (overlap == 0) & (profile_valid > 0)[None, :]
    hypo = torch.clamp(occf[:, None, :] + masks[None], max=1.0)        # (M, A, S)
    f_after = fragscore_ref(hypo.reshape(m * a, s), w, v, metric).reshape(m, a)
    return torch.where(feasible, f_after - f_before[:, None], MFI_BIG)


def class_rows(table: torch.Tensor, k: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``table[k, p]`` for a ``(K, P, …)`` class table and index tensors
    ``k`` (model) and ``p`` (class) that broadcast together, as one
    ``index_select`` of whole rows (the same values as advanced indexing,
    several times faster on the CPU)."""
    n_k, n_p = table.shape[:2]
    idx = k.long() * n_p + p.long()
    rows = table.reshape((n_k * n_p,) + table.shape[2:]).index_select(0, idx.reshape(-1))
    return rows.reshape(idx.shape + table.shape[2:])


def _delta_dense(base, free, f, v, mw, mem, metric: str) -> torch.Tensor:
    """ΔF of every anchor dry-run on rows ``base (..., N)``: ``(..., A)``.

    ``v (..., N)`` are the rows' window sizes, ``mw (..., A, N)`` the slices
    each anchor adds per window, ``mem (...)`` the request's slice demand
    and ``free``/``f (...)`` the rows' free slices and F.  The dense form:
    window counts after a placement are ``base + mw`` (a feasible window is
    disjoint from the current occupancy); eligibility compares window sizes
    with the post-allocation free count.  Raw (no feasibility mask).
    """
    ba = torch.add(mw, base[..., None, :])                 # (..., A, N)
    if metric == "blocked":
        counted = torch.gt(ba, 0, out=ba)                  # 1.0 / 0.0, in place
    elif metric == "partial":
        counted = ((ba > 0) & (ba < v[..., None, :])).to(torch.float32)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    free_after = free.to(torch.float32) - mem              # (...)
    eligible = torch.where(v <= free_after[..., None], v, 0.0)  # (..., N)
    # the counted windows' sizes summed as a product: the sizes are whole
    # (or half) slice counts, so the sum is exact in any order
    f_after = (counted @ eligible[..., None])[..., 0]
    return f_after - f[..., None]


def delta_from_base_ref(
    base, free, f, pid, midx, V, maskwin, profile_mem, metric: str = "blocked"
) -> torch.Tensor:
    """ΔF of every anchor dry-run of each replica's request: ``(R, M, A)``."""
    mi, pi = midx.long()[None, :], pid.long()[:, None]
    return _delta_dense(base, free, f, V[midx.long()][None], class_rows(maskwin, mi, pi),
                        profile_mem[mi, pi], metric)


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first ``True`` along the last axis, 0 where there is
    none (``argmax`` of a boolean mask)."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    k = torch.where(mask, idx, n).amin(dim=-1)
    return torch.where(k < n, k, 0)


def lex_argmin(feasible: torch.Tensor, vals) -> tuple:
    """Masked lexicographic argmin over each replica's ``(M, A)`` table.

    ``vals`` lists ``(R, M, A)``-broadcastable signed key tensors in spec
    order; each narrows the candidate mask to its minimizers, and the
    first surviving flat index ``gpu·A + col`` breaks the remaining ties.
    Returns ``(gpu, col, ok)`` — ``(0, 0, False)`` where nothing is
    feasible.
    """
    mask = feasible
    for val in vals:
        masked = torch.where(mask, val, BIG)
        mask = mask & (masked == masked.amin(dim=(1, 2), keepdim=True))
    r, m, a = feasible.shape
    flat = mask.reshape(r, m * a)
    k = first_true(flat)
    return k // a, k % a, flat.any(dim=1)


def refine_rows(feasible: torch.Tensor, vals) -> tuple:
    """Masked lexicographic refinement of every row along the last
    (anchor) axis of ``feasible (..., A)``.

    Returns ``(col, ok, keys)``: the first surviving column (0 where no
    anchor is feasible), whether one survived, and the key values at that
    column, ``(..., L)``, taken *unmasked* — an all-infeasible row reports
    column 0's values.
    """
    mask = feasible
    full = [torch.broadcast_to(v, feasible.shape) for v in vals]
    for val in full:
        masked = torch.where(mask, val, BIG)
        mask = mask & (masked == masked.amin(dim=-1, keepdim=True))
    col = first_true(mask)
    keys = [torch.gather(v, -1, col[..., None])[..., 0] for v in full]
    keys = (torch.stack(keys, dim=-1) if keys
            else feasible.new_zeros(feasible.shape[:-1] + (0,), dtype=torch.float32))
    return col, mask.any(dim=-1), keys


def _lex_best(keys: torch.Tensor, mask: torch.Tensor):
    for i in range(keys.shape[-1]):
        masked = torch.where(mask, keys[..., i], BIG)
        mask = mask & (masked == masked.amin(dim=-1, keepdim=True))
    return first_true(mask), mask.any(dim=-1)


def lex_top2(keys: torch.Tensor, ok: torch.Tensor) -> tuple:
    """Best and runner-up row of ``keys (..., M, L)`` among the valid rows
    ``ok (..., M)``, by ``(keys…, row)``.

    The runner-up excludes the winner's row only where a winner exists;
    with no winner both indices are 0, and a single valid row gives
    ``ok2 = False``.  Returns ``(g1, ok1, g2, ok2)``, each ``(...)``.
    """
    g1, ok1 = _lex_best(keys, ok)
    m = ok.shape[-1]
    excl = ~ok1[..., None] | (torch.arange(m, device=ok.device) != g1[..., None])
    g2, ok2 = _lex_best(keys, ok & excl)
    return g1, ok1, g2, ok2


def _fused_vals(keys, delta, free_after, gid, anchors):
    """Signed key tensors of an effective key tuple: ``delta`` is a
    callable that builds the ΔF table on first use."""
    vals = []
    for base_key, sign in keys:
        if base_key == "frag-delta":
            val = delta()
        elif base_key == "free-slices":
            val = free_after[..., None]
        elif base_key == "gpu":
            val = gid.to(torch.float32)[..., None]
        elif base_key == "anchor":
            val = anchors.to(torch.float32)
        else:
            raise ValueError(f"key {base_key!r} is not argmin-fusable")
        vals.append(-val if sign < 0 else val)
    return vals


def select_from_base_ref(
    base, free, f, pid, midx, V, maskwin, profile_rows, profile_valid,
    profile_anchors, profile_mem, keys, metric: str = "blocked",
):
    """Fused-select plain version: feasibility, ΔF and the masked
    lexicographic argmin over the effective ``keys`` (``((base, sign), …)``
    with bases from :data:`FUSED_KEY_CODES`), per replica.

    Returns ``(gpu, col, ok)`` of shape ``(R,)`` each.
    """
    mi, pi = midx.long()[None, :], pid.long()[:, None]
    rows = profile_rows[mi, pi].long()                      # (R, M, A)
    feas = (torch.gather(base, 2, rows) == 0) & profile_valid[mi, pi]
    mem = profile_mem[mi, pi]                               # (R, M)
    gid = torch.arange(base.shape[1], device=base.device)[None, :]
    vals = _fused_vals(
        keys,
        lambda: delta_from_base_ref(base, free, f, pid, midx, V, maskwin, profile_mem, metric),
        free.to(torch.float32) - mem, gid, profile_anchors[mi, pi],
    )
    return lex_argmin(feas, vals)


def migrate_refine_ref(
    base, free, f, base2, free2, f2, rg, rp, kc, midx, V, maskwin,
    profile_rows, profile_valid, profile_anchors, profile_mem, keys,
    metric: str = "blocked",
):
    """Migrate-search plain version: both refinements of the factored
    defrag search over the effective ``keys``.

    *Pass 0*, per replica and demand class ``p``: every GPU row of the
    untouched cluster is refined along its anchors (the first surviving
    column breaks ties), and the best and runner-up rows by ``(keys…,
    gpu)`` are kept.  *Pass 1*, per victim: its patched row (``base2``,
    ``free2``, ``f2`` on GPU ``rg``, class ``rp``, model ``kc``) is refined
    along its anchors.

    Returns ``(g1, ok1, a1, k1, g2, ok2, a2, k2, ap, okp, kp)``: the pass-0
    rows ``(R, P)`` (gpu, ok, column) and ``(R, P, L)`` keys, with gpu and
    column 0 and keys :data:`BIG` where not ok; the pass-1 rows ``(R, C)``
    (column, ok) and ``(R, C, L)`` keys, taken unmasked at column 0 where
    no anchor is feasible.
    """
    r, m, _ = base.shape
    p_count = maskwin.shape[1]
    mi = midx.long()[None, :]                                       # (1, M)
    pi = torch.arange(p_count, device=base.device)[:, None]         # (P, 1)
    # every class at once: (R, P, M, A) tables against the state (R, 1, M, …)
    rows = profile_rows[mi, pi].long()[None].expand(r, -1, -1, -1)  # (R, P, M, A)
    feas = ((torch.gather(base[:, None].expand(-1, p_count, -1, -1), 3, rows) == 0)
            & profile_valid[mi, pi])
    mem = profile_mem[mi, pi]                                       # (P, M)
    vals = _fused_vals(
        keys,
        lambda: _delta_dense(base[:, None], free[:, None], f[:, None], V[mi], maskwin[mi, pi],
                             mem, metric),
        free[:, None].to(torch.float32) - mem, torch.arange(m, device=base.device)[None, None],
        profile_anchors[mi, pi],
    )
    col, ok, kr = refine_rows(feas, vals)                           # (R, P, M), (R, P, M, L)
    g1, ok1, g2, ok2 = lex_top2(kr, ok)                             # (R, P) each
    pass0 = []
    for g, okg in ((g1, ok1), (g2, ok2)):
        a = torch.gather(col, 2, g[..., None])[..., 0]
        k = torch.gather(kr, 2, g[..., None, None].expand(-1, -1, 1, kr.shape[-1]))[:, :, 0]
        pass0 += [g, okg, torch.where(okg, a, 0), torch.where(okg[..., None], k, BIG)]
    g1, ok1, a1, k1, g2, ok2, a2, k2 = pass0

    kcl, rpl = kc.long(), rp.long()
    rows = profile_rows[kcl, rpl].long()                            # (R, C, A)
    feas = (torch.gather(base2, 2, rows) == 0) & profile_valid[kcl, rpl]
    mem = profile_mem[kcl, rpl]                                     # (R, C)
    vals = _fused_vals(
        keys,
        lambda: _delta_dense(base2, free2, f2, V[kcl], class_rows(maskwin, kcl, rpl), mem, metric),
        free2.to(torch.float32) - mem, rg, profile_anchors[kcl, rpl],
    )
    ap, okp, kp = refine_rows(feas, vals)
    i32 = torch.int32
    return (g1.to(i32), ok1, a1.to(i32), k1, g2.to(i32), ok2, a2.to(i32), k2,
            ap.to(i32), okp, kp)
