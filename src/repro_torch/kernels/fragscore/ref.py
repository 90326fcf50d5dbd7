"""Plain torch versions of the three fragscore kernels.

Each function computes exactly what its CUDA kernel in ``csrc/fragscore.cu``
computes, on the same operands, in plain tensor ops.  The wrappers in
:mod:`repro_torch.kernels.fragscore.fragscore` call these for tensors that
lie on the CPU; on the card ``chip_smoke.py`` holds each kernel equal to
its plain version.  Every score is integer-valued, hence exact in float32:
equality, not tolerance, is the contract.

Operand layout (the engine's own, ``R`` replicas of an ``M``-GPU fleet of
``K`` device models, ``N`` padded placement windows, ``A`` padded anchors,
``P`` demand classes):

* ``base (R, M, N)`` float32 — occupied-slice count per placement window;
* ``free (R, M)`` int32 — free memory slices per GPU;
* ``f (R, M)`` float32 — current F(m) per GPU;
* ``pid (R,)`` int32 — each replica's demand class (``>= 0``);
* ``midx (M,)`` int32 — each GPU's device-model index;
* ``V (K, N)``, ``maskwin (K, P, A, N)``, ``profile_mem (K, P)`` float32,
  ``profile_rows``/``profile_anchors (K, P, A)`` int32,
  ``profile_valid (K, P, A)`` bool — the stacked per-model tables.
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


def delta_from_base_ref(
    base, free, f, pid, midx, V, maskwin, profile_mem, metric: str = "blocked"
) -> torch.Tensor:
    """ΔF of every anchor dry-run of each replica's request: ``(R, M, A)``.

    The dense ``(R, M, A, N)`` form: window counts after a placement are
    ``base + maskwin`` (a feasible window is disjoint from the current
    occupancy); eligibility compares window sizes with the
    post-allocation free count.  The result is raw (no feasibility mask).
    """
    mi, pi = midx.long()[None, :], pid.long()[:, None]
    v = V[midx.long()]                                     # (M, N)
    ba = base[:, :, None, :] + maskwin[mi, pi]             # (R, M, A, N)
    if metric == "blocked":
        counted = ba > 0
    elif metric == "partial":
        counted = (ba > 0) & (ba < v[None, :, None, :])
    else:
        raise ValueError(f"unknown metric {metric!r}")
    free_after = free.to(torch.float32) - profile_mem[mi, pi]  # (R, M)
    eligible = v[None, :, None, :] <= free_after[:, :, None, None]
    f_after = torch.where(counted & eligible, v[None, :, None, :], 0.0).sum(dim=-1)
    return f_after - f[:, :, None]


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
    idx = torch.arange(m * a, device=feasible.device)
    ok = flat.any(dim=1)
    k = torch.where(flat, idx, m * a).amin(dim=1)
    k = torch.where(ok, k, 0)
    return k // a, k % a, ok


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
    m = base.shape[1]
    delta = None
    vals = []
    for base_key, sign in keys:
        if base_key == "frag-delta":
            if delta is None:
                delta = delta_from_base_ref(
                    base, free, f, pid, midx, V, maskwin, profile_mem, metric
                )
            val = delta
        elif base_key == "free-slices":
            val = (free.to(torch.float32) - mem)[:, :, None]
        elif base_key == "gpu":
            val = torch.arange(m, dtype=torch.float32, device=base.device)[None, :, None]
        elif base_key == "anchor":
            val = profile_anchors[mi, pi].to(torch.float32)
        else:
            raise ValueError(f"key {base_key!r} is not argmin-fusable")
        vals.append(-val if sign < 0 else val)
    return lex_argmin(feas, vals)
