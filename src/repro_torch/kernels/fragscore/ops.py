"""Public wrappers of the fragscore / mfi_delta / delta_from_base kernels
over the A100-80GB tables (pass other models' tables to the kernels in
:mod:`repro_torch.kernels.fragscore.fragscore` directly).

Tensors in, tensors out, on the operands' device: a CUDA tensor launches
the hand-written kernel, a CPU tensor takes its plain torch version, and
anything that is not a tensor raises ``TypeError``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import cluster, mig
from repro_torch.kernels.fragscore import fragscore as _k


def _tensors(**operands) -> None:
    for name, x in operands.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")


def fragmentation_scores(occ: torch.Tensor, metric: str = "blocked") -> torch.Tensor:
    """Kernel-backed F(m) over the cluster: (M, 8) int32 -> (M,) float32."""
    _tensors(occ=occ)
    t = cluster.tables_for(mig.A100_80GB, device=occ.device)
    return _k.fragscore(occ, t.placement_masks, t.placement_mem, metric=metric)


def mfi_delta_f(occ: torch.Tensor, profile_id, metric: str = "blocked") -> torch.Tensor:
    """Kernel-backed ΔF table for Algorithm 2: (M, 8) × profile -> (M, A),
    ``1e30`` where infeasible."""
    _tensors(occ=occ)
    t = cluster.tables_for(mig.A100_80GB, device=occ.device)
    return _k.mfi_delta(
        occ,
        t.placement_masks,
        t.placement_mem,
        cluster._row(t.profile_masks, profile_id).to(torch.float32),
        cluster._row(t.profile_valid, profile_id).to(torch.float32),
        metric=metric,
    )


def delta_from_base_f(
    base: torch.Tensor,
    free: torch.Tensor,
    profile_id,
    f_before: torch.Tensor,
    metric: str = "blocked",
) -> torch.Tensor:
    """Kernel-backed raw ΔF table ``(M, A)`` from window counts ``base
    (M, N)``, free slices ``free (M,)`` and scores ``f_before (M,)``.

    The reference's per-group operands as one replica (``R = 1``) of a
    one-model fleet (``K = 1``) of the engine-layout
    :func:`repro_torch.kernels.fragscore.fragscore.delta_from_base`.
    """
    _tensors(base=base, free=free, f_before=f_before)
    dev = base.device
    t = cluster.tables_for(mig.A100_80GB, device=dev)
    maskwin = t.profile_masks.to(torch.float32) @ t.placement_masks.T  # (P, A, N)
    profile_mem = torch.as_tensor(mig.A100_80GB.profile_mem, dtype=torch.float32, device=dev)
    if isinstance(profile_id, torch.Tensor):
        pid = profile_id.reshape(1).to(torch.int32)
    else:
        pid = torch.full((1,), profile_id, dtype=torch.int32, device=dev)
    out = _k.delta_from_base(
        base[None],
        free.to(torch.int32)[None],
        f_before[None],
        pid,
        torch.zeros(base.shape[0], dtype=torch.int32, device=dev),
        t.placement_mem[None],
        maskwin[None],
        profile_mem[None],
        metric=metric,
    )
    return out[0]


def mfi_select(
    occ: torch.Tensor, profile_id, metric: str = "blocked"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel-backed Algorithm 2 — thin alias for the unified entry point
    :func:`repro_torch.core.cluster.mfi_select` with ``use_kernel=True``.

    Returns the legacy ``(gpu, anchor, accepted)`` tuple.
    """
    _tensors(occ=occ)
    d = cluster.mfi_select(occ, profile_id, metric, use_kernel=True)
    return d.gpu, d.anchor, d.accepted
