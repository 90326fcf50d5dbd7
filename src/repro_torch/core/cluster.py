"""Per-device-model placement tables, fragmentation scoring and the
single-decision MFI scheduler in torch.

The paper's Algorithms 1/2 are per-GPU python loops; here they are bitmask
algebra over a batch of GPUs: occupancy ``X (M, S)`` against the device
model's placement-window matrix ``Wᵀ (S, N)``, the partial-window
predicate and a weighted reduction.  Every score is integer-valued, hence
exact in float32.

:func:`mfi_select` is the one entry point of both lowerings of Algorithm
2: the dense torch dry run and the hand-written ``mfi_delta`` CUDA kernel
(``use_kernel=True``).  Every function here follows its tensors' device;
a profile id may be a Python int or a 0-d integer tensor on ``occ``'s
device, which is never read back to the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mig
from repro_torch.device import resolve_device
from repro_torch.kernels.fragscore import fragscore as _k
from repro_torch.kernels.fragscore.ref import MFI_BIG, first_true

MAX_ANCHORS = max(p.num_placements for p in mig.PROFILES)  # 7


class DeviceTables(NamedTuple):
    """One device model's placement tables as torch constants.

    Shapes (N = flattened placements, A = padded anchor count, S = slices):
      ``placement_masks (N, S)`` / ``placement_mem (N,)`` — flattened table;
      ``profile_masks (P, A, S)`` / ``profile_anchors (P, A)`` /
      ``profile_valid (P, A)`` — per-class padded anchor views.
    """

    placement_masks: torch.Tensor
    placement_mem: torch.Tensor
    profile_masks: torch.Tensor
    profile_anchors: torch.Tensor
    profile_valid: torch.Tensor

    @property
    def num_mem_slices(self) -> int:
        return self.placement_masks.shape[1]


def _np_profile_tables(
    model: mig.DeviceModel, max_anchors: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-profile padded anchor tables of one device model.

    Returns:
      masks:   (P, A_max, S) int32 — placement window bitmask (0 where padded)
      anchors: (P, A_max)    int32 — anchor index (-1 where padded)
      valid:   (P, A_max)    bool  — anchor validity
    """
    P = mig.NUM_PROFILES
    A = max_anchors if max_anchors is not None else model.max_anchors
    masks = np.zeros((P, A, model.num_mem_slices), dtype=np.int32)
    anchors = np.full((P, A), -1, dtype=np.int32)
    valid = np.zeros((P, A), dtype=bool)
    for pid, prof in enumerate(model.profiles):
        for j, a in enumerate(prof.anchors):
            masks[pid, j, a : a + prof.mem] = 1
            anchors[pid, j] = a
            valid[pid, j] = True
    return masks, anchors, valid


@functools.lru_cache(maxsize=None)
def _tables_for(model: mig.DeviceModel, max_anchors, device: str) -> DeviceTables:
    masks, anchors, valid = _np_profile_tables(model, max_anchors)
    dev = torch.device(device)
    return DeviceTables(
        placement_masks=torch.tensor(model.placement_masks, dtype=torch.float32, device=dev),
        placement_mem=torch.tensor(model.placement_mem, dtype=torch.float32, device=dev),
        profile_masks=torch.tensor(masks, device=dev),
        profile_anchors=torch.tensor(anchors, device=dev),
        profile_valid=torch.tensor(valid, device=dev),
    )


def tables_for(
    model: mig.DeviceModel,
    max_anchors: Optional[int] = None,
    device=None,
) -> DeviceTables:
    """Build (and cache per device) the torch placement tables of a model;
    ``device=None`` means ``"cuda"``."""
    return _tables_for(model, max_anchors, str(resolve_device(device)))


def _tables(occ: torch.Tensor, tables: Optional[DeviceTables]) -> DeviceTables:
    """``tables``, defaulting to the A100-80GB tables on ``occ``'s device."""
    return tables_for(mig.A100_80GB, device=occ.device) if tables is None else tables


def frag_scores(
    occ: torch.Tensor, metric: str = "blocked", tables: Optional[DeviceTables] = None
) -> torch.Tensor:
    """F(m) for every same-model GPU.  occ: (M, S) int — returns (M,) float32.

    ``tables`` defaults to the A100-80GB tables on ``occ``'s device.
    """
    t = _tables(occ, tables)
    occf = occ.to(torch.float32)
    occ_in_window = occf @ t.placement_masks.T  # (M, N)
    size = t.placement_mem[None, :]
    if metric == "blocked":
        counted = occ_in_window > 0
    elif metric == "partial":
        counted = (occ_in_window > 0) & (occ_in_window < size)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    free = t.num_mem_slices - occf.sum(dim=1, keepdim=True)  # (M, 1)
    eligible = size <= free
    return torch.where(counted & eligible, size, 0.0).sum(dim=1)


class MFIDecision(NamedTuple):
    gpu: torch.Tensor       # int32, -1 when rejected
    anchor: torch.Tensor    # int32, -1 when rejected
    accepted: torch.Tensor  # bool
    delta_f: torch.Tensor   # float32 ΔF of the chosen placement (0 when rejected)


def _row(table: torch.Tensor, profile_id) -> torch.Tensor:
    """``table[profile_id]``; a tensor id is gathered on the device (plain
    indexing by a 0-d tensor may read it back to the host)."""
    if isinstance(profile_id, torch.Tensor):
        return table.index_select(0, profile_id.reshape(1).long())[0]
    return table[profile_id]


def _at(t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``t[k]`` of a 1-d tensor at a 0-d index tensor, on the device."""
    return t.gather(0, k.reshape(1))[0]


def placement_feasibility(
    occ: torch.Tensor, profile_id, tables: Optional[DeviceTables] = None,
    gpu_ok: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(M, A) bool — anchors of ``profile_id`` whose window is fully free.

    Columns follow ``tables.profile_anchors[profile_id]`` (ascending anchor
    order); padded anchor columns are always infeasible.  ``gpu_ok`` is an
    optional (M,) bool availability mask (False rows — e.g. failed GPUs —
    are infeasible regardless of occupancy).
    """
    t = _tables(occ, tables)
    masks = _row(t.profile_masks, profile_id)  # (A, S) int32
    valid = _row(t.profile_valid, profile_id)  # (A,)
    overlap = occ.to(torch.float32) @ masks.T.to(torch.float32)  # (M, A)
    feasible = (overlap == 0) & valid[None, :]
    if gpu_ok is not None:
        feasible = feasible & gpu_ok[:, None]
    return feasible


def placement_delta_f(
    occ: torch.Tensor,
    profile_id,
    metric: str = "blocked",
    frag_fn=None,
    tables: Optional[DeviceTables] = None,
) -> torch.Tensor:
    """(M, A) float32 — ΔF of every dry-run placement of ``profile_id``.

    ``frag_fn`` maps an (N, S) occupancy to (N,) scores; defaults to the
    plain :func:`frag_scores` (the ``fragscore`` kernel is a drop-in — see
    :mod:`repro_torch.kernels.fragscore.ops`).
    """
    t = _tables(occ, tables)
    if frag_fn is None:
        frag_fn = functools.partial(frag_scores, metric=metric, tables=t)
    masks = _row(t.profile_masks, profile_id)  # (A, S) int32
    f_before = frag_fn(occ)  # (M,)
    hypo = torch.clamp(occ[:, None, :] + masks[None, :, :], max=1)  # (M, A, S)
    f_after = frag_fn(hypo.reshape(-1, t.num_mem_slices)).reshape(occ.shape[0], -1)
    return f_after - f_before[:, None]


def mfi_select(
    occ: torch.Tensor,
    profile_id,
    metric: str = "blocked",
    tables: Optional[DeviceTables] = None,
    use_kernel: bool = False,
) -> MFIDecision:
    """Algorithm 2's argmin over all feasible (GPU, anchor) dry-runs.

    The single entry point for both lowerings: the dense torch dry run
    (default) and the ``mfi_delta`` CUDA kernel (``use_kernel=True`` —
    feasibility + ΔF in one launch on a CUDA ``occ``; its plain torch
    version on a CPU one).  Both produce the identical decision: scores are
    integer-valued, the argmin's first-occurrence tie-break is shared.  The
    reference's TPU-only ``interpret`` argument has no counterpart.

    Args:
      occ: (M, S) int32 occupancy of same-model GPUs (``tables`` selects the
        model; default A100-80GB on ``occ``'s device).
      profile_id: Python int or 0-d int tensor on ``occ``'s device.
    """
    t = _tables(occ, tables)
    anchors = _row(t.profile_anchors, profile_id)  # (A,)
    if use_kernel:
        big = MFI_BIG  # the kernel's own infeasibility sentinel
        scored = _k.mfi_delta(
            occ,
            t.placement_masks,
            t.placement_mem,
            _row(t.profile_masks, profile_id).to(torch.float32),
            _row(t.profile_valid, profile_id).to(torch.float32),
            metric=metric,
        )
    else:
        feasible = placement_feasibility(occ, profile_id, t)
        delta = placement_delta_f(occ, profile_id, metric, tables=t)
        big = 1e9
        scored = torch.where(feasible, delta, big)
    flat = scored.reshape(-1)
    k = torch.argmin(flat)  # first occurrence == (gpu, anchor) lexicographic tie-break
    best = _at(flat, k)
    accepted = best < big
    a = scored.shape[1]
    gpu = torch.where(accepted, k // a, -1).to(torch.int32)
    anchor = torch.where(accepted, _at(anchors, k % a), -1).to(torch.int32)
    return MFIDecision(gpu, anchor, accepted, torch.where(accepted, best, 0.0))


def _with_row(occ: torch.Tensor, row, fn) -> torch.Tensor:
    """A copy of ``occ`` whose row ``row`` (Python int or 0-d tensor;
    negative rows wrap, as in the reference) is ``fn(occ[row])``."""
    if isinstance(row, torch.Tensor):
        idx = row.reshape(1).long()
        return occ.index_put((idx,), fn(occ[idx][0])[None])
    out = occ.clone()
    out[row] = fn(occ[row])
    return out


def mfi_allocate(
    occ: torch.Tensor,
    profile_id,
    metric: str = "blocked",
    tables: Optional[DeviceTables] = None,
) -> Tuple[torch.Tensor, MFIDecision]:
    """Select (dense lowering) AND commit: returns ``(new_occ, decision)``;
    ``occ`` itself is not modified."""
    t = _tables(occ, tables)
    d = mfi_select(occ, profile_id, metric, t)
    aidx = first_true(_row(t.profile_anchors, profile_id) == d.anchor)
    mask = _row(_row(t.profile_masks, profile_id), aidx)
    mask = mask * d.accepted.to(mask.dtype)  # zero mask when rejected
    row = torch.where(d.accepted, d.gpu, 0)
    return _with_row(occ, row, lambda r: torch.clamp(r + mask, max=1)), d


def release(
    occ: torch.Tensor,
    gpu,
    profile_id,
    anchor,
    tables: Optional[DeviceTables] = None,
) -> torch.Tensor:
    """Free a previously committed placement: a copy of ``occ``.

    As in the reference, a rejected decision's ``(gpu, anchor) = (-1, -1)``
    is not a no-op: row -1 is the last GPU and an anchor that matches no
    column frees column 0's window.
    """
    t = _tables(occ, tables)
    aidx = first_true(_row(t.profile_anchors, profile_id) == anchor)
    mask = _row(_row(t.profile_masks, profile_id), aidx)
    return _with_row(occ, gpu, lambda r: torch.clamp(r - mask, min=0))
