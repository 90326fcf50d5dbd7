"""Per-device-model placement tables and fragmentation scoring in torch.

The paper's Algorithm 1 is a per-GPU python loop; here it is bitmask
algebra over a batch of GPUs: occupancy ``X (M, S)`` against the device
model's placement-window matrix ``Wᵀ (S, N)``, the partial-window
predicate and a weighted reduction.  Every score is integer-valued, hence
exact in float32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mig
from repro_torch.device import resolve_device


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


def frag_scores(
    occ: torch.Tensor, metric: str = "blocked", tables: Optional[DeviceTables] = None
) -> torch.Tensor:
    """F(m) for every same-model GPU.  occ: (M, S) int — returns (M,) float32.

    ``tables`` defaults to the A100-80GB tables on ``occ``'s device.
    """
    t = tables_for(mig.A100_80GB, device=occ.device) if tables is None else tables
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
