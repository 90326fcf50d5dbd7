"""Algorithm 1 — the MIG fragmentation score.

Two variants are provided:

* ``"blocked"`` (default — Algorithm 1 exactly as written): a placement
  window contributes when any of its slices is occupied
  (``sum_{i in window} x_{m,i} > 0``).  Together with Table I's literal
  slice counts (7g.80gb -> 7) this reproduces the paper's *relative results*
  (MFI best on acceptance/allocated/fragmentation).
* ``"partial"``: a window contributes only when it contains at least one
  occupied AND at least one free slice — i.e. its free slices are wasted by
  co-occupancy.  This is the only reading that reproduces the paper's worked
  example arithmetic (F(GPU2)=16=2+2+8+4, F(GPU1)=8), but it empirically
  *underperforms* the blocked variant as the objective MFI minimizes.

Both variants only consider profiles that could still fit by raw free-slice
count (``mem(p) <= free_slices``) — the paper's eligibility condition
``r_w(p) <= ΔS_m`` — and weight each counted window by the profile's
memory-slice count ``r^mem``.

The port's copy of the JAX package's host scorer (numpy; a test holds the
two equal).  The batched engine's torch scorer is
:func:`repro_torch.core.cluster.frag_scores`.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from repro_torch.core import mig

METRIC_VARIANTS = ("blocked", "partial")


def _validate_metric(metric: str) -> None:
    if metric not in METRIC_VARIANTS:
        raise ValueError(f"metric must be one of {METRIC_VARIANTS}, got {metric!r}")


def fragmentation_score(
    occupancy: Union[np.ndarray, "mig.GPUState"],
    metric: str = "blocked",
    model: Optional["mig.DeviceModel"] = None,
) -> float:
    """Fragmentation score F(m) of a single GPU (Algorithm 1)."""
    if isinstance(occupancy, mig.GPUState):
        model = occupancy.model if model is None else model
        occupancy = occupancy.occupancy
    return float(
        fragmentation_scores(occupancy[None, :].astype(np.int32), metric, model)[0]
    )


def fragmentation_scores(
    occupancy: np.ndarray,
    metric: str = "blocked",
    model: Optional["mig.DeviceModel"] = None,
) -> np.ndarray:
    """Vectorized F(m) over the occupancy matrix of same-model GPUs.

    Args:
      occupancy: (M, S) 0/1 int array, S = the model's memory-slice count.
      metric: "blocked" (Algorithm-1-literal, default) or "partial" (worked-example).
      model: device model whose placement table scores the windows
        (default: the paper's A100-80GB).

    Returns:
      (M,) float64 fragmentation scores.
    """
    _validate_metric(metric)
    if model is None:
        model = mig.A100_80GB
    occ = np.asarray(occupancy, dtype=np.int32)
    if occ.ndim != 2 or occ.shape[1] != model.num_mem_slices:
        raise ValueError(
            f"occupancy must be (M, {model.num_mem_slices}), got {occ.shape}"
        )

    # occupied-slice count inside each placement window: (M, NUM_PLACEMENTS)
    occ_in_window = occ @ model.placement_masks.T
    window_size = model.placement_mem[None, :]

    if metric == "partial":
        counted = (occ_in_window > 0) & (occ_in_window < window_size)
    else:  # blocked
        counted = occ_in_window > 0

    # eligibility: profile must still fit by raw free-slice count
    free = model.num_mem_slices - occ.sum(axis=1, keepdims=True)  # (M, 1)
    eligible = window_size <= free  # (M, NUM_PLACEMENTS)

    weights = window_size.astype(np.float64)
    return ((counted & eligible) * weights).sum(axis=1)


def spec_fragmentation_scores(
    occupancy: np.ndarray,
    spec: "mig.ClusterSpec",
    metric: str = "blocked",
) -> np.ndarray:
    """F(m) per GPU of a (possibly mixed) cluster, each against its own model.

    Args:
      occupancy: (spec.num_gpus, spec.num_mem_slices) bitmap — narrower
        models read their leading columns (the rest are zero-padding).
    """
    occ = np.asarray(occupancy, dtype=np.int32)
    out = np.zeros(spec.num_gpus, dtype=np.float64)
    for model, rows in spec.model_groups():
        out[rows] = fragmentation_scores(
            occ[rows][:, : model.num_mem_slices], metric, model
        )
    return out


def cluster_fragmentation(
    occupancy: np.ndarray,
    metric: str = "blocked",
    spec: Optional["mig.ClusterSpec"] = None,
) -> float:
    """Average fragmentation score across the cluster (paper's severity metric)."""
    if spec is None:
        return float(fragmentation_scores(occupancy, metric).mean())
    return float(spec_fragmentation_scores(occupancy, spec, metric).mean())


def delta_f(
    occupancy: np.ndarray,
    profile_id: int,
    anchor: int,
    metric: str = "blocked",
    model: Optional["mig.DeviceModel"] = None,
) -> float:
    """ΔF of hypothetically placing ``profile_id``@``anchor`` on one GPU.

    Args:
      occupancy: (S,) occupancy of a single GPU; the placement must be feasible.
    """
    if model is None:
        model = mig.A100_80GB
    occ = np.asarray(occupancy, dtype=np.int32)
    prof = model.profiles[profile_id]
    if anchor not in prof.anchors:
        raise ValueError(f"anchor {anchor} illegal for {prof.name}")
    window = occ[anchor : anchor + prof.mem]
    if window.any():
        raise ValueError("infeasible dry-run placement")
    before = fragmentation_score(occ, metric, model)
    hypo = occ.copy()
    hypo[anchor : anchor + prof.mem] = 1
    after = fragmentation_score(hypo, metric, model)
    return after - before
