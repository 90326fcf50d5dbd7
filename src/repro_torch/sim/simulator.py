"""Simulation configuration and the steady-protocol load model (paper §VI).

The ``"steady"`` protocol reads the paper's "GPU demand" axis as the
**offered load**: the steady-state concurrent slice demand as a fraction of
cluster capacity.  Workloads arrive as a Poisson process with rate
``λ_f = f·capacity / (E[duration]·E[mem])`` per slot, durations are sampled
``U[1, T]`` slots (``T = capacity/E[mem]``, the paper's saturation horizon),
the simulation warms up for ``3T`` slots and measures over ``2T`` slots.

:class:`SimConfig` carries every field of the reference configuration, so
one configuration drives both packages; the port's engine
(:mod:`repro_torch.sim.batched`) runs the steady protocol.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import mig
from repro_torch.sim import distributions


@dataclasses.dataclass
class SimConfig:
    num_gpus: int = 100
    distribution: str = "uniform"
    protocol: str = "steady"  # "steady" | "cumulative" | "steady-queued" | "steady-faulted"
    metric: str = "blocked"   # fragmentation variant (MFI scoring + severity metric)
    seed: int = 0
    # heterogeneous fleets: a ClusterSpec overrides num_gpus (the paper's
    # homogeneous A100-80GB setup is the default one-model spec)
    cluster_spec: Optional[mig.ClusterSpec] = None
    # optional per-device-model demand-class mix (model name -> Table-II
    # distribution name); models not listed keep ``distribution``.  The
    # effective fleet-wide mix is the capacity-weighted mixture — see
    # :func:`repro_torch.sim.distributions.resolve_probs`.
    model_distributions: Optional[Dict[str, str]] = None
    # steady protocol:
    offered_load: float = 0.85  # fraction of slice capacity offered concurrently
    warmup_horizons: int = 3    # warmup = this * T slots
    measure_horizons: int = 2   # measurement window = this * T slots
    # cumulative protocol:
    max_demand: float = 1.0
    demand_grid: Sequence[float] = tuple(np.round(np.arange(0.05, 1.001, 0.05), 3))
    # steady-queued protocol (multi-tenant waiting queue):
    num_tenants: int = 4       # tenant ids sampled uniformly per arrival
    num_priorities: int = 2    # priority classes (0 = most urgent)
    wait_capacity: int = 8     # waiting-queue slots per cluster
    wait_patience: int = 16    # max slots a request may wait before final reject
    # steady-faulted protocol: GPU failure/recovery process (required there,
    # ignored elsewhere)
    fault_model: Optional[mig.FaultModel] = None

    def __post_init__(self):
        if self.cluster_spec is not None:
            self.num_gpus = self.cluster_spec.num_gpus
        if self.wait_patience < 0:
            raise ValueError(
                f"wait_patience must be >= 0 (slots a request may wait), "
                f"got {self.wait_patience}"
            )
        if self.wait_capacity < 0:
            raise ValueError(
                f"wait_capacity must be >= 0 (queue slots), got {self.wait_capacity}"
            )
        if self.num_priorities < 1:
            raise ValueError(
                f"num_priorities must be >= 1 (priority classes are sampled "
                f"from [0, num_priorities)), got {self.num_priorities}"
            )
        if self.num_tenants < 1:
            raise ValueError(
                f"num_tenants must be >= 1, got {self.num_tenants}"
            )

    def spec(self) -> mig.ClusterSpec:
        """The cluster spec (defaulting to the paper's homogeneous fleet)."""
        if self.cluster_spec is not None:
            return self.cluster_spec
        return mig.ClusterSpec.homogeneous(mig.A100_80GB, self.num_gpus)


def request_probs(cfg: SimConfig) -> np.ndarray:
    """Effective demand-class probabilities of a configuration.

    The named Table-II mix by default; the capacity-weighted per-model
    mixture when ``cfg.model_distributions`` is set.
    """
    return distributions.resolve_probs(
        cfg.distribution, cfg.spec(), cfg.model_distributions
    )


#: slots between metric samples in the steady measurement window
SAMPLE_EVERY = 10


def steady_params(cfg: SimConfig) -> Tuple[int, int, int, float]:
    """Steady-protocol parameters: ``(T, warm, meas, rate)``.

    Capacity is the spec's total slice count; the per-request slice demand
    is normalized by the *canonical* (A100-80GB) class sizes, so offered
    load keeps the paper's meaning on the homogeneous fleet and stays a
    consistent, model-independent knob on mixed fleets.
    """
    cap = cfg.spec().total_mem_slices
    mean_mem = distributions.mean_mem_from_probs(request_probs(cfg))
    T = int(np.ceil(cap / mean_mem))
    mean_dur = (1 + T) / 2
    rate = cfg.offered_load * cap / (mean_dur * mean_mem)
    return T, cfg.warmup_horizons * T, cfg.measure_horizons * T, rate


def jain_fairness(values) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` of per-tenant rates.

    1.0 = perfectly even; 1/n = maximally skewed.  Empty or all-zero
    inputs (no tenant saw any demand / no tenant was served) return 1.0 —
    nothing was distributed unevenly.
    """
    x = np.asarray(list(values), dtype=np.float64)
    if x.size == 0:
        return 1.0
    sq = float(np.square(x).sum())
    if sq == 0.0:
        return 1.0
    s = float(x.sum())
    return s * s / (x.size * sq)
