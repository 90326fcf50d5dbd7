"""MIG-profile request distributions (paper Table II).

Beyond the paper's fleet-wide mixes, a heterogeneous fleet may carry a
**per-device-model demand-class mix** (``SimConfig.model_distributions``):
each model group contributes arrivals in proportion to its slice-capacity
share, with its own Table-II mix — e.g. H100s attracting the big classes
while A100-40s see small ones.  The effective fleet-wide distribution is
the capacity-weighted mixture (:func:`resolve_probs`); requests remain
schedulable anywhere (the mix is a demand model, not a routing rule), so
both engines consume the same probabilities and stay same-stream
comparable.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.core import mig

# Probability per profile, ordered as mig.PROFILE_NAMES =
# (7g.80gb, 4g.40gb, 3g.40gb, 2g.20gb, 1g.20gb, 1g.10gb)
DISTRIBUTIONS: Dict[str, np.ndarray] = {
    "uniform": np.array([1 / 6] * 6),
    "skew-small": np.array([0.05, 0.10, 0.10, 0.20, 0.25, 0.30]),
    "skew-big": np.array([0.30, 0.25, 0.20, 0.10, 0.10, 0.05]),
    "bimodal": np.array([0.30, 0.15, 0.05, 0.05, 0.15, 0.30]),
}

for _name, _p in DISTRIBUTIONS.items():
    assert abs(_p.sum() - 1.0) < 1e-9, _name


def _named(name: str) -> np.ndarray:
    try:
        return DISTRIBUTIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown distribution {name!r}; options {sorted(DISTRIBUTIONS)}"
        )


def sample_profiles(name: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """Sample ``n`` profile ids from the named distribution."""
    return rng.choice(mig.NUM_PROFILES, size=n, p=_named(name))


def sample_profile_probs(
    probs: np.ndarray, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Sample ``n`` profile ids from an explicit probability vector.

    Identical RNG consumption to :func:`sample_profiles` for the same
    probabilities — callers switching between named and resolved mixes
    stay same-stream.
    """
    return rng.choice(mig.NUM_PROFILES, size=n, p=probs)


def resolve_probs(
    name: str,
    spec: Optional["mig.ClusterSpec"] = None,
    model_distributions: Optional[Mapping[str, str]] = None,
) -> np.ndarray:
    """Effective fleet-wide demand-class probabilities.

    Without ``model_distributions`` this is exactly the named Table-II mix
    (the same array object — RNG streams are unchanged).  With it, each
    model group of ``spec`` contributes in proportion to its slice-capacity
    share, drawing from its own named mix (models not listed keep the
    fleet-wide default ``name``).  Keys may be canonical model names
    (``"a100-80gb"``) or registry aliases (``"a100-80"``).
    """
    if not model_distributions:
        return _named(name)
    if spec is None:
        raise ValueError("model_distributions needs a ClusterSpec")
    by_model: Dict[str, str] = {}
    for key, dist in model_distributions.items():
        if key in mig.DEVICE_MODELS:
            by_model[mig.DEVICE_MODELS[key].name] = dist
        else:
            raise ValueError(
                f"unknown device model {key!r} in model_distributions; "
                f"options {sorted(set(mig.DEVICE_MODELS))}"
            )
        _named(dist)  # validate the distribution name early
    fleet_models = {m.name for m in spec.models}
    unknown = set(by_model) - fleet_models
    if unknown:
        raise ValueError(
            f"model_distributions names models not in the fleet: "
            f"{sorted(unknown)} (fleet: {sorted(fleet_models)})"
        )
    total = float(spec.total_mem_slices)
    probs = np.zeros(mig.NUM_PROFILES, dtype=np.float64)
    for model, rows in spec.model_groups():
        weight = len(rows) * model.num_mem_slices / total
        probs += weight * _named(by_model.get(model.name, name))
    return probs / probs.sum()  # guard float drift; weights already sum to 1


def mean_mem_from_probs(probs: np.ndarray) -> float:
    """Expected memory-slice demand per request under the probabilities."""
    return float(np.asarray(probs) @ mig.PROFILE_MEM)


def mean_mem_demand(name: str) -> float:
    """Expected memory-slice demand per request under the distribution."""
    return mean_mem_from_probs(_named(name))
