"""Public policy-and-simulation facade.

One import surface for the declarative policy layer:

    from repro_torch import api

    # run a registered policy through either engine
    api.simulate("mfi", engine="python", runs=8, num_gpus=50)
    api.simulate("mfi", engine="batched", runs=64, num_gpus=50)  # on the card

    # define + register a custom policy once, run it everywhere
    spec = api.PolicySpec(
        name="pack-new-gen",
        keys=("model-group", "free-slices", "gpu", "-anchor"),
        description="prefer newest device model, then pack tightly",
    )
    api.register_policy(spec)
    api.simulate("pack-new-gen", engine="batched", runs=64, device="cpu")
    sched = api.make_policy("pack-new-gen")   # host Scheduler object

Every entry point validates through the registry's single path
(:func:`repro_torch.core.policy.resolve`), so unknown policies and
policy/engine mismatches raise the same helpful error everywhere.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.mig import FaultModel  # noqa: F401  (re-exported API)
from repro_torch.core.policy import (  # noqa: F401  (re-exported API)
    ENGINES,
    KEY_VOCABULARY,
    PolicyLike,
    PolicySpec,
    get_policy,
    list_policies,
    policy_engines,
    register_policy,
    resolve,
    unregister_policy,
)
from repro_torch.core.schedulers import Scheduler, compile_policy, make_scheduler

def make_policy(policy: PolicyLike, metric: str = "blocked") -> Scheduler:
    """Compile a registered policy name (or ad-hoc spec) for the host
    engine — alias of :func:`repro_torch.core.schedulers.make_scheduler`."""
    return make_scheduler(policy, metric=metric)


def simulate(
    policy: PolicyLike = "mfi",
    cfg=None,
    *,
    engine: str = "python",
    runs: int = 100,
    use_kernel: Optional[bool] = None,
    chunk_size: Optional[int] = None,
    stream: Optional[bool] = None,
    device=None,
    **cfg_kwargs,
) -> Dict[str, float]:
    """Monte-Carlo evaluate one policy on one configuration point.

    Args:
      policy: registered policy name or an ad-hoc :class:`PolicySpec`.
      cfg: a :class:`repro_torch.sim.SimConfig`; built from ``cfg_kwargs``
        (``num_gpus``, ``offered_load``, ``distribution``,
        ``cluster_spec``, ...) when omitted.
      engine: ``"python"`` (the host reference loop,
        :func:`repro_torch.sim.run_many`) or ``"batched"``
        (:func:`repro_torch.sim.batched.run_batched`); both run every
        protocol (``steady`` | ``cumulative`` | ``steady-queued`` |
        ``steady-faulted``, taken from ``cfg.protocol``; the faulted one
        needs ``cfg.fault_model``).
      runs: replicas to average (the paper uses 500).  The batched engine
        splits the replicas across the visible cards when more than one is
        visible and ``runs`` divides evenly (see
        :func:`repro_torch.sim.batched.shard_events`).
      use_kernel: batched engine only — route the stages through the CUDA
        kernels (default: on a CUDA device, unless the spec opts out).
      chunk_size: batched engine only — run the events through the chunked
        streaming driver (:func:`repro_torch.sim.batched.simulate_chunked`):
        the device holds one replica carry plus two staged chunks of the
        stream instead of the whole stream, with the same results for any
        chunk size.  ``None`` (default) runs the whole stream at once.
      stream: chunked runs only — ``True`` (default) copies each chunk's
        trace back to the host as it completes; ``False`` keeps the trace
        on the device.
      device: batched engine only — ``None`` means the card; pass
        ``"cpu"`` for the plain torch versions.

    Returns the same aggregate dict as :func:`repro_torch.sim.run_many` /
    :func:`repro_torch.sim.batched.run_batched`.
    """
    from repro_torch.sim.batched import run_batched
    from repro_torch.sim.simulator import SimConfig, run_many

    spec = resolve(policy, engine=engine)  # one validation path
    if cfg is None:
        cfg = SimConfig(**cfg_kwargs)
    elif cfg_kwargs:
        raise ValueError("pass either cfg or SimConfig kwargs, not both")
    if chunk_size is not None and chunk_size <= 0:
        raise ValueError(
            f"chunk_size must be a positive event count (or None for the "
            f"monolithic scan), got {chunk_size}"
        )
    if engine == "batched":
        return run_batched(spec, cfg, runs=runs, use_kernel=use_kernel, device=device,
                           chunk_size=chunk_size, stream=stream)
    if chunk_size is not None or stream is not None:
        raise ValueError(
            "chunk_size/stream are batched-engine knobs; pass engine='batched'"
        )
    if device is not None:
        raise ValueError("device is a batched-engine knob; pass engine='batched'")
    return run_many(spec, cfg, runs=runs)
