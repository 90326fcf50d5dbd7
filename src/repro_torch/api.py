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

#: where the batched-engine knobs the port lacks stand in ROADMAP.md
_NOT_PORTED = "ROADMAP.md §1 item 10, chunked streaming and checkpoints"


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
        :func:`repro_torch.sim.run_many`, every protocol) or ``"batched"``
        (:func:`repro_torch.sim.batched.run_batched`: the ``steady``,
        ``cumulative`` and ``steady-queued`` protocols, taken from
        ``cfg.protocol``; ``steady-faulted`` raises
        ``NotImplementedError`` there, ROADMAP.md §1 item 9).
      runs: replicas to average (the paper uses 500).
      use_kernel: batched engine only — route the stages through the CUDA
        kernels (default: on a CUDA device, unless the spec opts out).
      chunk_size, stream: the reference's chunked-streaming knobs of the
        batched engine; not ported (``NotImplementedError`` on either
        engine).
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
    if chunk_size is not None or stream is not None:
        raise NotImplementedError(
            f"chunk_size/stream are not ported to repro_torch yet ({_NOT_PORTED})"
        )
    if engine == "batched":
        return run_batched(spec, cfg, runs=runs, use_kernel=use_kernel, device=device)
    if device is not None:
        raise ValueError("device is a batched-engine knob; pass engine='batched'")
    return run_many(spec, cfg, runs=runs)
