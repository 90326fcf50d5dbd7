"""Monte-Carlo online evaluation of MIG scheduling (paper §VI).

Two engines simulate the same load model:

* :mod:`repro_torch.sim.simulator` — the host reference loop (numpy), one
  replica at a time, every protocol (``steady`` | ``cumulative`` |
  ``steady-queued`` | ``steady-faulted``);
* :mod:`repro_torch.sim.batched` — the batched engine on the device: R
  replicas stepped together through a presampled event stream, every
  protocol (``steady`` | ``cumulative`` | ``steady-queued`` |
  ``steady-faulted``), the whole stream at once or through the chunked
  streaming driver (``simulate_chunked``: a staged host-to-device feed,
  the carry checkpointed by :mod:`repro_torch.checkpoint`);
  :mod:`repro_torch.sim.replay` replays its traces on the host and drives
  the host schedulers over the same streams.

Both run every registered policy (``mfi-defrag``'s migration search
included) and accept a heterogeneous ``SimConfig.cluster_spec``
(:class:`repro_torch.core.mig.ClusterSpec`) with optional per-model demand
mixes (``SimConfig.model_distributions``); the default is the paper's
homogeneous A100-80GB fleet with the fleet-wide Table-II mix.
"""

from repro_torch.sim.distributions import DISTRIBUTIONS, sample_profiles  # noqa: F401
from repro_torch.sim.simulator import (  # noqa: F401
    SimConfig,
    SimResult,
    request_probs,
    run_simulation,
    run_many,
)
from repro_torch.sim.batched import POLICIES as BATCHED_POLICIES  # noqa: F401
from repro_torch.sim.batched import (  # noqa: F401
    PROTOCOLS,
    policy_select,
    policy_select_full,
    run_batched,
)
from repro_torch.core.policy import PolicySpec, list_policies, register_policy  # noqa: F401
