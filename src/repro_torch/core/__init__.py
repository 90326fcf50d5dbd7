"""Paper core: MIG model, fragmentation metric (Alg. 1), MFI scheduler (Alg. 2)."""

from repro_torch.core.mig import (  # noqa: F401
    A100_40GB,
    A100_80GB,
    DEVICE_MODELS,
    H100_80GB,
    H100_96GB,
    NUM_MEM_SLICES,
    NUM_PROFILES,
    NUM_SM_SLICES,
    PROFILE_BY_NAME,
    PROFILE_NAMES,
    PROFILES,
    ClusterSpec,
    ClusterState,
    DeviceModel,
    GPUState,
    MIGProfile,
)
from repro_torch.core.fragmentation import (  # noqa: F401
    cluster_fragmentation,
    delta_f,
    fragmentation_score,
    fragmentation_scores,
    spec_fragmentation_scores,
)
from repro_torch.core.policy import (  # noqa: F401
    KEY_VOCABULARY,
    PolicySpec,
    get_policy,
    list_policies,
    policy_engines,
    register_policy,
    unregister_policy,
)
from repro_torch.core.schedulers import (  # noqa: F401
    MFI,
    SCHEDULERS,
    BestFitBestIndex,
    FirstFit,
    MFIDefrag,
    RoundRobin,
    Scheduler,
    SpecScheduler,
    WorstFitBestIndex,
    compile_policy,
    make_scheduler,
    mfi_candidates,
)
