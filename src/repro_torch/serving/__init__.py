"""Multi-tenant GPU-as-a-Service serving: MFI admission + batched decode."""

from repro_torch.serving.admission import AdmissionController  # noqa: F401
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
