"""Work counts of the program's CUDA kernels, one file per kernel, and the
roofline reading they share.

Each ``kernels/<kernel>.py`` gives the kernel's symbol as the profiler
names it (``NAME``), the work of one launch from its shapes (``work``:
float32 operations and bytes, each input read once and each output
written once) and the launches one engine event makes by the engine's
stages (``per_event``).  The counts are of the job's work at the cell's
shapes, so a later kernel doing the same job is read against the same
work.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

#: keys a candidate compares: MFI's least (ΔF, gpu, anchor), with or
#: without the migration search
KEYS = 3

PEAKS = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())


def bound_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(flops / peak["fp32_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])


def roofline(kernel, ctx: dict) -> Optional[float]:
    """The kernel's share of its roofline over the traced window, in %:
    the sum of its launches' bounds over the sum of their device times.
    ``None`` where the card has no entry in ``peaks.json``, the kernel did
    not run, or its launches do not follow ``per_event`` (the engine's
    stages changed: the counts would not describe the launches)."""
    peak = PEAKS.get(ctx["device_kind"])
    shapes = kernel.per_event(ctx["geometry"])
    times = [dur for name, _, dur in ctx["kernels"] if kernel.NAME in name]
    if peak is None or not shapes or not times:
        return None
    if len(times) != len(shapes) * ctx["events"]:
        return None
    bound = ctx["events"] * sum(bound_s(*kernel.work(**s), peak) for s in shapes)
    return 100.0 * bound / sum(times)
