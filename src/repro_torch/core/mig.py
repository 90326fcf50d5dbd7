"""MIG hardware model: profiles, device models, cluster specs, GPU and cluster state.

Requests arrive as one of the paper's six Table-I demand classes (named
after their A100-80GB realization, e.g. ``2g.20gb`` = 2 SM slices + 20 GiB).
A :class:`DeviceModel` describes how each class is realized on one GPU
generation: its own placement table (legal anchor windows per class), its
slice-memory size, and possibly *no* realization at all (an 80 GiB demand
cannot fit an A100-40GB).  Placement legality follows NVIDIA's
placement-index tables: a profile anchored at memory slice ``i`` occupies
the contiguous memory-slice window ``[i, i + mem - 1]``.

A :class:`ClusterSpec` is an ordered list of ``(model, count)`` pairs; the
paper's homogeneous A100 fleet is the trivial one-model spec and is the
default everywhere.

Pure python/numpy: :class:`GPUState` and :class:`ClusterState` are the
host control plane (the serving admission controller and the host
schedulers of :mod:`repro_torch.core.schedulers` run on them); the torch
tables built from the descriptors live in :mod:`repro_torch.core.cluster`
and :mod:`repro_torch.sim.batched`.
"""


from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

NUM_MEM_SLICES = 8
NUM_SM_SLICES = 7


@dataclasses.dataclass(frozen=True)
class MIGProfile:
    """A MIG profile (e.g. ``2g.20gb``): compute + memory slice demand.

    ``anchors`` may be empty: the demand class has no realization on the
    device model carrying this entry (e.g. 80 GiB on an A100-40GB) and is
    rejected there by construction.
    """

    name: str
    compute: int  # SM slices (utilization accounting)
    mem: int      # memory slices (occupancy unit)
    anchors: Tuple[int, ...]  # legal placement start indexes (Table I)

    @property
    def num_placements(self) -> int:
        return len(self.anchors)


# Paper Table I (A100-80GB).  7g.80gb has slice count 7 exactly as the paper
# prints: its window is {0..6}; memory slice 7 is unreachable by any other
# profile once 7g is placed (no legal anchor covers it), so mem=7 is
# behaviourally equivalent for allocation while keeping 7g *eligible* in the
# fragmentation score of a GPU with exactly one occupied slice -- this is the
# empty-GPU defence term (see DESIGN.md §1.2 and EXPERIMENTS.md).
PROFILES: Tuple[MIGProfile, ...] = (
    MIGProfile("7g.80gb", compute=7, mem=7, anchors=(0,)),
    MIGProfile("4g.40gb", compute=4, mem=4, anchors=(0,)),
    MIGProfile("3g.40gb", compute=3, mem=4, anchors=(0, 4)),
    MIGProfile("2g.20gb", compute=2, mem=2, anchors=(0, 2, 4)),
    MIGProfile("1g.20gb", compute=1, mem=2, anchors=(0, 2, 4, 6)),
    MIGProfile("1g.10gb", compute=1, mem=1, anchors=(0, 1, 2, 3, 4, 5, 6)),
)

PROFILE_BY_NAME: Dict[str, MIGProfile] = {p.name: p for p in PROFILES}
PROFILE_NAMES: Tuple[str, ...] = tuple(p.name for p in PROFILES)
NUM_PROFILES = len(PROFILES)

# ---------------------------------------------------------------------------
# Device models: per-generation placement tables for the same demand classes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """One GPU generation/SKU: how each demand class lands on its slices.

    ``profiles[pid]`` is the local realization of canonical demand class
    ``pid`` (indexed exactly like :data:`PROFILES`); an entry with empty
    ``anchors`` means the class cannot be placed on this model.  The derived
    flattened placement table (every legal (class, anchor) pair is one row)
    is cached per instance; instances are frozen/hashable so they double as
    cache keys.
    """

    name: str
    slice_gib: int  # memory per slice (GiB) — documentation/capacity planning
    profiles: Tuple[MIGProfile, ...]
    num_mem_slices: int = NUM_MEM_SLICES
    num_sm_slices: int = NUM_SM_SLICES

    def __post_init__(self):
        if len(self.profiles) != len(PROFILES):
            raise ValueError(
                f"{self.name}: need one realization per demand class "
                f"({len(PROFILES)}), got {len(self.profiles)}"
            )
        for p in self.profiles:
            for a in p.anchors:
                if a + p.mem > self.num_mem_slices:
                    raise ValueError(f"{self.name}/{p.name}@{a} out of bounds")

    # -- flattened placement table (one row per legal (class, anchor)) ------
    @functools.cached_property
    def _placements(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rows = []
        for pid, prof in enumerate(self.profiles):
            for anchor in prof.anchors:
                mask = np.zeros(self.num_mem_slices, dtype=np.int32)
                mask[anchor : anchor + prof.mem] = 1
                rows.append((pid, anchor, mask))
        pids = np.array([r[0] for r in rows], dtype=np.int32)
        anchors = np.array([r[1] for r in rows], dtype=np.int32)
        masks = (
            np.stack([r[2] for r in rows])
            if rows
            else np.zeros((0, self.num_mem_slices), dtype=np.int32)
        )
        return pids, anchors, masks

    @property
    def placement_profile_id(self) -> np.ndarray:
        return self._placements[0]

    @property
    def placement_anchor(self) -> np.ndarray:
        return self._placements[1]

    @property
    def placement_masks(self) -> np.ndarray:
        return self._placements[2]

    @functools.cached_property
    def placement_mem(self) -> np.ndarray:
        return np.array(
            [self.profiles[pid].mem for pid in self.placement_profile_id],
            dtype=np.int32,
        )

    @property
    def num_placements(self) -> int:
        return self.placement_masks.shape[0]

    @functools.cached_property
    def max_anchors(self) -> int:
        return max(1, max(p.num_placements for p in self.profiles))

    @functools.cached_property
    def profile_mem(self) -> np.ndarray:
        return np.array([p.mem for p in self.profiles], dtype=np.int32)

    @functools.cached_property
    def profile_compute(self) -> np.ndarray:
        return np.array([p.compute for p in self.profiles], dtype=np.int32)

    @functools.cached_property
    def _profile_placement_slices(self) -> Tuple[slice, ...]:
        out, off = [], 0
        for p in self.profiles:
            out.append(slice(off, off + p.num_placements))
            off += p.num_placements
        return tuple(out)

    def profile_placement_rows(self, pid: int) -> slice:
        """Rows of this model's placement table belonging to class ``pid``."""
        return self._profile_placement_slices[pid]

    def placeable(self, pid: int) -> bool:
        return bool(self.profiles[pid].anchors)


#: The paper's device (canonical classes ARE their realizations).
A100_80GB = DeviceModel(name="a100-80gb", slice_gib=10, profiles=PROFILES)

#: A100-40GB: 8 × 5 GiB slices.  The same demand classes need twice the
#: slices (NVIDIA table: 1g.5gb / 2g.10gb / 3g.20gb / 4g.20gb / 7g.40gb),
#: so 20 GiB demands occupy a half-GPU window, 40 GiB demands the full GPU,
#: and the 80 GiB class has no realization at all.
A100_40GB = DeviceModel(
    name="a100-40gb",
    slice_gib=5,
    profiles=(
        MIGProfile("n/a.80gb", compute=7, mem=7, anchors=()),   # cannot fit
        MIGProfile("7g.40gb", compute=7, mem=7, anchors=(0,)),
        MIGProfile("7g.40gb", compute=7, mem=7, anchors=(0,)),
        MIGProfile("3g.20gb", compute=3, mem=4, anchors=(0, 4)),
        MIGProfile("3g.20gb", compute=3, mem=4, anchors=(0, 4)),
        MIGProfile("2g.10gb", compute=2, mem=2, anchors=(0, 2, 4)),
    ),
)

#: H100-96GB: 8 × 12 GiB slices — A100 placement geometry, roomier slices.
H100_96GB = DeviceModel(
    name="h100-96gb",
    slice_gib=12,
    profiles=(
        MIGProfile("7g.96gb", compute=7, mem=7, anchors=(0,)),
        MIGProfile("4g.48gb", compute=4, mem=4, anchors=(0,)),
        MIGProfile("3g.48gb", compute=3, mem=4, anchors=(0, 4)),
        MIGProfile("2g.24gb", compute=2, mem=2, anchors=(0, 2, 4)),
        MIGProfile("1g.24gb", compute=1, mem=2, anchors=(0, 2, 4, 6)),
        MIGProfile("1g.12gb", compute=1, mem=1, anchors=(0, 1, 2, 3, 4, 5, 6)),
    ),
)

#: H100-80GB: 8 × 10 GiB slices.  NVIDIA's H100-80GB placement-index table
#: matches the A100-80GB one for the six canonical demand classes, so the
#: canonical classes are their own realizations — same geometry as the
#: paper's device, distinct SKU (cost/power-aware policies can tell them
#: apart via the ``model-group`` scoring key).
H100_80GB = DeviceModel(name="h100-80gb", slice_gib=10, profiles=PROFILES)

#: H200-141GB (stylized): **12** × 12 GiB memory slices (144 ≈ the 141 GiB
#: marketing capacity) — the only non-8-slice geometry in the registry, so
#: mixed fleets carrying it exercise the padded-width paths everywhere
#: (occupancy bitmaps, stacked `SpecTables`, per-model fragmentation).
#: Placement windows follow the NVIDIA power-of-two alignment style on the
#: wider grid: full-GPU-minus-trailing for 7g, quarter-aligned for 4g/3g,
#: even anchors for the 2-slice classes, every slice for 1g.
H200_141GB = DeviceModel(
    name="h200-141gb",
    slice_gib=12,
    num_mem_slices=12,
    profiles=(
        MIGProfile("7g.84gb", compute=7, mem=7, anchors=(0,)),
        MIGProfile("4g.48gb", compute=4, mem=4, anchors=(0, 4, 8)),
        MIGProfile("3g.48gb", compute=3, mem=4, anchors=(0, 4, 8)),
        MIGProfile("2g.24gb", compute=2, mem=2, anchors=(0, 2, 4, 6, 8, 10)),
        MIGProfile("1g.24gb", compute=1, mem=2, anchors=(0, 2, 4, 6, 8, 10)),
        MIGProfile("1g.12gb", compute=1, mem=1, anchors=tuple(range(12))),
    ),
)

DEVICE_MODELS: Dict[str, DeviceModel] = {
    "a100-80": A100_80GB,
    "a100-80gb": A100_80GB,
    "a100-40": A100_40GB,
    "a100-40gb": A100_40GB,
    "h100-96": H100_96GB,
    "h100-96gb": H100_96GB,
    "h100-80": H100_80GB,
    "h100-80gb": H100_80GB,
    "h200-141": H200_141GB,
    "h200-141gb": H200_141GB,
}


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """An ordered mixed fleet: ``((model, count), ...)``.

    GPU ids are assigned contiguously in entry order; the paper's setup is
    the one-model spec ``ClusterSpec.homogeneous(A100_80GB, M)``.
    """

    entries: Tuple[Tuple[DeviceModel, int], ...]

    def __post_init__(self):
        if not self.entries:
            raise ValueError("ClusterSpec needs at least one (model, count)")
        for model, count in self.entries:
            if count <= 0:
                raise ValueError(f"{model.name}: count must be positive")

    @classmethod
    def homogeneous(cls, model: DeviceModel, num_gpus: int) -> "ClusterSpec":
        return cls(entries=((model, num_gpus),))

    @classmethod
    def parse(cls, text: str) -> "ClusterSpec":
        """``"a100-80:50,a100-40:50"`` -> ClusterSpec (see DEVICE_MODELS)."""
        entries = []
        for part in text.split(","):
            name, _, count = part.strip().partition(":")
            if name not in DEVICE_MODELS:
                raise ValueError(
                    f"unknown device model {name!r}; options "
                    f"{sorted(set(DEVICE_MODELS))}"
                )
            entries.append((DEVICE_MODELS[name], int(count) if count else 1))
        return cls(entries=tuple(entries))

    @functools.cached_property
    def num_gpus(self) -> int:
        return sum(count for _, count in self.entries)

    @functools.cached_property
    def models(self) -> Tuple[DeviceModel, ...]:
        """Distinct models in first-appearance order."""
        seen: List[DeviceModel] = []
        for model, _ in self.entries:
            if model not in seen:
                seen.append(model)
        return tuple(seen)

    @functools.cached_property
    def model_index(self) -> np.ndarray:
        """(num_gpus,) int32 — index into :attr:`models` per GPU."""
        idx = {m: k for k, m in enumerate(self.models)}
        return np.concatenate(
            [np.full(count, idx[model], np.int32) for model, count in self.entries]
        )

    def model_of(self, gpu_id: int) -> DeviceModel:
        return self.models[self.model_index[gpu_id]]

    @property
    def is_homogeneous(self) -> bool:
        return len(self.models) == 1

    @functools.cached_property
    def num_mem_slices(self) -> int:
        """Common occupancy-bitmap width (max slice count over models)."""
        return max(m.num_mem_slices for m in self.models)

    @functools.cached_property
    def total_mem_slices(self) -> int:
        return sum(m.num_mem_slices * count for m, count in self.entries)

    def model_groups(self) -> List[Tuple[DeviceModel, np.ndarray]]:
        """Per distinct model: (model, int array of its GPU ids)."""
        return [
            (m, np.flatnonzero(self.model_index == k))
            for k, m in enumerate(self.models)
        ]


# ---------------------------------------------------------------------------
# Fault model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Exponential GPU failure/recovery process in slot-time units.

    Each GPU alternates up/down phases: up-phase lengths are drawn from
    ``Exp(mtbf)`` and down-phases from ``Exp(mttr)``, with per-
    :class:`DeviceModel` overrides keyed by model name.  The descriptor is
    frozen/hashable so it can ride in static configuration, and all
    draws happen at presample time *after* the arrival/tenant draws — a
    disabled fault model therefore leaves every existing event stream
    byte-identical.

    ``max_retries``/``backoff_base`` govern what happens to evicted (and
    patience-overdue) workloads: attempt ``k`` waits ``backoff_base *
    2**(k-1)`` slots before becoming eligible again, and a workload is
    finally rejected only after ``max_retries`` re-queues (or when its
    lease expires in the queue).
    """

    mtbf: float = 500.0
    mttr: float = 20.0
    per_model: Tuple[Tuple[str, Tuple[float, float]], ...] = ()
    max_retries: int = 2
    backoff_base: int = 2

    def __post_init__(self):
        for label, mtbf, mttr in (("", self.mtbf, self.mttr),) + tuple(
            (f" for model {name!r}", pair[0], pair[1]) for name, pair in self.per_model
        ):
            if not (math.isfinite(mtbf) and mtbf > 0):
                raise ValueError(
                    f"FaultModel MTBF{label} must be a positive finite number "
                    f"of slots, got {mtbf!r}"
                )
            if not (math.isfinite(mttr) and mttr > 0):
                raise ValueError(
                    f"FaultModel MTTR{label} must be a positive finite number "
                    f"of slots, got {mttr!r}"
                )
        if self.max_retries < 0:
            raise ValueError(
                f"FaultModel max_retries must be >= 0, got {self.max_retries}"
            )
        if self.backoff_base < 1:
            raise ValueError(
                f"FaultModel backoff_base must be >= 1, got {self.backoff_base}"
            )

    def rates_for(self, model_name: str) -> Tuple[float, float]:
        """(mtbf, mttr) for a device model, honouring per-model overrides."""
        for name, pair in self.per_model:
            if name == model_name:
                return (float(pair[0]), float(pair[1]))
        return (self.mtbf, self.mttr)

    def backoff(self, attempt: int) -> int:
        """Slots to wait before re-queue attempt ``attempt`` (1-based)."""
        return self.backoff_base * 2 ** max(0, attempt - 1)


#: canonical (A100-80GB) slice demand per class — the offered-load unit
PROFILE_MEM = A100_80GB.profile_mem


def profile_placement_rows(pid: int) -> slice:
    """Rows of the A100-80GB placement table belonging to profile ``pid``."""
    return A100_80GB.profile_placement_rows(pid)


# ---------------------------------------------------------------------------
# GPU state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Allocation:
    """A committed placement of a workload on a GPU."""

    workload_id: int
    profile_id: int
    anchor: int


class GPUState:
    """Occupancy state of one MIG-capable GPU of a given device model."""

    def __init__(self, gpu_id: int = 0, model: DeviceModel = A100_80GB):
        self.gpu_id = gpu_id
        self.model = model
        self.up = True  # a down GPU accepts no placements until recovered
        self.occupancy = np.zeros(model.num_mem_slices, dtype=np.int32)
        self.allocations: Dict[int, Allocation] = {}

    # -- queries ------------------------------------------------------------
    @property
    def free_slices(self) -> int:
        return int(self.model.num_mem_slices - self.occupancy.sum())

    @property
    def used_mem_slices(self) -> int:
        return int(self.occupancy.sum())

    @property
    def used_compute_slices(self) -> int:
        return int(
            sum(
                self.model.profiles[a.profile_id].compute
                for a in self.allocations.values()
            )
        )

    @property
    def is_active(self) -> bool:
        return bool(self.allocations)

    def feasible_anchors(self, profile_id: int) -> List[int]:
        """Anchors where ``profile_id`` can be placed right now."""
        if not self.up:
            return []  # single choke point: down GPUs are infeasible everywhere
        prof = self.model.profiles[profile_id]
        out = []
        for anchor in prof.anchors:
            if not self.occupancy[anchor : anchor + prof.mem].any():
                out.append(anchor)
        return out

    def can_fit(self, profile_id: int) -> bool:
        return bool(self.feasible_anchors(profile_id))

    # -- mutation -----------------------------------------------------------
    def allocate(self, workload_id: int, profile_id: int, anchor: int) -> None:
        prof = self.model.profiles[profile_id]
        window = self.occupancy[anchor : anchor + prof.mem]
        if anchor not in prof.anchors:
            raise ValueError(
                f"anchor {anchor} illegal for profile {prof.name} "
                f"on {self.model.name} (legal: {prof.anchors})"
            )
        if window.any():
            raise ValueError(
                f"profile {prof.name}@{anchor} overlaps occupied slices on "
                f"GPU {self.gpu_id}"
            )
        window[:] = 1
        self.allocations[workload_id] = Allocation(workload_id, profile_id, anchor)

    def release(self, workload_id: int) -> None:
        alloc = self.allocations.pop(workload_id)
        prof = self.model.profiles[alloc.profile_id]
        self.occupancy[alloc.anchor : alloc.anchor + prof.mem] = 0


class ClusterState:
    """A MIG GPU cluster — homogeneous by default, mixed via ``spec``."""

    def __init__(self, num_gpus: Optional[int] = None, spec: Optional[ClusterSpec] = None):
        if spec is None:
            if num_gpus is None:
                raise ValueError("need num_gpus or spec")
            spec = ClusterSpec.homogeneous(A100_80GB, num_gpus)
        elif num_gpus is not None and num_gpus != spec.num_gpus:
            raise ValueError(
                f"num_gpus={num_gpus} contradicts spec ({spec.num_gpus} GPUs)"
            )
        self.spec = spec
        self.gpus = [
            GPUState(i, spec.model_of(i)) for i in range(spec.num_gpus)
        ]
        self._placement_of: Dict[int, int] = {}  # workload_id -> gpu_id

    def __len__(self) -> int:
        return len(self.gpus)

    @property
    def num_gpus(self) -> int:
        return len(self.gpus)

    def occupancy_matrix(self) -> np.ndarray:
        """(M, S) int32 occupancy bitmap, S = ``spec.num_mem_slices``.

        GPUs of models with fewer slices are zero-padded on the right (their
        extra columns can never be occupied).
        """
        s = self.spec.num_mem_slices
        out = np.zeros((self.num_gpus, s), dtype=np.int32)
        for i, g in enumerate(self.gpus):
            out[i, : g.occupancy.shape[0]] = g.occupancy
        return out

    def allocate(self, workload_id: int, profile_id: int, gpu_id: int, anchor: int):
        if workload_id in self._placement_of:
            raise ValueError(
                f"workload {workload_id} is already placed on GPU "
                f"{self._placement_of[workload_id]}; release it before "
                "re-allocating (a duplicate allocate would orphan its slices)"
            )
        self.gpus[gpu_id].allocate(workload_id, profile_id, anchor)
        self._placement_of[workload_id] = gpu_id

    def release(self, workload_id: int) -> None:
        if workload_id not in self._placement_of:
            raise KeyError(
                f"workload {workload_id} is not placed on this cluster"
            )
        gpu_id = self._placement_of.pop(workload_id)
        self.gpus[gpu_id].release(workload_id)

    def migrate(self, workload_id: int, gpu_id: int, anchor: int) -> Tuple[int, int, int]:
        """Move a running workload to a new placement (same class, same id).

        The single primitive behind every defrag ``pending_migration``
        apply (simulator protocols, serving admission, host replay).
        Returns the old ``(gpu, anchor, profile_id)``; raises like
        :meth:`allocate` if the target is illegal or occupied.
        """
        old_gpu = self._placement_of[workload_id]
        alloc = self.gpus[old_gpu].allocations[workload_id]
        old = (old_gpu, alloc.anchor, alloc.profile_id)
        self.release(workload_id)
        self.allocate(workload_id, alloc.profile_id, gpu_id, anchor)
        return old

    def gpu_of(self, workload_id: int) -> Optional[int]:
        return self._placement_of.get(workload_id)

    # -- faults -------------------------------------------------------------
    def up_mask(self) -> np.ndarray:
        """(M,) bool — True for GPUs currently accepting placements."""
        return np.array([g.up for g in self.gpus], dtype=bool)

    def fail_gpu(self, gpu_id: int) -> List[int]:
        """Take a GPU down, evicting every live allocation on it.

        Returns the evicted workload ids (insertion order).  The slices are
        released, so a down GPU reads as empty in every occupancy metric;
        :meth:`GPUState.feasible_anchors` keeps it out of placement until
        :meth:`recover_gpu`.
        """
        gpu = self.gpus[gpu_id]
        if not gpu.up:
            raise ValueError(f"GPU {gpu_id} is already down")
        evicted = list(gpu.allocations)
        for wid in evicted:
            self.release(wid)
        gpu.up = False
        return evicted

    def recover_gpu(self, gpu_id: int) -> None:
        """Bring a failed GPU back into the placement tables (empty)."""
        gpu = self.gpus[gpu_id]
        if gpu.up:
            raise ValueError(f"GPU {gpu_id} is already up")
        gpu.up = True

    # -- metrics ------------------------------------------------------------
    @property
    def active_gpus(self) -> int:
        return sum(g.is_active for g in self.gpus)

    @property
    def used_mem_slices(self) -> int:
        return sum(g.used_mem_slices for g in self.gpus)

    @property
    def used_compute_slices(self) -> int:
        return sum(g.used_compute_slices for g in self.gpus)

    @property
    def total_mem_slices(self) -> int:
        return self.spec.total_mem_slices
