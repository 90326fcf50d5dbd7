"""Host-engine policy compiler: `PolicySpec` -> `Scheduler`.

The policies themselves (MFI — paper Algorithm 2 — and the four baselines)
are *declared* once in :mod:`repro_torch.core.policy` as lexicographic
:class:`~repro_torch.core.policy.PolicySpec` key lists; this module
interprets a spec against a :class:`repro_torch.core.mig.ClusterState`.
The batched engine (:mod:`repro_torch.sim.batched`) lowers the same specs
to vectorized selection inside its event step.  This is the port's copy of
the JAX package's host compiler; tests hold the two equal decision for
decision.

All schedulers implement ``select(cluster, profile_id) -> (gpu_id, anchor)``
or ``None`` (reject).  They never mutate the cluster; the caller commits.

Anchor-selection policies (paper §VI) map onto the key vocabulary:
  * MIG-agnostic (FF, RR): "first available index" — the ascending
    ``anchor`` key.
  * MIG-aware "Best Index" (BF-BI, WF-BI), after [Turkkan et al. 2024]:
    prefer indexes that do not restrict profiles with fewer placement
    options — e.g. 1g.10gb goes to index 6 rather than 0, reserving the
    {0..3} window for 4g.40gb.  This is the descending ``-anchor`` key,
    which reproduces the paper's example preference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import fragmentation, mig
from repro_torch.core.policy import (
    REQUEST_KEYS,
    PolicyLike,
    PolicySpec,
    key_base,
    resolve,
)

Placement = Tuple[int, int]  # (gpu_id, anchor)


class Scheduler:
    """Base class. Subclasses implement ``select``."""

    name: str = "base"

    def __init__(self, metric: str = "blocked"):
        self.metric = metric

    def select(self, cluster: mig.ClusterState, profile_id: int) -> Optional[Placement]:
        raise NotImplementedError

    def reset(self) -> None:  # for stateful schedulers (RR)
        pass


class SpecScheduler(Scheduler):
    """Interprets a :class:`PolicySpec` on the host cluster state.

    Candidates are every feasible ``(gpu, anchor)`` dry-run of the request
    (the spec's feasibility filter); the winner minimizes the spec's key
    tuple lexicographically, with ascending ``(gpu, anchor)`` as the
    implicit final tie-break — exactly the order the batched lowering's
    first-flat-index argmin produces.
    """

    def __init__(self, spec: PolicySpec, metric: str = "blocked"):
        super().__init__(metric)
        self.spec = spec
        self.name = spec.name
        self._next = 0  # rotation cursor (used by the "rr-distance" key)

    def reset(self) -> None:
        self._next = 0

    # -- candidate enumeration ----------------------------------------------
    def _candidates(self, cluster: mig.ClusterState, profile_id: int):
        """Feasible dry-runs as ``(gpu_ids, anchors, deltas)`` arrays.

        ΔF is computed only when the spec's keys ask for it; the loop is
        vectorized per model group exactly like the ΔF kernels' oracle
        (:func:`mfi_candidates`).
        """
        if self.spec.requires_delta_f:
            occ = cluster.occupancy_matrix()
            gpu_ids, anchors, deltas = [], [], []
            for model, rows in cluster.spec.model_groups():
                # down GPUs look empty in the occupancy matrix (their slices
                # were released on failure), so they must be masked out here
                # — the other enumeration paths go through feasible_anchors
                rows = rows[[cluster.gpus[g].up for g in rows]]
                if not len(rows):
                    continue
                g, a, d = mfi_candidates(
                    occ[rows][:, : model.num_mem_slices],
                    profile_id,
                    self.metric,
                    model,
                )
                gpu_ids.append(rows[g])  # local -> global GPU ids
                anchors.append(a)
                deltas.append(d)
            if gpu_ids:
                gpu_ids = np.concatenate(gpu_ids)
                anchors = np.concatenate(anchors)
                deltas = np.concatenate(deltas)
            else:
                gpu_ids = np.empty(0, dtype=np.int64)
                anchors = np.empty(0, dtype=np.int64)
                deltas = np.empty(0)
        else:
            pairs = [
                (g.gpu_id, a)
                for g in cluster.gpus
                for a in g.feasible_anchors(profile_id)
            ]
            gpu_ids = np.array([p[0] for p in pairs], dtype=np.int64)
            anchors = np.array([p[1] for p in pairs], dtype=np.int64)
            deltas = np.zeros(len(pairs))
        return gpu_ids, anchors, deltas

    def _key_column(self, key, cluster, profile_id, gpus, anchors, deltas):
        base = key_base(key)
        if base == "frag-delta":
            col = deltas
        elif base == "free-slices":
            col = np.array(
                [
                    cluster.gpus[g].free_slices
                    - cluster.gpus[g].model.profiles[profile_id].mem
                    for g in gpus
                ],
                dtype=np.float64,
            )
        elif base == "gpu":
            col = gpus.astype(np.float64)
        elif base == "anchor":
            col = anchors.astype(np.float64)
        elif base == "rr-distance":
            col = ((gpus - self._next) % cluster.num_gpus).astype(np.float64)
        elif base == "model-group":
            col = cluster.spec.model_index[gpus].astype(np.float64)
        elif base in REQUEST_KEYS:
            # request-scoped keys (tenant / priority / wait-age) are
            # constant over the candidates of one request — a zero column
            # never changes the lexsort outcome.  Their semantics live in
            # the cross-request queue order (policy.queue_order).
            col = np.zeros(len(gpus), dtype=np.float64)
        else:  # unreachable: PolicySpec validates the vocabulary
            raise ValueError(f"unknown scoring key {key!r}")
        return -col if key.startswith("-") else col

    def _pick(self, cluster, profile_id, gpus, anchors, deltas) -> Placement:
        cols = [
            self._key_column(k, cluster, profile_id, gpus, anchors, deltas)
            for k in self.spec.keys
        ]
        # np.lexsort: last key is primary; (gpu, anchor) is the implicit
        # least-significant tie-break shared with the batched lowering
        k = int(np.lexsort((anchors, gpus) + tuple(reversed(cols)))[0])
        return (int(gpus[k]), int(anchors[k]))

    def select(self, cluster, profile_id):
        spec = self.spec
        sel: Optional[Placement] = None
        if not spec.requires_delta_f and key_base(spec.keys[0]) in ("gpu", "rr-distance"):
            # gpu-major primary key: the winner lives on the first GPU (in
            # scan order) with any feasible anchor — short-circuit like the
            # classic First-Fit / Round-Robin loops did
            m = cluster.num_gpus
            start = self._next if key_base(spec.keys[0]) == "rr-distance" else 0
            order = range(m) if not spec.keys[0].startswith("-") else range(m - 1, -1, -1)
            for i in order:
                g = (start + i) % m
                feas = cluster.gpus[g].feasible_anchors(profile_id)
                if feas:
                    gp = np.full(len(feas), g, dtype=np.int64)
                    an = np.asarray(feas, dtype=np.int64)
                    sel = self._pick(cluster, profile_id, gp, an, np.zeros(len(feas)))
                    break
        else:
            gpus, anchors, deltas = self._candidates(cluster, profile_id)
            if len(gpus):
                sel = self._pick(cluster, profile_id, gpus, anchors, deltas)
        if sel is not None and spec.stateful_cursor:
            self._next = (sel[0] + 1) % cluster.num_gpus
        return sel


def mfi_candidates(
    occupancy: np.ndarray,
    profile_id: int,
    metric: str = "blocked",
    model: Optional[mig.DeviceModel] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized MFI inner loop (numpy reference for the ``mfi_delta`` kernel).

    Returns (gpu_ids, anchors, delta_f) arrays over all *feasible* dry-run
    placements of ``profile_id`` across same-model GPUs (default A100-80GB;
    mixed clusters call this once per model group).
    """
    if model is None:
        model = mig.A100_80GB
    occ = np.asarray(occupancy, dtype=np.int32)
    m = occ.shape[0]
    rows = model.profile_placement_rows(profile_id)
    masks = model.placement_masks[rows]  # (A, S)
    anchors = model.placement_anchor[rows]  # (A,)
    a = masks.shape[0]

    # feasibility: window fully free (classes with no realization have A=0)
    overlap = occ @ masks.T  # (M, A)
    feasible = overlap == 0

    if not feasible.any():
        empty = np.empty(0, dtype=np.int64)
        return empty, empty, np.empty(0)

    f_before = fragmentation.fragmentation_scores(occ, metric, model)  # (M,)
    # hypothetical occupancy for every (gpu, anchor): (M, A, S)
    hypo = np.minimum(occ[:, None, :] + masks[None, :, :], 1)
    f_after = fragmentation.fragmentation_scores(
        hypo.reshape(m * a, model.num_mem_slices), metric, model
    ).reshape(m, a)
    delta = f_after - f_before[:, None]

    gpu_idx, anchor_idx = np.nonzero(feasible)
    return gpu_idx, anchors[anchor_idx], delta[gpu_idx, anchor_idx]


class MFIDefrag(SpecScheduler):
    """BEYOND-PAPER extension: MFI + opportunistic single-migration defrag.

    The paper excludes rescheduling ("we are going to consider rescheduling
    in a future work").  This variant keeps the no-disruption spirit almost
    intact: only when a request would be REJECTED does it search for ONE
    running workload whose migration (to a spec-chosen new placement) makes
    the request feasible, choosing the migration that minimises the final
    cluster fragmentation sum.  The caller performs the migration via the
    ``pending_migration`` attribute ((workload_id, gpu, anchor) or None).

    The search is **canonical**: victims are enumerated in ascending
    ``(gpu, anchor)`` order and the first strict minimum of the total-F
    objective wins, i.e. the chosen migration is the lexicographic minimum
    of ``(total F after, victim gpu, victim anchor)``.  The batched
    engine's migrate stage (:mod:`repro_torch.sim.batched`) computes exactly this
    total order with masked tensor ops.  The search is unbounded by
    default — matching the batched engine, which is always exhaustive (it
    is vectorized, a budget would save no work) — so the two engines
    express the same policy at any scale; pass ``max_candidates`` to cap
    host-side work on large clusters at the cost of that parity.
    """

    def __init__(
        self,
        metric: str = "blocked",
        max_candidates: Optional[int] = None,
        spec: Optional[PolicySpec] = None,
    ):
        super().__init__(spec if spec is not None else resolve("mfi-defrag"), metric)
        self.max_candidates = max_candidates
        self.pending_migration = None
        self.migrations = 0

    def select(self, cluster, profile_id):
        self.pending_migration = None
        sel = super().select(cluster, profile_id)
        if sel is not None:
            return sel

        # rejected: try single-workload migration
        budget = (
            self.max_candidates
            if self.max_candidates is not None
            else float("inf")
        )
        best = None  # (total_F, victim_id, victim_new, request_placement)
        tried = 0
        for gpu in cluster.gpus:
            if tried >= budget:
                break  # candidate budget caps TOTAL work, not per-GPU work
            # canonical victim order: ascending anchor within the GPU scan
            # (the migration objective's tie-break — see class docstring)
            victims = sorted(
                gpu.allocations.items(), key=lambda kv: kv[1].anchor
            )
            for wid, alloc in victims:
                if tried >= budget:
                    break
                tried += 1
                prof = gpu.model.profiles[alloc.profile_id]
                # hypothetically remove the victim
                gpu.occupancy[alloc.anchor : alloc.anchor + prof.mem] = 0
                req_sel = super().select(cluster, profile_id)
                if req_sel is not None:
                    rg, ra = req_sel
                    rp = cluster.gpus[rg].model.profiles[profile_id]
                    cluster.gpus[rg].occupancy[ra : ra + rp.mem] = 1
                    new_sel = super().select(cluster, alloc.profile_id)
                    if new_sel is not None:
                        ng, na = new_sel
                        nprof = cluster.gpus[ng].model.profiles[alloc.profile_id]
                        occ = cluster.occupancy_matrix().copy()
                        occ[ng, na : na + nprof.mem] = 1
                        total = fragmentation.spec_fragmentation_scores(
                            occ, cluster.spec, self.metric
                        ).sum()
                        cand = (total, wid, (ng, na), req_sel)
                        if best is None or cand[0] < best[0]:
                            best = cand
                    cluster.gpus[rg].occupancy[ra : ra + rp.mem] = 0
                # restore victim
                gpu.occupancy[alloc.anchor : alloc.anchor + prof.mem] = 1
        if best is None:
            return None
        _, wid, new_place, req_sel = best
        self.pending_migration = (wid, *new_place)
        self.migrations += 1
        return req_sel


def compile_policy(spec: PolicySpec, metric: str = "blocked") -> Scheduler:
    """Host-engine compiler: spec -> ready-to-run ``Scheduler``.

    Registry-compiled defrag schedulers run the UNBOUNDED canonical search
    so both engines express the same policy at any scale (the batched
    migrate stage is always exhaustive); construct
    ``MFIDefrag(max_candidates=...)`` directly to opt into the work cap.
    """
    if spec.defrag:
        return MFIDefrag(metric=metric, spec=spec, max_candidates=None)
    return SpecScheduler(spec, metric=metric)


def make_scheduler(policy: PolicyLike, metric: str = "blocked") -> Scheduler:
    """Compile a registered policy name (or an ad-hoc spec) for the host
    engine.  Unknown names raise through the registry's single validation
    path (:func:`repro_torch.core.policy.resolve`)."""
    return compile_policy(resolve(policy, engine="python"), metric=metric)


# ---------------------------------------------------------------------------
# Backward-compatible class aliases — thin spec bindings, no select loops.
# ---------------------------------------------------------------------------


def _spec_alias(policy_name: str, doc: str) -> type:
    class _Alias(SpecScheduler):
        name = policy_name

        def __init__(self, metric: str = "blocked"):
            super().__init__(resolve(policy_name), metric)

    _Alias.__name__ = _Alias.__qualname__ = policy_name.replace("-", "_").upper()
    _Alias.__doc__ = doc
    return _Alias


MFI = _spec_alias("mfi", "Minimum Fragmentation Increment (paper Algorithm 2).")
FirstFit = _spec_alias("ff", "MIG-agnostic: first GPU with room, first index.")
RoundRobin = _spec_alias("rr", "MIG-agnostic: rotate over GPUs, first index.")
BestFitBestIndex = _spec_alias(
    "bf-bi", "MIG-aware bin packing: minimize post-allocation free slices."
)
WorstFitBestIndex = _spec_alias(
    "wf-bi", "MIG-aware load balancing: maximize post-allocation free slices."
)

#: registered host-engine policies (name -> compiling callable); kept for
#: backward compatibility — `repro_torch.core.policy.list_policies()` is the API.
SCHEDULERS: Dict[str, type] = {
    "ff": FirstFit,
    "rr": RoundRobin,
    "bf-bi": BestFitBestIndex,
    "wf-bi": WorstFitBestIndex,
    "mfi": MFI,
    "mfi-defrag": MFIDefrag,
}
