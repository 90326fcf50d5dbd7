"""Admission control: the paper's scheduler as the serving control plane.

Each incoming serving workload declares a MIG profile demand (derived from
its model's memory footprint); the controller consults a scheduling policy
(MFI by default, any paper baseline selectable) against the simulated MIG
cluster, commits accepted placements and releases them on completion —
reproducing the arrival/termination churn of paper Fig. 1 inside a real
serving loop.

Beyond accept-or-drop, the controller is a tenant-aware queued front-end:
requests carry ``(tenant, priority, patience)``, rejected requests park in
a bounded waiting queue ordered by the policy's queue keys
(:func:`repro_torch.core.policy.queue_order` — priority first, oldest
wait-age breaking ties by default), per-tenant concurrency quotas cap how
much of the fleet one tenant can hold, and every release re-drives
admission so parked requests dispatch as capacity frees up.

Numpy and Python only, exact: the port's copy of the JAX package's
controller, held equal to it decision for decision by the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import mig
from repro_torch.core.policy import (
    DEFAULT_QUEUE_ORDER,
    PolicyLike,
    key_base,
    queue_order,
)
from repro_torch.core.schedulers import Scheduler, make_scheduler


def profile_for_model(param_bytes: int, kv_bytes: int = 0, compute_heavy: bool = False) -> str:
    """Map a model's memory footprint to the smallest fitting MIG profile.

    Raises :class:`ValueError` when the footprint (with activation
    headroom) exceeds the largest MIG profile (80 GiB) — an unplaceable
    demand must fail loudly at submission, not silently degrade into a
    ``7g.80gb`` that can never hold the model.
    """
    gib = (param_bytes + kv_bytes) / 2**30 * 1.2  # + activation headroom
    if gib <= 10:
        return "1g.10gb"
    if gib <= 20:
        return "2g.20gb" if compute_heavy else "1g.20gb"
    if gib <= 40:
        return "4g.40gb" if compute_heavy else "3g.40gb"
    if gib <= 80:
        return "7g.80gb"
    raise ValueError(
        f"model footprint {gib:.1f} GiB (with headroom) exceeds the largest "
        "MIG profile (7g.80gb, 80 GiB); it cannot be served on one slice"
    )


@dataclasses.dataclass
class Placement:
    workload_id: int
    profile: str
    gpu: int
    anchor: int
    tenant: str = "default"
    priority: int = 0
    patience: int = 0  # carried along so an eviction re-queues with it


@dataclasses.dataclass
class QueueEntry:
    """One parked request in the admission waiting queue."""

    workload_id: int
    profile: str
    tenant: str
    priority: int
    patience: int   # max clock ticks it may wait before final rejection
    arrival: int    # controller clock at submission (reset on re-arm)
    seq: int        # submission order — final FIFO tie-break
    tries: int = 0      # eviction re-queue attempts consumed (0 = fresh park)
    ready_at: int = 0   # earliest clock this entry may dispatch (backoff)


class AdmissionController:
    """Places serving workloads on the MIG cluster via a scheduling policy.

    ``policy`` is any registered policy name or an ad-hoc
    :class:`~repro_torch.core.policy.PolicySpec` — compiled for the host engine
    through the policy registry, so custom registered policies drive
    admission exactly like the built-ins.  ``cluster_spec`` selects a
    (possibly mixed) fleet; the default is the paper's homogeneous
    A100-80GB cluster of ``num_gpus`` GPUs.  Workloads keep declaring
    canonical profile names — each GPU's device model realizes the demand
    with its own placement table (an 80 GiB demand is simply infeasible on
    every A100-40GB, for example).

    Queued admission: :meth:`submit` admits, parks (``patience > 0`` and
    queue room) or rejects.  The queue is ordered by the policy's
    request-scoped keys (:func:`~repro_torch.core.policy.queue_order`); each
    :meth:`release` re-drives admission from the queue head until the
    first failure (head-of-line order is part of the contract), and
    :meth:`tick` advances the wait clock, expiring entries past their
    patience.  Dispatches and expiries triggered in the background are
    collected with :meth:`drain_dispatched` / :meth:`drain_expired`.
    ``tenant_quotas`` caps concurrently placed workloads per tenant
    (requests over quota queue or reject without consulting the policy).

    Fault handling: :meth:`fail_gpu` marks a GPU down — its running
    workloads are evicted into the waiting queue with a retry budget
    (``max_retries``) and exponential backoff (``backoff_base`` doubling
    per attempt) — and :meth:`recover_gpu` brings it back (re-driving
    admission).  Evicted entries past their patience re-arm with doubled
    backoff while the retry budget lasts; exhausted ones are final losses,
    surfaced via :meth:`drain_expired` and the ``evict_lost`` stat.
    Fresh parked requests keep the plain patience-expiry semantics.
    """

    def __init__(
        self,
        num_gpus: Optional[int] = None,
        policy: PolicyLike = "mfi",
        metric: str = "blocked",
        cluster_spec: Optional[mig.ClusterSpec] = None,
        queue_capacity: int = 64,
        tenant_quotas: Optional[Dict[str, int]] = None,
        max_retries: int = 2,
        backoff_base: int = 2,
    ):
        if queue_capacity < 0:
            raise ValueError(
                f"queue_capacity must be >= 0, got {queue_capacity}"
            )
        if max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0 (eviction re-queue budget), "
                f"got {max_retries}"
            )
        if backoff_base < 1:
            raise ValueError(
                f"backoff_base must be >= 1 (ticks before the first retry), "
                f"got {backoff_base}"
            )
        self.cluster = mig.ClusterState(num_gpus, spec=cluster_spec)
        self.scheduler: Scheduler = make_scheduler(policy, metric)
        self.placements: Dict[int, Placement] = {}
        self.queue: List[QueueEntry] = []
        self.queue_capacity = queue_capacity
        self.tenant_quotas = dict(tenant_quotas or {})
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.accepted = 0
        self.rejected = 0
        self.completed = 0
        self.evictions = 0
        self.evict_lost = 0
        self.clock = 0
        self._seq = 0
        self._active_by_tenant: Dict[str, int] = {}
        self._tenant_submitted: Dict[str, int] = {}
        self._tenant_accepted: Dict[str, int] = {}
        self._waits: List[int] = []
        self._drained_dispatched: List[Placement] = []
        self._drained_expired: List[int] = []
        self._evicted_at: Dict[int, int] = {}  # wid -> eviction clock
        self._recovered = 0
        self._ttrs: List[int] = []

    # -- queue ordering ------------------------------------------------------

    @property
    def _queue_order(self) -> Tuple[str, ...]:
        spec = getattr(self.scheduler, "spec", None)
        return queue_order(spec) if spec is not None else DEFAULT_QUEUE_ORDER

    def _entry_key(self, entry: QueueEntry):
        key = []
        for k in self._queue_order:
            base = key_base(k)
            if base == "priority":
                v: float = entry.priority
            elif base == "wait-age":
                v = self.clock - entry.arrival
            else:  # tenant — stable hash-free ordering by name
                v = 0.0
            key.append(-v if k.startswith("-") else v)
        key.append(entry.seq)  # FIFO tie-break
        return tuple(key)

    # -- admission -----------------------------------------------------------

    def submit(
        self,
        workload_id: int,
        profile: str,
        tenant: str = "default",
        priority: int = 0,
        patience: int = 0,
    ) -> Optional[Placement]:
        """Admit, park or reject one request.

        Returns the :class:`Placement` on immediate admission, ``None``
        otherwise — distinguish a parked request (later surfacing via
        :meth:`drain_dispatched` or :meth:`drain_expired`) from a final
        reject with :meth:`in_queue`.
        """
        if workload_id in self.placements:
            raise ValueError(
                f"workload {workload_id} is already placed "
                f"({self.placements[workload_id]}); duplicate admission "
                "would orphan its MIG slices"
            )
        if any(e.workload_id == workload_id for e in self.queue):
            raise ValueError(
                f"workload {workload_id} is already waiting in the "
                "admission queue"
            )
        if profile not in mig.PROFILE_NAMES:
            raise ValueError(
                f"unknown MIG profile {profile!r} "
                f"(valid: {', '.join(mig.PROFILE_NAMES)})"
            )
        if priority < 0:
            raise ValueError(
                f"priority must be >= 0 (0 = most urgent), got {priority}"
            )
        if patience < 0:
            raise ValueError(
                f"patience must be >= 0 (clock ticks the request may wait; "
                f"0 = accept-or-drop), got {patience}"
            )
        self._tenant_submitted[tenant] = self._tenant_submitted.get(tenant, 0) + 1
        placement = self._try_dispatch(
            workload_id, profile, tenant, priority, patience
        )
        if placement is not None:
            self._waits.append(0)
            return placement
        if patience > 0 and len(self.queue) < self.queue_capacity:
            self.queue.append(
                QueueEntry(
                    workload_id, profile, tenant, priority,
                    patience, self.clock, self._seq,
                    ready_at=self.clock,
                )
            )
            self._seq += 1
            return None
        self.rejected += 1
        return None

    def admit(self, workload_id: int, profile: str) -> Optional[Placement]:
        """Back-compat accept-or-drop admission (``patience=0``)."""
        return self.submit(workload_id, profile)

    def _try_dispatch(
        self,
        workload_id: int,
        profile: str,
        tenant: str,
        priority: int,
        patience: int = 0,
    ) -> Optional[Placement]:
        quota = self.tenant_quotas.get(tenant)
        if quota is not None and self._active_by_tenant.get(tenant, 0) >= quota:
            return None
        pid = mig.PROFILE_NAMES.index(profile)
        sel = self.scheduler.select(self.cluster, pid)
        if sel is None:
            return None
        pending = getattr(self.scheduler, "pending_migration", None)
        if pending is not None:  # defrag policies: move the victim first
            vwid, vgpu, vanchor = pending
            self.cluster.migrate(vwid, vgpu, vanchor)
            old = self.placements[vwid]
            self.placements[vwid] = dataclasses.replace(
                old, gpu=vgpu, anchor=vanchor
            )
        gpu, anchor = sel
        self.cluster.allocate(workload_id, pid, gpu, anchor)
        placement = Placement(
            workload_id, profile, gpu, anchor, tenant, priority, patience
        )
        self.placements[workload_id] = placement
        evicted_at = self._evicted_at.pop(workload_id, None)
        if evicted_at is not None:  # an eviction re-admitting, not a new accept
            self._recovered += 1
            self._ttrs.append(self.clock - evicted_at)
        else:
            self.accepted += 1
            self._tenant_accepted[tenant] = self._tenant_accepted.get(tenant, 0) + 1
        self._active_by_tenant[tenant] = self._active_by_tenant.get(tenant, 0) + 1
        return placement

    # -- queue progress ------------------------------------------------------

    def _expire_overdue(self) -> None:
        keep: List[QueueEntry] = []
        for e in self.queue:
            if self.clock - e.arrival <= e.patience:
                keep.append(e)
            elif 1 <= e.tries < self.max_retries:
                # overdue eviction with retry budget left: re-arm with
                # doubled backoff instead of expiring
                e.tries += 1
                e.arrival = self.clock
                e.ready_at = self.clock + self._backoff(e.tries)
                keep.append(e)
            else:
                if e.workload_id in self._evicted_at:
                    # an eviction that never re-admitted — a final loss,
                    # but not a (second) admission reject
                    del self._evicted_at[e.workload_id]
                    self.evict_lost += 1
                else:
                    self.rejected += 1
                self._drained_expired.append(e.workload_id)
        self.queue = keep

    def _backoff(self, attempt: int) -> int:
        return self.backoff_base * 2 ** max(0, attempt - 1)

    def _readmit(self) -> None:
        """Dispatch from the queue head until the first failure.

        The head is the queue-order minimum among entries whose backoff
        expired (``ready_at <= clock``); entries still backing off are
        skipped without breaking head-of-line order among the ready."""
        self._expire_overdue()
        while True:
            self.queue.sort(key=self._entry_key)
            ready = [e for e in self.queue if e.ready_at <= self.clock]
            if not ready:
                break
            head = ready[0]
            placement = self._try_dispatch(
                head.workload_id, head.profile, head.tenant, head.priority,
                head.patience,
            )
            if placement is None:
                break  # head-of-line blocking: later entries wait their turn
            self.queue.remove(head)
            self._waits.append(self.clock - head.arrival)
            self._drained_dispatched.append(placement)

    def tick(self, steps: int = 1) -> None:
        """Advance the wait clock, expiring overdue entries and re-driving
        admission (wait-age ordering can change the queue head)."""
        self.clock += steps
        self._readmit()

    def release(self, workload_id: int) -> None:
        if workload_id not in self.placements:
            raise KeyError(
                f"workload {workload_id} has no active placement to release"
            )
        placement = self.placements.pop(workload_id)
        self.cluster.release(workload_id)
        self._active_by_tenant[placement.tenant] -= 1
        self.completed += 1
        self._readmit()

    # -- fault handling ------------------------------------------------------

    def fail_gpu(self, gpu_id: int) -> List[int]:
        """Mark a GPU failed; evict and re-queue its running workloads.

        The GPU is masked out of placement until :meth:`recover_gpu`.
        Each evicted workload re-enters the waiting queue with one retry
        consumed and a ``backoff_base``-tick backoff (its patience floored
        at the backoff so it survives to its first retry); when the retry
        budget is zero or the queue is full it is a final loss, surfaced
        via :meth:`drain_expired`.  Returns the evicted workload ids in
        placement order.
        """
        wids = self.cluster.fail_gpu(gpu_id)
        for wid in wids:
            p = self.placements.pop(wid)
            self._active_by_tenant[p.tenant] -= 1
            self.evictions += 1
            if self.max_retries >= 1 and len(self.queue) < self.queue_capacity:
                self._evicted_at[wid] = self.clock
                self.queue.append(
                    QueueEntry(
                        wid, p.profile, p.tenant, p.priority,
                        patience=max(p.patience, self._backoff(1)),
                        arrival=self.clock, seq=self._seq, tries=1,
                        ready_at=self.clock + self._backoff(1),
                    )
                )
                self._seq += 1
            else:
                self.evict_lost += 1
                self._drained_expired.append(wid)
        return wids

    def recover_gpu(self, gpu_id: int) -> None:
        """Bring a failed GPU back up and re-drive queue admission."""
        self.cluster.recover_gpu(gpu_id)
        self._readmit()

    # -- drain buffers -------------------------------------------------------

    def in_queue(self, workload_id: int) -> bool:
        return any(e.workload_id == workload_id for e in self.queue)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def drain_dispatched(self) -> List[Placement]:
        """Placements dispatched from the queue since the last drain."""
        out, self._drained_dispatched = self._drained_dispatched, []
        return out

    def drain_expired(self) -> List[int]:
        """Workload ids finally rejected (patience exhausted) since the
        last drain."""
        out, self._drained_expired = self._drained_expired, []
        return out

    def flush_queue(self) -> List[int]:
        """Finally reject every waiting entry (e.g. at shutdown, or when no
        running workload remains to ever free capacity)."""
        wids = [e.workload_id for e in self.queue]
        for wid in wids:
            if wid in self._evicted_at:  # flushed eviction: a final loss
                del self._evicted_at[wid]
                self.evict_lost += 1
            else:
                self.rejected += 1
        self._drained_expired.extend(wids)
        self.queue = []
        return wids

    # -- metrics -------------------------------------------------------------

    @property
    def acceptance_rate(self) -> float:
        total = self.accepted + self.rejected
        return self.accepted / total if total else 1.0

    def stats(self) -> Dict[str, float]:
        import numpy as np

        from repro_torch.core import fragmentation
        from repro_torch.sim.simulator import jain_fairness

        waits = np.asarray(self._waits, dtype=np.float64)
        rates = [
            self._tenant_accepted.get(t, 0) / n
            for t, n in self._tenant_submitted.items()
            if n > 0
        ]
        return {
            "accepted": self.accepted,
            "rejected": self.rejected,
            "acceptance_rate": self.acceptance_rate,
            "active_gpus": self.cluster.active_gpus,
            "used_slices": self.cluster.used_mem_slices,
            "frag_severity": fragmentation.cluster_fragmentation(
                self.cluster.occupancy_matrix(),
                self.scheduler.metric,
                spec=self.cluster.spec,
            ),
            "queue_depth": float(len(self.queue)),
            "wait_p50": float(np.percentile(waits, 50)) if waits.size else 0.0,
            "wait_p99": float(np.percentile(waits, 99)) if waits.size else 0.0,
            "fairness": jain_fairness(rates),
            # fault/recovery metrics (all benign defaults when no GPU failed)
            "goodput": (
                self.completed / (self.completed + self.evict_lost)
                if (self.completed + self.evict_lost) else 1.0
            ),
            "evictions": float(self.evictions),
            "evict_lost": float(self.evict_lost),
            "recovered_fraction": (
                self._recovered / self.evictions if self.evictions else 1.0
            ),
            "ttr_p50": (
                float(np.percentile(np.asarray(self._ttrs), 50))
                if self._ttrs else 0.0
            ),
            "ttr_p99": (
                float(np.percentile(np.asarray(self._ttrs), 99))
                if self._ttrs else 0.0
            ),
        }
