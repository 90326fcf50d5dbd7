"""Host-side replay and validation of batched-engine decision traces.

The batched engine (:mod:`repro_torch.sim.batched`) emits one decision per
event (``EventTrace``); together with the host-known stream annotations
(``EventStream``/``EventMeta``) the full occupancy trajectory of every
replica is reproducible in plain numpy.  :func:`replay` re-executes the
commits, releases — and, for defrag specs, the migrations — and asserts
the scheduling invariants the engine must uphold:

* an accepted placement uses a *legal placement-table anchor* for its
  profile **on the model of the chosen GPU** (Table I on the A100-80GB,
  the model's own table on mixed fleets);
* it never *double-books* a memory slice (its window is fully free);
* a *release after expiry restores the exact pre-allocation occupancy*
  (the window is fully occupied right before release and fully free after);
* a *migration never double-books or strands a workload*: the victim named
  by the trace is a uniquely identified running workload, its old window
  is fully occupied before the move, its new window is legal for its class
  on the target model and fully free, and the workload stays tracked (same
  expiry) at its new placement.

:func:`host_decisions` additionally drives the *Python* schedulers over the
same presampled event stream, producing a decision trace that must match
the device trace decision-for-decision — migrations included
(:func:`host_decisions_full` also returns the chosen migrations) — the
strongest cross-engine check we have, and it works on any ClusterSpec and
either protocol's stream.

:func:`queued_host_decisions` and :func:`faulted_host_decisions` do the
same for the ``steady-queued`` and ``steady-faulted`` protocols (the wait
ring, and the fault stage's evictions, retries and backoff).

Tests use this to cross-check the device loop against an independent
host implementation; it is also handy for debugging new policies.  It is
numpy only: the walks read fetched traces
(:func:`repro_torch.sim.batched.trace_to_numpy`), and the schedulers are
the host ones of :mod:`repro_torch.core.schedulers`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import mig
from repro_torch.core.policy import PolicyLike, key_base, queue_order, resolve
from repro_torch.core.schedulers import MFIDefrag, make_scheduler
from repro_torch.sim.batched import EventMeta, EventStream, EventTrace


def _spec_or_default(spec: Optional[mig.ClusterSpec], num_gpus: int) -> mig.ClusterSpec:
    if spec is None:
        return mig.ClusterSpec.homogeneous(mig.A100_80GB, num_gpus)
    assert spec.num_gpus == num_gpus
    return spec


class _Alive(NamedTuple):
    """One still-allocated workload during a replay walk."""

    end: int
    gpu: int
    anchor: int
    mem: int
    pid: int


def _walk(
    events: EventStream,
    meta: EventMeta,
    trace: EventTrace,
    num_gpus: int,
    check: bool,
    spec: Optional[mig.ClusterSpec] = None,
):
    """Shared event walk: returns (final_occ (R, M, S), alive sets per replica).

    Each alive entry is an :class:`_Alive` for a workload still allocated
    when the stream ends.  Migrations recorded in the trace are re-executed
    (and, with ``check``, validated) exactly like commits and releases.
    """
    spec = _spec_or_default(spec, num_gpus)
    e_max, runs = np.asarray(events.pid).shape
    pid = np.asarray(events.pid)
    new_slot = np.asarray(events.new_slot)
    ok = np.asarray(trace.ok)
    gpu = np.asarray(trace.gpu)
    aidx = np.asarray(trace.aidx)
    slot = np.asarray(meta.slot)
    end = np.asarray(meta.end)
    has_mig = trace.mig is not None
    if has_mig:
        mig_flag = np.asarray(trace.mig)
        mig_from_gpu = np.asarray(trace.mig_from_gpu)
        mig_from_anchor = np.asarray(trace.mig_from_anchor)
        mig_to_gpu = np.asarray(trace.mig_to_gpu)
        mig_to_anchor = np.asarray(trace.mig_to_anchor)
    has_wadm = trace.wadm_eidx is not None
    if has_wadm:
        wadm_eidx = np.asarray(trace.wadm_eidx)
        wadm_gpu = np.asarray(trace.wadm_gpu)
        wadm_aidx = np.asarray(trace.wadm_aidx)

    final = np.zeros((runs, num_gpus, spec.num_mem_slices), dtype=np.int32)
    alive_sets = []
    for r in range(runs):
        occ = final[r]
        alive: List[_Alive] = []
        for e in range(e_max):
            if new_slot[e, r]:
                t = slot[e, r]
                expired = [w for w in alive if w.end <= t]
                alive = [w for w in alive if w.end > t]
                for w in expired:
                    if check:
                        assert (occ[w.gpu, w.anchor : w.anchor + w.mem] == 1).all(), (
                            f"replica {r} event {e}: release of "
                            f"[{w.anchor},{w.anchor + w.mem}) on GPU {w.gpu} "
                            f"does not match a fully-occupied window"
                        )
                    occ[w.gpu, w.anchor : w.anchor + w.mem] = 0
            if has_wadm and wadm_eidx[e, r] >= 0:
                # a parked arrival admits from the wait ring at this event:
                # commit it with its ORIGINAL profile and end slot (the
                # lease deadline is unchanged by waiting)
                e0 = int(wadm_eidx[e, r])
                p0 = int(pid[e0, r])
                g0, j0 = int(wadm_gpu[e, r]), int(wadm_aidx[e, r])
                prof0 = spec.model_of(g0).profiles[p0]
                if check:
                    assert p0 >= 0 and not ok[e0, r], (
                        f"replica {r} event {e}: wait-admit references event "
                        f"{e0}, which is not a rejected arrival"
                    )
                    assert int(end[e0, r]) > int(slot[e, r]), (
                        f"replica {r} event {e}: wait-admit past the lease "
                        f"deadline of event {e0}"
                    )
                    assert 0 <= j0 < prof0.num_placements, (
                        f"replica {r} event {e}: wait-admit anchor index "
                        f"{j0} illegal for {prof0.name}"
                    )
                a0 = prof0.anchors[j0]
                if check:
                    assert (occ[g0, a0 : a0 + prof0.mem] == 0).all(), (
                        f"replica {r} event {e}: wait-admit {prof0.name}@{a0} "
                        f"double-books slices on GPU {g0}"
                    )
                occ[g0, a0 : a0 + prof0.mem] = 1
                alive.append(_Alive(int(end[e0, r]), g0, a0, prof0.mem, p0))
            p = pid[e, r]
            if p < 0 or not ok[e, r]:
                continue
            if has_mig and mig_flag[e, r]:
                # the migration commits before the request: find the unique
                # victim, free its old window, re-place it on the target
                vg, va = int(mig_from_gpu[e, r]), int(mig_from_anchor[e, r])
                ng, na = int(mig_to_gpu[e, r]), int(mig_to_anchor[e, r])
                victims = [
                    i for i, w in enumerate(alive) if w.gpu == vg and w.anchor == va
                ]
                if check:
                    assert len(victims) == 1, (
                        f"replica {r} event {e}: migration victim at "
                        f"GPU {vg} anchor {va} matches {len(victims)} running "
                        f"workloads (must be exactly one)"
                    )
                w = alive[victims[0]]
                vprof = spec.model_of(ng).profiles[w.pid]
                if check:
                    assert (occ[vg, va : va + w.mem] == 1).all(), (
                        f"replica {r} event {e}: migration evicts a window "
                        f"that is not fully occupied"
                    )
                occ[vg, va : va + w.mem] = 0
                if check:
                    assert na in vprof.anchors, (
                        f"replica {r} event {e}: migration target anchor {na} "
                        f"illegal for {vprof.name} on {spec.model_of(ng).name}"
                    )
                    assert (occ[ng, na : na + vprof.mem] == 0).all(), (
                        f"replica {r} event {e}: migration double-books "
                        f"slices on GPU {ng}"
                    )
                occ[ng, na : na + vprof.mem] = 1
                alive[victims[0]] = _Alive(w.end, ng, na, vprof.mem, w.pid)
            g, j = int(gpu[e, r]), int(aidx[e, r])
            prof = spec.model_of(g).profiles[p]
            if check:
                assert 0 <= j < prof.num_placements, (
                    f"replica {r} event {e}: anchor index {j} illegal for "
                    f"profile {prof.name} on {spec.model_of(g).name}"
                )
            anchor = prof.anchors[j]
            if check:
                assert (occ[g, anchor : anchor + prof.mem] == 0).all(), (
                    f"replica {r} event {e}: {prof.name}@{anchor} double-books "
                    f"slices on GPU {g}"
                )
            occ[g, anchor : anchor + prof.mem] = 1
            alive.append(_Alive(int(end[e, r]), g, anchor, prof.mem, int(p)))
        alive_sets.append(alive)
    return final, alive_sets


def replay(
    events: EventStream,
    meta: EventMeta,
    trace: EventTrace,
    num_gpus: int,
    check: bool = True,
    spec: Optional[mig.ClusterSpec] = None,
) -> np.ndarray:
    """Re-execute a decision trace on host; returns final occupancy (R, M, S).

    With ``check=True`` (default), raises ``AssertionError`` on any
    invariant violation (illegal anchor, double-booking, inexact release,
    inconsistent migration).  ``spec`` selects the fleet (default:
    homogeneous A100-80GB).
    """
    final, _ = _walk(events, meta, trace, num_gpus, check, spec)
    return final


def drain_all(
    events: EventStream,
    meta: EventMeta,
    trace: EventTrace,
    num_gpus: int,
    spec: Optional[mig.ClusterSpec] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Replay, then release every still-active workload.

    Returns ``(final_occ, drained_occ)``; ``drained_occ`` must be all-zero
    if and only if every release restores its exact allocation window —
    the end-to-end form of the release-restores-occupancy invariant (and,
    for defrag specs, the no-stranded-workload half of the migration
    invariant: a migrated workload still drains from its *new* placement).
    """
    final, alive_sets = _walk(events, meta, trace, num_gpus, check=True, spec=spec)
    drained = final.copy()
    for r, alive in enumerate(alive_sets):
        for w in alive:
            assert (drained[r, w.gpu, w.anchor : w.anchor + w.mem] == 1).all()
            drained[r, w.gpu, w.anchor : w.anchor + w.mem] = 0
    return final, drained


class HostTrace(NamedTuple):
    """Reference decisions of the Python schedulers, shaped ``(E_max, R)``."""

    ok: np.ndarray
    gpu: np.ndarray
    anchor: np.ndarray
    mig: np.ndarray            # a migration accompanied the accept
    mig_from_gpu: np.ndarray   # victim's old GPU (-1 where no migration)
    mig_from_anchor: np.ndarray
    mig_to_gpu: np.ndarray
    mig_to_anchor: np.ndarray


def host_decisions_full(
    events: EventStream,
    meta: EventMeta,
    policy: PolicyLike,
    num_gpus: int,
    metric: str = "blocked",
    spec: Optional[mig.ClusterSpec] = None,
    **scheduler_kwargs,
) -> HostTrace:
    """Drive the *Python* scheduler over a presampled event stream.

    ``policy`` is any registered policy name or ad-hoc
    :class:`~repro_torch.core.policy.PolicySpec` (compiled per replica through
    the registry).  Returns a :class:`HostTrace` with the reference
    decision for every arrival — and, for defrag schedulers, the chosen
    migration — produced on a :class:`repro_torch.core.mig.ClusterState` with the
    same arrivals, durations and release schedule the batched engine
    consumed.  Since single-step selection is exact-parity, the device
    trace must agree element-for-element (``ok`` everywhere; ``gpu``,
    ``anchor`` and the migration wherever accepted).  ``scheduler_kwargs``
    reach the compiled scheduler (e.g. ``max_candidates=None`` to lift the
    defrag budget to the batched engine's exhaustive search).
    """
    spec = _spec_or_default(spec, num_gpus)
    e_max, runs = np.asarray(events.pid).shape
    pid = np.asarray(events.pid)
    new_slot = np.asarray(events.new_slot)
    slot = np.asarray(meta.slot)
    end = np.asarray(meta.end)

    ok = np.zeros((e_max, runs), dtype=bool)
    gpu = np.full((e_max, runs), -1, dtype=np.int32)
    anchor = np.full((e_max, runs), -1, dtype=np.int32)
    mig_flag = np.zeros((e_max, runs), dtype=bool)
    mig_fg = np.full((e_max, runs), -1, dtype=np.int32)
    mig_fa = np.full((e_max, runs), -1, dtype=np.int32)
    mig_tg = np.full((e_max, runs), -1, dtype=np.int32)
    mig_ta = np.full((e_max, runs), -1, dtype=np.int32)
    for r in range(runs):
        cluster = mig.ClusterState(spec=spec)
        scheduler = _make(policy, metric, scheduler_kwargs)
        alive = []  # (end_slot, workload_id)
        for e in range(e_max):
            if new_slot[e, r]:
                t = slot[e, r]
                for tend, wid in [w for w in alive if w[0] <= t]:
                    cluster.release(wid)
                alive = [w for w in alive if w[0] > t]
            p = int(pid[e, r])
            if p < 0:
                continue
            sel = scheduler.select(cluster, p)
            if sel is None:
                continue
            pending = getattr(scheduler, "pending_migration", None)
            if pending is not None:
                vwid, ng, na = pending
                old_gpu, old_anchor, _ = cluster.migrate(vwid, ng, na)
                mig_flag[e, r] = True
                mig_fg[e, r] = old_gpu
                mig_fa[e, r] = old_anchor
                mig_tg[e, r] = ng
                mig_ta[e, r] = na
            g, a = sel
            wid = e  # unique per replica stream
            cluster.allocate(wid, p, g, a)
            alive.append((int(end[e, r]), wid))
            ok[e, r] = True
            gpu[e, r] = g
            anchor[e, r] = a
    return HostTrace(ok, gpu, anchor, mig_flag, mig_fg, mig_fa, mig_tg, mig_ta)


def _make(policy, metric, scheduler_kwargs):
    if scheduler_kwargs:
        spec = resolve(policy, engine="python")
        if spec.defrag:
            return MFIDefrag(metric=metric, spec=spec, **scheduler_kwargs)
    return make_scheduler(policy, metric)


def host_decisions(
    events: EventStream,
    meta: EventMeta,
    policy: PolicyLike,
    num_gpus: int,
    metric: str = "blocked",
    spec: Optional[mig.ClusterSpec] = None,
    **scheduler_kwargs,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Back-compat 3-tuple form of :func:`host_decisions_full`:
    ``(ok, gpu, anchor)`` arrays shaped like the stream (``(E_max, R)``)."""
    t = host_decisions_full(
        events, meta, policy, num_gpus, metric=metric, spec=spec,
        **scheduler_kwargs,
    )
    return t.ok, t.gpu, t.anchor


class QueuedHostTrace(NamedTuple):
    """Reference decisions of the queued protocol, shaped ``(E_max, R)``.

    ``ok`` is the in-place accept of each arrival; ``parked`` marks
    rejected arrivals that entered the wait queue; ``wadm_*`` record, per
    *event*, the wait-queue admission that happened there (the original
    arrival's event index, its GPU and its anchor VALUE; ``-1`` when
    none).
    """

    ok: np.ndarray
    gpu: np.ndarray
    anchor: np.ndarray
    parked: np.ndarray
    wadm_eidx: np.ndarray
    wadm_gpu: np.ndarray
    wadm_anchor: np.ndarray


class _Waiting(NamedTuple):
    """One parked request in the queued host reference."""

    eidx: int   # original event index (= its workload id)
    pid: int
    arr: int    # arrival slot
    end: int    # absolute lease deadline
    prio: int
    tenant: int


def queued_host_decisions(
    events: EventStream,
    meta: EventMeta,
    policy: PolicyLike,
    num_gpus: int,
    metric: str = "blocked",
    spec: Optional[mig.ClusterSpec] = None,
    capacity: int = 8,
    patience: int = 16,
) -> QueuedHostTrace:
    """Drive the Python scheduler over a queued presampled stream.

    The independent host reference of the batched ``steady-queued``
    protocol (:mod:`repro_torch.sim.batched`), event-for-event: at every live
    event, *before* the arrival, prune wait entries past their lease
    deadline or the patience budget, then attempt ONE admission of the
    queue head — the lexicographic minimum of the policy's queue order
    (:func:`repro_torch.core.policy.queue_order`; arrival order breaks ties) —
    committing it with its original profile and deadline.  The arrival
    then selects as usual; a rejected arrival parks if the queue
    (``capacity`` entries) has room.  The device trace must agree
    element-for-element: ``ok``/``parked`` everywhere, placements wherever
    accepted, and the wait admissions (event, origin, placement) exactly.

    The stream must have been presampled with ``queued=True``
    (:func:`repro_torch.sim.batched.presample_arrivals`).
    """
    if events.prio is None:
        raise ValueError(
            "queued_host_decisions needs a queued stream "
            "(presample_arrivals(..., queued=True))"
        )
    spec = _spec_or_default(spec, num_gpus)
    pspec = resolve(policy, engine="python")
    order = queue_order(pspec)
    e_max, runs = np.asarray(events.pid).shape
    pid = np.asarray(events.pid)
    new_slot = np.asarray(events.new_slot)
    slot = np.asarray(meta.slot)
    end = np.asarray(meta.end)
    prio = np.asarray(events.prio)
    tenant = np.asarray(events.tenant)
    wlive = np.asarray(events.wlive)

    ok = np.zeros((e_max, runs), dtype=bool)
    gpu = np.full((e_max, runs), -1, dtype=np.int32)
    anchor = np.full((e_max, runs), -1, dtype=np.int32)
    parked = np.zeros((e_max, runs), dtype=bool)
    wadm_eidx = np.full((e_max, runs), -1, dtype=np.int32)
    wadm_gpu = np.full((e_max, runs), -1, dtype=np.int32)
    wadm_anchor = np.full((e_max, runs), -1, dtype=np.int32)

    def head_key(t):
        def key_fn(w: _Waiting):
            key = []
            for k in order:
                base = key_base(k)
                if base == "priority":
                    v = w.prio
                elif base == "wait-age":
                    v = t - w.arr
                else:  # tenant
                    v = w.tenant
                key.append(-v if k.startswith("-") else v)
            key.append(w.eidx)  # FIFO tie-break
            return tuple(key)

        return key_fn

    for r in range(runs):
        cluster = mig.ClusterState(spec=spec)
        scheduler = make_scheduler(pspec, metric)
        alive = []  # (end_slot, workload_id)
        waiting: List[_Waiting] = []
        for e in range(e_max):
            if new_slot[e, r]:
                t = slot[e, r]
                for tend, wid in [w for w in alive if w[0] <= t]:
                    cluster.release(wid)
                alive = [w for w in alive if w[0] > t]
            if wlive[e, r]:
                t = int(slot[e, r])
                # prune, then one admission attempt of the queue head
                waiting = [
                    w for w in waiting
                    if w.end > t and t - w.arr <= patience
                ]
                if waiting:
                    w = min(waiting, key=head_key(t))
                    sel = scheduler.select(cluster, w.pid)
                    if sel is not None:
                        waiting.remove(w)
                        g, a = sel
                        cluster.allocate(w.eidx, w.pid, g, a)
                        alive.append((w.end, w.eidx))
                        wadm_eidx[e, r] = w.eidx
                        wadm_gpu[e, r] = g
                        wadm_anchor[e, r] = a
            p = int(pid[e, r])
            if p < 0:
                continue
            sel = scheduler.select(cluster, p)
            if sel is not None:
                g, a = sel
                cluster.allocate(e, p, g, a)
                alive.append((int(end[e, r]), e))
                ok[e, r] = True
                gpu[e, r] = g
                anchor[e, r] = a
            elif wlive[e, r] and len(waiting) < capacity:
                waiting.append(
                    _Waiting(
                        eidx=e, pid=p, arr=int(slot[e, r]),
                        end=int(end[e, r]), prio=int(prio[e, r]),
                        tenant=int(tenant[e, r]),
                    )
                )
                parked[e, r] = True
    return QueuedHostTrace(
        ok, gpu, anchor, parked, wadm_eidx, wadm_gpu, wadm_anchor
    )


class FaultedHostTrace(NamedTuple):
    """Reference decisions of the faulted protocol, shaped ``(E_max, R)``.

    The :class:`QueuedHostTrace` fields plus the fault stage's eviction
    accounting: ``evicted`` live entries torn off failing GPUs at this
    event, ``evict_lost`` of which were final losses (wait ring full or a
    zero retry budget), and ``evict_esum`` the sum of their original event
    indexes (an order-insensitive identity check against the device).
    """

    ok: np.ndarray
    gpu: np.ndarray
    anchor: np.ndarray
    parked: np.ndarray
    wadm_eidx: np.ndarray
    wadm_gpu: np.ndarray
    wadm_anchor: np.ndarray
    evicted: np.ndarray
    evict_lost: np.ndarray
    evict_esum: np.ndarray


class _FWaiting(NamedTuple):
    """One parked or evicted request in the faulted host reference."""

    eidx: int   # original event index (= its workload id)
    pid: int
    arr: int    # arrival (or last re-arm) slot — the wait-age clock
    end: int    # absolute lease deadline
    prio: int
    tenant: int
    row: int    # original expiry-ring coordinates (unchanged for life)
    col: int
    tries: int  # re-queue attempts consumed (0 = fresh park)
    rdy: int    # earliest slot this entry may be picked as queue head


class _FAlive(NamedTuple):
    """One running workload in the faulted host reference."""

    end: int
    wid: int
    gpu: int
    row: int
    col: int
    pid: int
    prio: int
    tenant: int


def faulted_host_decisions(
    events: EventStream,
    meta: EventMeta,
    policy: PolicyLike,
    num_gpus: int,
    metric: str = "blocked",
    spec: Optional[mig.ClusterSpec] = None,
    capacity: int = 8,
    patience: int = 16,
    max_retries: int = 2,
    backoff_base: int = 2,
) -> FaultedHostTrace:
    """Drive the Python scheduler over a faulted presampled stream.

    The independent host reference of the batched ``steady-faulted``
    protocol, event-for-event.  Per event, in the engine's stage order:

    1. on a slot boundary, release leases whose end slot arrived (a lease
       ending the very slot its GPU dies still completes);
    2. apply the slot's recover-then-fail lanes: a failing GPU evicts its
       live workloads in flat expiry-ring ``(row, col)`` order, re-queuing
       each (``tries=1``, ready after ``backoff_base`` slots) until the
       wait queue's ``capacity``; the overflow — or everything, when
       ``max_retries < 1`` — is a final loss;
    3. the wait stage: entries past their lease are dropped; entries past
       the ``patience`` budget re-arm with exponential backoff
       (``backoff_base * 2**(tries-1)``) while ``tries < max_retries`` and
       the lease allows, else drop; one admission attempt of the head —
       the queue-order minimum among entries whose backoff expired;
    4. the arrival selects (failed GPUs masked); a reject parks if the
       queue has room (``tries=0``, immediately ready).

    The device trace must agree element-for-element, eviction accounting
    included.  The stream must have been presampled with ``queued=True``
    and a fault model (:func:`repro_torch.sim.batched.presample_arrivals`).
    """
    if events.prio is None or events.fail is None:
        raise ValueError(
            "faulted_host_decisions needs a faulted stream "
            "(presample_arrivals(..., queued=True, fault_model=...))"
        )
    spec = _spec_or_default(spec, num_gpus)
    pspec = resolve(policy, engine="python")
    order = queue_order(pspec)
    e_max, runs = np.asarray(events.pid).shape
    pid = np.asarray(events.pid)
    new_slot = np.asarray(events.new_slot)
    exp_row = np.asarray(events.exp_row)
    exp_col = np.asarray(events.exp_col)
    slot = np.asarray(meta.slot)
    end = np.asarray(meta.end)
    prio = np.asarray(events.prio)
    tenant = np.asarray(events.tenant)
    wlive = np.asarray(events.wlive)
    fail = np.asarray(events.fail)      # (E, R, M)
    recover = np.asarray(events.recover)

    def backoff(k: int) -> int:
        return backoff_base * 2 ** max(0, k - 1)

    ok = np.zeros((e_max, runs), dtype=bool)
    gpu = np.full((e_max, runs), -1, dtype=np.int32)
    anchor = np.full((e_max, runs), -1, dtype=np.int32)
    parked = np.zeros((e_max, runs), dtype=bool)
    wadm_eidx = np.full((e_max, runs), -1, dtype=np.int32)
    wadm_gpu = np.full((e_max, runs), -1, dtype=np.int32)
    wadm_anchor = np.full((e_max, runs), -1, dtype=np.int32)
    evicted = np.zeros((e_max, runs), dtype=np.int32)
    evict_lost = np.zeros((e_max, runs), dtype=np.int32)
    evict_esum = np.zeros((e_max, runs), dtype=np.int32)

    def head_key(t):
        def key_fn(w: _FWaiting):
            key = []
            for k in order:
                base = key_base(k)
                if base == "priority":
                    v = w.prio
                elif base == "wait-age":
                    v = t - w.arr
                else:  # tenant
                    v = w.tenant
                key.append(-v if k.startswith("-") else v)
            key.append(w.eidx)  # FIFO tie-break
            return tuple(key)

        return key_fn

    for r in range(runs):
        cluster = mig.ClusterState(spec=spec)
        scheduler = make_scheduler(pspec, metric)
        alive: List[_FAlive] = []
        waiting: List[_FWaiting] = []
        for e in range(e_max):
            if new_slot[e, r]:
                t = int(slot[e, r])
                for w in [w for w in alive if w.end <= t]:
                    cluster.release(w.wid)
                alive = [w for w in alive if w.end > t]
            ups = np.flatnonzero(recover[e, r])
            for g in ups:  # recover-then-fail, like the device's up update
                cluster.recover_gpu(int(g))
            downs = np.flatnonzero(fail[e, r])
            if len(downs):
                t = int(slot[e, r])
                ds = set(int(g) for g in downs)
                # device flat ring order: evictions fill the wait queue in
                # ascending (row, col) until capacity
                evs = sorted(
                    (w for w in alive if w.gpu in ds),
                    key=lambda w: (w.row, w.col),
                )
                alive = [w for w in alive if w.gpu not in ds]
                for g in ds:
                    cluster.fail_gpu(g)
                evicted[e, r] = len(evs)
                evict_esum[e, r] = sum(w.wid for w in evs)
                lost = 0
                for w in evs:
                    if max_retries >= 1 and len(waiting) < capacity:
                        waiting.append(
                            _FWaiting(
                                eidx=w.wid, pid=w.pid, arr=t, end=w.end,
                                prio=w.prio, tenant=w.tenant,
                                row=w.row, col=w.col,
                                tries=1, rdy=t + backoff(1),
                            )
                        )
                    else:
                        lost += 1
                evict_lost[e, r] = lost
            if wlive[e, r]:
                t = int(slot[e, r])
                # prune / re-arm, then one admission attempt of the head
                kept: List[_FWaiting] = []
                for w in waiting:
                    if t - w.arr > patience:
                        if w.tries < max_retries and w.end > t:
                            k = w.tries + 1
                            kept.append(
                                w._replace(arr=t, tries=k, rdy=t + backoff(k))
                            )
                        # else: retry budget or lease exhausted — final drop
                    elif w.end > t:
                        kept.append(w)
                waiting = kept
                ready = [w for w in waiting if w.rdy <= t]
                if ready:
                    w = min(ready, key=head_key(t))
                    sel = scheduler.select(cluster, w.pid)
                    if sel is not None:
                        waiting.remove(w)
                        g, a = sel
                        cluster.allocate(w.eidx, w.pid, g, a)
                        alive.append(
                            _FAlive(
                                w.end, w.eidx, g, w.row, w.col, w.pid,
                                w.prio, w.tenant,
                            )
                        )
                        wadm_eidx[e, r] = w.eidx
                        wadm_gpu[e, r] = g
                        wadm_anchor[e, r] = a
            p = int(pid[e, r])
            if p < 0:
                continue
            t = int(slot[e, r])
            sel = scheduler.select(cluster, p)
            if sel is not None:
                g, a = sel
                cluster.allocate(e, p, g, a)
                alive.append(
                    _FAlive(
                        int(end[e, r]), e, g, int(exp_row[e, r]),
                        int(exp_col[e, r]), p, int(prio[e, r]),
                        int(tenant[e, r]),
                    )
                )
                ok[e, r] = True
                gpu[e, r] = g
                anchor[e, r] = a
            elif wlive[e, r] and len(waiting) < capacity:
                waiting.append(
                    _FWaiting(
                        eidx=e, pid=p, arr=t, end=int(end[e, r]),
                        prio=int(prio[e, r]), tenant=int(tenant[e, r]),
                        row=int(exp_row[e, r]), col=int(exp_col[e, r]),
                        tries=0, rdy=t,
                    )
                )
                parked[e, r] = True
    return FaultedHostTrace(
        ok, gpu, anchor, parked, wadm_eidx, wadm_gpu, wadm_anchor,
        evicted, evict_lost, evict_esum,
    )
