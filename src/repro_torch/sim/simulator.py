"""Online Monte-Carlo scheduling simulation (paper §VI): configuration,
load model and the host reference engine.

Four load protocols (the reference's):

* ``"steady"`` (default): the "GPU demand" axis is the **offered load** —
  the steady-state concurrent slice demand as a fraction of cluster
  capacity.  Workloads arrive as a Poisson process with rate
  ``λ_f = f·capacity / (E[duration]·E[mem])`` per slot, durations are
  sampled ``U[1, T]`` slots (``T = capacity/E[mem]``, the paper's
  saturation horizon), the simulation warms up for ``3T`` slots and
  measures over ``2T`` slots.
* ``"cumulative"`` (paper-literal text): one arrival per slot, durations
  ``U[1, T]``; the demand axis is cumulative arrived demand / capacity.
* ``"steady-queued"``: the steady protocol with a bounded, tenant-aware
  waiting queue (patience budget, lease deadline fixed at arrival, the
  policy's queue order); adds p50/p99 wait and Jain per-tenant fairness.
* ``"steady-faulted"``: the queued protocol under GPU failures
  (:class:`repro_torch.core.mig.FaultModel`); adds goodput, evictions,
  recovered fraction and time-to-recovery percentiles.

:func:`run_simulation` is the host reference loop: pure numpy over
:class:`repro_torch.core.mig.ClusterState`, one ``scheduler.select`` per
arrival, so any :class:`~repro_torch.core.schedulers.Scheduler` — a host
policy, or one that decides on the card — drives it.  It draws from its
``numpy`` generator in the reference's order, so equal seeds give equal
floats.  The batched engine (:mod:`repro_torch.sim.batched`) runs the
steady protocol on the device.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import fragmentation, mig
from repro_torch.core.policy import DEFAULT_QUEUE_ORDER, PolicyLike, key_base, queue_order
from repro_torch.core.schedulers import Scheduler, make_scheduler
from repro_torch.sim import distributions


@dataclasses.dataclass
class SimConfig:
    num_gpus: int = 100
    distribution: str = "uniform"
    protocol: str = "steady"  # "steady" | "cumulative" | "steady-queued" | "steady-faulted"
    metric: str = "blocked"   # fragmentation variant (MFI scoring + severity metric)
    seed: int = 0
    # heterogeneous fleets: a ClusterSpec overrides num_gpus (the paper's
    # homogeneous A100-80GB setup is the default one-model spec)
    cluster_spec: Optional[mig.ClusterSpec] = None
    # optional per-device-model demand-class mix (model name -> Table-II
    # distribution name); models not listed keep ``distribution``.  The
    # effective fleet-wide mix is the capacity-weighted mixture — see
    # :func:`repro_torch.sim.distributions.resolve_probs`.
    model_distributions: Optional[Dict[str, str]] = None
    # steady protocol:
    offered_load: float = 0.85  # fraction of slice capacity offered concurrently
    warmup_horizons: int = 3    # warmup = this * T slots
    measure_horizons: int = 2   # measurement window = this * T slots
    # cumulative protocol:
    max_demand: float = 1.0
    demand_grid: Sequence[float] = tuple(np.round(np.arange(0.05, 1.001, 0.05), 3))
    # steady-queued protocol (multi-tenant waiting queue):
    num_tenants: int = 4       # tenant ids sampled uniformly per arrival
    num_priorities: int = 2    # priority classes (0 = most urgent)
    wait_capacity: int = 8     # waiting-queue slots per cluster
    wait_patience: int = 16    # max slots a request may wait before final reject
    # steady-faulted protocol: GPU failure/recovery process (required there,
    # ignored elsewhere)
    fault_model: Optional[mig.FaultModel] = None

    def __post_init__(self):
        if self.cluster_spec is not None:
            self.num_gpus = self.cluster_spec.num_gpus
        if self.wait_patience < 0:
            raise ValueError(
                f"wait_patience must be >= 0 (slots a request may wait), "
                f"got {self.wait_patience}"
            )
        if self.wait_capacity < 0:
            raise ValueError(
                f"wait_capacity must be >= 0 (queue slots), got {self.wait_capacity}"
            )
        if self.num_priorities < 1:
            raise ValueError(
                f"num_priorities must be >= 1 (priority classes are sampled "
                f"from [0, num_priorities)), got {self.num_priorities}"
            )
        if self.num_tenants < 1:
            raise ValueError(
                f"num_tenants must be >= 1, got {self.num_tenants}"
            )

    def spec(self) -> mig.ClusterSpec:
        """The cluster spec (defaulting to the paper's homogeneous fleet)."""
        if self.cluster_spec is not None:
            return self.cluster_spec
        return mig.ClusterSpec.homogeneous(mig.A100_80GB, self.num_gpus)


@dataclasses.dataclass
class SimResult:
    acceptance_rate: float
    allocated_workloads: float   # accepted in measurement window (steady) / total (cumulative)
    active_gpus: float           # time-averaged (steady) / final (cumulative)
    utilization: float           # allocated mem slices / capacity, time-averaged
    frag_severity: float         # cluster-mean F, time-averaged
    rejects_by_profile: np.ndarray  # (P,) counts
    arrivals_by_profile: np.ndarray  # (P,)
    # cumulative-protocol traces on the demand grid (None for steady):
    demand_grid: Optional[np.ndarray] = None
    traces: Optional[Dict[str, np.ndarray]] = None
    # steady-queued protocol only (None otherwise):
    wait_p50: Optional[float] = None   # median wait of accepted requests (slots)
    wait_p99: Optional[float] = None   # p99 wait of accepted requests (slots)
    fairness: Optional[float] = None   # Jain index over per-tenant acceptance
    queue_admits: Optional[float] = None  # accepted after waiting (count)
    # steady-faulted protocol only (None otherwise):
    goodput: Optional[float] = None    # measured arrivals whose lease completed
    evictions: Optional[float] = None  # workloads torn off failing GPUs (count)
    recovered_fraction: Optional[float] = None  # evictions later re-admitted
    ttr_p50: Optional[float] = None    # median slots from eviction to re-admit
    ttr_p99: Optional[float] = None    # p99 slots from eviction to re-admit


def request_probs(cfg: SimConfig) -> np.ndarray:
    """Effective demand-class probabilities of a configuration.

    The named Table-II mix by default; the capacity-weighted per-model
    mixture when ``cfg.model_distributions`` is set.
    """
    return distributions.resolve_probs(
        cfg.distribution, cfg.spec(), cfg.model_distributions
    )


#: slots between metric samples in the steady measurement window
SAMPLE_EVERY = 10


def steady_params(cfg: SimConfig) -> Tuple[int, int, int, float]:
    """Steady-protocol parameters: ``(T, warm, meas, rate)``.

    Capacity is the spec's total slice count; the per-request slice demand
    is normalized by the *canonical* (A100-80GB) class sizes, so offered
    load keeps the paper's meaning on the homogeneous fleet and stays a
    consistent, model-independent knob on mixed fleets.
    """
    cap = cfg.spec().total_mem_slices
    mean_mem = distributions.mean_mem_from_probs(request_probs(cfg))
    T = int(np.ceil(cap / mean_mem))
    mean_dur = (1 + T) / 2
    rate = cfg.offered_load * cap / (mean_dur * mean_mem)
    return T, cfg.warmup_horizons * T, cfg.measure_horizons * T, rate


def _apply_migration(cluster: mig.ClusterState, mig_req) -> None:
    """Move a defrag scheduler's pending victim to its new placement."""
    vwid, vg, va = mig_req
    cluster.migrate(vwid, vg, va)


def jain_fairness(values) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` of per-tenant rates.

    1.0 = perfectly even; 1/n = maximally skewed.  Empty or all-zero
    inputs (no tenant saw any demand / no tenant was served) return 1.0 —
    nothing was distributed unevenly.
    """
    x = np.asarray(list(values), dtype=np.float64)
    if x.size == 0:
        return 1.0
    sq = float(np.square(x).sum())
    if sq == 0.0:
        return 1.0
    s = float(x.sum())
    return s * s / (x.size * sq)


def _queue_sort_key(order, t):
    """Sort key of a wait-queue entry under a policy's queue order at slot
    ``t`` (``-`` prefixes flip; arrival order is the final tie-break)."""

    def key_fn(entry):
        key = []
        for k in order:
            base = key_base(k)
            if base == "priority":
                v = entry["prio"]
            elif base == "wait-age":
                v = t - entry["arr"]
            else:  # tenant
                v = entry["tenant"]
            key.append(-v if k.startswith("-") else v)
        key.append(entry["seq"])  # FIFO tie-break
        return tuple(key)

    return key_fn


def run_simulation(scheduler: Scheduler, cfg: SimConfig, seed: Optional[int] = None) -> SimResult:
    if cfg.protocol == "steady":
        return _run_steady(scheduler, cfg, cfg.seed if seed is None else seed)
    elif cfg.protocol == "cumulative":
        return _run_cumulative(scheduler, cfg, cfg.seed if seed is None else seed)
    elif cfg.protocol == "steady-queued":
        return _run_steady_queued(scheduler, cfg, cfg.seed if seed is None else seed)
    elif cfg.protocol == "steady-faulted":
        return _run_steady_faulted(scheduler, cfg, cfg.seed if seed is None else seed)
    raise ValueError(f"unknown protocol {cfg.protocol!r}")


def _run_steady(scheduler: Scheduler, cfg: SimConfig, seed: int) -> SimResult:
    rng = np.random.default_rng(seed)
    scheduler.reset()
    spec = cfg.spec()
    cap = spec.total_mem_slices
    probs = request_probs(cfg)
    T, warm, meas, rate = steady_params(cfg)

    cluster = mig.ClusterState(spec=spec)
    expiry: List = []
    wid = 0
    arr = acc = 0
    rejects = np.zeros(mig.NUM_PROFILES)
    arrivals = np.zeros(mig.NUM_PROFILES)
    util_s = gpus_s = frag_s = 0.0
    nsamp = 0

    for t in range(warm + meas):
        while expiry and expiry[0][0] <= t:
            _, w = heapq.heappop(expiry)
            cluster.release(w)
        for _ in range(rng.poisson(rate)):
            pid = int(distributions.sample_profile_probs(probs, 1, rng)[0])
            measuring = t >= warm
            if measuring:
                arr += 1
                arrivals[pid] += 1
            sel = scheduler.select(cluster, pid)
            if sel is not None:
                mig_req = getattr(scheduler, "pending_migration", None)
                if mig_req is not None:  # mfi-defrag: move the victim first
                    _apply_migration(cluster, mig_req)
                cluster.allocate(wid, pid, *sel)
                heapq.heappush(expiry, (t + int(rng.integers(1, T + 1)), wid))
                if measuring:
                    acc += 1
            elif measuring:
                rejects[pid] += 1
            wid += 1
        if t >= warm and (t - warm) % SAMPLE_EVERY == 0:
            util_s += cluster.used_mem_slices / cap
            gpus_s += cluster.active_gpus
            frag_s += fragmentation.cluster_fragmentation(
                cluster.occupancy_matrix(), cfg.metric, spec=spec
            )
            nsamp += 1

    return SimResult(
        acceptance_rate=acc / max(arr, 1),
        allocated_workloads=float(acc),
        active_gpus=gpus_s / max(nsamp, 1),
        utilization=util_s / max(nsamp, 1),
        frag_severity=frag_s / max(nsamp, 1),
        rejects_by_profile=rejects,
        arrivals_by_profile=arrivals,
    )


def _run_steady_queued(scheduler: Scheduler, cfg: SimConfig, seed: int) -> SimResult:
    """Steady-protocol loop with a tenant-aware waiting queue.

    Rejected arrivals park in a bounded queue (``cfg.wait_capacity``) with
    a patience budget (``cfg.wait_patience`` slots).  Every slot, after
    releases, the queue is drained greedily in the policy's queue order
    (:func:`repro_torch.core.policy.queue_order`) until the head no longer fits.
    Requests keep their lease deadline from arrival (``end = arrival +
    duration``), the batched engine's wait-ring semantics: a
    queued request past its deadline or patience is a final reject.
    """
    rng = np.random.default_rng(seed)
    scheduler.reset()
    spec = cfg.spec()
    cap = spec.total_mem_slices
    probs = request_probs(cfg)
    T, warm, meas, rate = steady_params(cfg)
    order = queue_order(scheduler.spec) if hasattr(scheduler, "spec") else DEFAULT_QUEUE_ORDER

    cluster = mig.ClusterState(spec=spec)
    expiry: List = []
    queue: List[Dict] = []
    wid = 0
    arr = acc = 0
    rejects = np.zeros(mig.NUM_PROFILES)
    arrivals = np.zeros(mig.NUM_PROFILES)
    util_s = gpus_s = frag_s = 0.0
    nsamp = 0
    waits: List[float] = []
    queue_admits = 0
    tenant_arr = np.zeros(cfg.num_tenants)
    tenant_acc = np.zeros(cfg.num_tenants)

    def reject(entry):
        nonlocal rejects
        if entry["measuring"]:
            rejects[entry["pid"]] += 1

    def dispatch(entry, sel, t):
        nonlocal acc, queue_admits
        mig_req = getattr(scheduler, "pending_migration", None)
        if mig_req is not None:  # mfi-defrag: move the victim first
            _apply_migration(cluster, mig_req)
        cluster.allocate(entry["wid"], entry["pid"], *sel)
        heapq.heappush(expiry, (entry["end"], entry["wid"]))
        if entry["measuring"]:
            acc += 1
            tenant_acc[entry["tenant"]] += 1
            waits.append(float(t - entry["arr"]))
            if t > entry["arr"]:
                queue_admits += 1

    for t in range(warm + meas):
        while expiry and expiry[0][0] <= t:
            _, w = heapq.heappop(expiry)
            cluster.release(w)
        # prune, then drain the queue in queue order until the head blocks
        for entry in [e for e in queue if e["end"] <= t or t - e["arr"] > cfg.wait_patience]:
            queue.remove(entry)
            reject(entry)
        queue.sort(key=_queue_sort_key(order, t))
        while queue:
            sel = scheduler.select(cluster, queue[0]["pid"])
            if sel is None:
                break
            dispatch(queue.pop(0), sel, t)
        for _ in range(rng.poisson(rate)):
            pid = int(distributions.sample_profile_probs(probs, 1, rng)[0])
            tenant = int(rng.integers(0, max(1, cfg.num_tenants)))
            prio = int(rng.integers(0, max(1, cfg.num_priorities)))
            measuring = t >= warm
            if measuring:
                arr += 1
                arrivals[pid] += 1
                tenant_arr[tenant] += 1
            entry = {
                "wid": wid, "pid": pid, "tenant": tenant, "prio": prio,
                "arr": t, "end": t + int(rng.integers(1, T + 1)),
                "measuring": measuring, "seq": wid,
            }
            sel = scheduler.select(cluster, pid)
            if sel is not None:
                dispatch(entry, sel, t)
            elif cfg.wait_patience > 0 and len(queue) < cfg.wait_capacity:
                queue.append(entry)
            else:
                reject(entry)
            wid += 1
        if t >= warm and (t - warm) % SAMPLE_EVERY == 0:
            util_s += cluster.used_mem_slices / cap
            gpus_s += cluster.active_gpus
            frag_s += fragmentation.cluster_fragmentation(
                cluster.occupancy_matrix(), cfg.metric, spec=spec
            )
            nsamp += 1

    for entry in queue:  # still waiting at horizon end: final rejects
        reject(entry)

    rates = [tenant_acc[k] / tenant_arr[k] for k in range(cfg.num_tenants) if tenant_arr[k] > 0]
    return SimResult(
        acceptance_rate=acc / max(arr, 1),
        allocated_workloads=float(acc),
        active_gpus=gpus_s / max(nsamp, 1),
        utilization=util_s / max(nsamp, 1),
        frag_severity=frag_s / max(nsamp, 1),
        rejects_by_profile=rejects,
        arrivals_by_profile=arrivals,
        wait_p50=float(np.percentile(waits, 50)) if waits else 0.0,
        wait_p99=float(np.percentile(waits, 99)) if waits else 0.0,
        fairness=jain_fairness(rates),
        queue_admits=float(queue_admits),
    )


def _fault_schedule(
    spec: mig.ClusterSpec,
    fault_model: mig.FaultModel,
    horizon: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-GPU alternating fail/recover marks, ``(horizon, M)`` bools each.

    Exponential up/down phases (per-model rates), phase lengths ceiled to
    at least one slot so marks strictly alternate; first failure at slot
    >= 1.
    """
    m = spec.num_gpus
    fail = np.zeros((horizon, m), dtype=bool)
    recover = np.zeros((horizon, m), dtype=bool)
    for g in range(m):
        mtbf, mttr = fault_model.rates_for(spec.model_of(g).name)
        t = 0.0
        down = False
        while True:
            t += max(1.0, float(np.ceil(rng.exponential(mttr if down else mtbf))))
            if t >= horizon:
                break
            (recover if down else fail)[int(t), g] = True
            down = not down
    return fail, recover


def _run_steady_faulted(scheduler: Scheduler, cfg: SimConfig, seed: int) -> SimResult:
    """Steady-queued loop under GPU failures (protocol ``steady-faulted``).

    Every slot, after releases: recover lanes come back up, then failing
    GPUs evict their running workloads (each re-queued with ``tries=1``
    and an exponential-backoff ready slot while the retry budget and the
    queue's capacity allow — otherwise a final loss) and stay masked out
    of placement until recovery.  Queue entries past the patience budget
    re-arm with doubled backoff while ``tries < max_retries`` and the
    lease allows, else drop.  The fault schedule is drawn from its own
    seeded stream so the arrival process is identical to the queued
    protocol's at the same seed.
    """
    if cfg.fault_model is None:
        raise ValueError(
            "protocol 'steady-faulted' needs SimConfig.fault_model "
            "(a repro_torch.core.mig.FaultModel describing MTBF/MTTR)"
        )
    fm = cfg.fault_model
    rng = np.random.default_rng(seed)
    scheduler.reset()
    spec = cfg.spec()
    cap = spec.total_mem_slices
    probs = request_probs(cfg)
    T, warm, meas, rate = steady_params(cfg)
    order = queue_order(scheduler.spec) if hasattr(scheduler, "spec") else DEFAULT_QUEUE_ORDER
    horizon = warm + meas
    fail_marks, rec_marks = _fault_schedule(
        spec, fm, horizon, np.random.default_rng(seed + 77003)
    )

    cluster = mig.ClusterState(spec=spec)
    expiry: List = []
    queue: List[Dict] = []
    running: Dict[int, Dict] = {}  # wid -> entry, for eviction bookkeeping
    wid = 0
    arr = acc = 0
    rejects = np.zeros(mig.NUM_PROFILES)
    arrivals = np.zeros(mig.NUM_PROFILES)
    util_s = gpus_s = frag_s = 0.0
    nsamp = 0
    waits: List[float] = []
    queue_admits = 0
    tenant_arr = np.zeros(cfg.num_tenants)
    tenant_acc = np.zeros(cfg.num_tenants)
    n_evict = recovered = lost_meas = 0
    ttrs: List[float] = []

    def reject(entry):
        # evicted entries were already counted as accepted arrivals — their
        # failure to re-admit is a goodput loss, not a (second) reject
        if entry["measuring"] and not entry.get("counted"):
            rejects[entry["pid"]] += 1

    def final_loss(entry):
        # an eviction that will never re-admit: the workload was counted
        # as accepted but its lease did not complete — goodput loss
        nonlocal lost_meas
        if entry["measuring"] and entry.get("counted"):
            lost_meas += 1

    def dispatch(entry, sel, t):
        nonlocal acc, queue_admits, recovered
        cluster.allocate(entry["wid"], entry["pid"], *sel)
        heapq.heappush(expiry, (entry["end"], entry["wid"]))
        running[entry["wid"]] = entry
        evicted_at = entry.pop("evicted_at", None)
        if evicted_at is not None:
            recovered += 1
            ttrs.append(float(t - evicted_at))
        if entry["measuring"] and not entry.get("counted"):
            acc += 1
            tenant_acc[entry["tenant"]] += 1
            waits.append(float(t - entry["arr0"]))
            if t > entry["arr0"]:
                queue_admits += 1
        entry["counted"] = True

    for t in range(horizon):
        while expiry and expiry[0][0] <= t:
            _, w = heapq.heappop(expiry)
            if w in running:  # evicted leases stay in the heap; skip them
                cluster.release(w)
                del running[w]
        for g in np.flatnonzero(rec_marks[t]):
            cluster.recover_gpu(int(g))
        for g in np.flatnonzero(fail_marks[t]):
            for w in cluster.fail_gpu(int(g)):
                entry = running.pop(w)
                n_evict += 1
                if fm.max_retries >= 1 and len(queue) < cfg.wait_capacity:
                    entry["arr"] = t
                    entry["tries"] = 1
                    entry["rdy"] = t + fm.backoff(1)
                    entry["evicted_at"] = t
                    queue.append(entry)
                else:
                    final_loss(entry)
        # prune / re-arm, then drain ready entries in queue order until
        # the head no longer fits
        kept: List[Dict] = []
        for entry in queue:
            if t - entry["arr"] > cfg.wait_patience:
                if entry.get("tries", 0) < fm.max_retries and entry["end"] > t:
                    entry["arr"] = t
                    entry["tries"] = entry.get("tries", 0) + 1
                    entry["rdy"] = t + fm.backoff(entry["tries"])
                    kept.append(entry)
                else:
                    reject(entry)
                    final_loss(entry)
            elif entry["end"] <= t:
                reject(entry)
                final_loss(entry)
            else:
                kept.append(entry)
        queue = kept
        queue.sort(key=_queue_sort_key(order, t))
        while True:
            ready = [e for e in queue if e.get("rdy", 0) <= t]
            if not ready:
                break
            sel = scheduler.select(cluster, ready[0]["pid"])
            if sel is None:
                break
            queue.remove(ready[0])
            dispatch(ready[0], sel, t)
        for _ in range(rng.poisson(rate)):
            pid = int(distributions.sample_profile_probs(probs, 1, rng)[0])
            tenant = int(rng.integers(0, max(1, cfg.num_tenants)))
            prio = int(rng.integers(0, max(1, cfg.num_priorities)))
            measuring = t >= warm
            if measuring:
                arr += 1
                arrivals[pid] += 1
                tenant_arr[tenant] += 1
            entry = {
                "wid": wid, "pid": pid, "tenant": tenant, "prio": prio,
                "arr": t, "arr0": t, "end": t + int(rng.integers(1, T + 1)),
                "measuring": measuring, "seq": wid, "tries": 0, "rdy": t,
            }
            sel = scheduler.select(cluster, pid)
            if sel is not None:
                dispatch(entry, sel, t)
            elif cfg.wait_patience > 0 and len(queue) < cfg.wait_capacity:
                queue.append(entry)
            else:
                reject(entry)
            wid += 1
        if t >= warm and (t - warm) % SAMPLE_EVERY == 0:
            util_s += cluster.used_mem_slices / cap
            gpus_s += cluster.active_gpus
            frag_s += fragmentation.cluster_fragmentation(
                cluster.occupancy_matrix(), cfg.metric, spec=spec
            )
            nsamp += 1

    for entry in queue:  # still waiting at horizon end
        reject(entry)
        if entry.get("evicted_at") is not None:
            final_loss(entry)

    rates = [tenant_acc[k] / tenant_arr[k] for k in range(cfg.num_tenants) if tenant_arr[k] > 0]
    return SimResult(
        acceptance_rate=acc / max(arr, 1),
        allocated_workloads=float(acc),
        active_gpus=gpus_s / max(nsamp, 1),
        utilization=util_s / max(nsamp, 1),
        frag_severity=frag_s / max(nsamp, 1),
        rejects_by_profile=rejects,
        arrivals_by_profile=arrivals,
        wait_p50=float(np.percentile(waits, 50)) if waits else 0.0,
        wait_p99=float(np.percentile(waits, 99)) if waits else 0.0,
        fairness=jain_fairness(rates),
        queue_admits=float(queue_admits),
        goodput=(acc - lost_meas) / max(arr, 1),
        evictions=float(n_evict),
        recovered_fraction=(recovered / n_evict) if n_evict else 1.0,
        ttr_p50=float(np.percentile(ttrs, 50)) if ttrs else 0.0,
        ttr_p99=float(np.percentile(ttrs, 99)) if ttrs else 0.0,
    )


def _run_cumulative(scheduler: Scheduler, cfg: SimConfig, seed: int) -> SimResult:
    rng = np.random.default_rng(seed)
    scheduler.reset()
    spec = cfg.spec()
    cap = spec.total_mem_slices
    probs = request_probs(cfg)
    mean_mem = distributions.mean_mem_from_probs(probs)
    T = int(np.ceil(cap / mean_mem))
    n = int(np.ceil(cfg.max_demand * cap / mean_mem)) + 20

    profiles = distributions.sample_profile_probs(probs, n, rng)
    durations = rng.integers(1, T + 1, size=n)

    cluster = mig.ClusterState(spec=spec)
    expiry: List = []
    grid = np.asarray(cfg.demand_grid, dtype=np.float64)
    G = len(grid)
    traces = {
        k: np.zeros(G)
        for k in ("acceptance_rate", "allocated_workloads", "active_gpus", "utilization", "frag_severity")
    }
    gi = 0
    arr = acc = 0
    cum = 0.0
    rejects = np.zeros(mig.NUM_PROFILES)
    arrivals = np.zeros(mig.NUM_PROFILES)

    for w in range(n):
        t = w
        while expiry and expiry[0][0] <= t:
            _, wid = heapq.heappop(expiry)
            cluster.release(wid)
        pid = int(profiles[w])
        arr += 1
        arrivals[pid] += 1
        cum += mig.PROFILE_MEM[pid]
        sel = scheduler.select(cluster, pid)
        if sel is not None:
            mig_req = getattr(scheduler, "pending_migration", None)
            if mig_req is not None:  # mfi-defrag: move the victim first
                _apply_migration(cluster, mig_req)
            cluster.allocate(w, pid, *sel)
            heapq.heappush(expiry, (t + int(durations[w]), w))
            acc += 1
        else:
            rejects[pid] += 1
        frac = cum / cap
        while gi < G and frac >= grid[gi]:
            traces["acceptance_rate"][gi] = acc / arr
            traces["allocated_workloads"][gi] = acc
            traces["active_gpus"][gi] = cluster.active_gpus
            traces["utilization"][gi] = cluster.used_mem_slices / cap
            traces["frag_severity"][gi] = fragmentation.cluster_fragmentation(
                cluster.occupancy_matrix(), cfg.metric, spec=spec
            )
            gi += 1
        if frac >= cfg.max_demand and gi >= G:
            break

    for k, v in traces.items():
        for i in range(gi, G):
            v[i] = v[gi - 1] if gi > 0 else 0.0

    return SimResult(
        acceptance_rate=acc / max(arr, 1),
        allocated_workloads=float(acc),
        active_gpus=float(cluster.active_gpus),
        utilization=cluster.used_mem_slices / cap,
        frag_severity=fragmentation.cluster_fragmentation(
            cluster.occupancy_matrix(), cfg.metric, spec=spec
        ),
        rejects_by_profile=rejects,
        arrivals_by_profile=arrivals,
        demand_grid=grid,
        traces=traces,
    )


def run_many(scheduler_name: PolicyLike, cfg: SimConfig, runs: int = 100) -> Dict[str, float]:
    """Average ``runs`` independent simulations (paper uses 500).

    ``scheduler_name`` is any registered policy name or an ad-hoc
    :class:`~repro_torch.core.policy.PolicySpec`; each run compiles a fresh host
    scheduler through the registry (stateful cursors start at 0).
    """
    keys = ("acceptance_rate", "allocated_workloads", "active_gpus", "utilization", "frag_severity")
    if cfg.protocol == "steady-queued":
        keys = keys + ("wait_p50", "wait_p99", "fairness", "queue_admits")
    elif cfg.protocol == "steady-faulted":
        keys = keys + (
            "wait_p50", "wait_p99", "fairness", "queue_admits",
            "goodput", "evictions", "recovered_fraction", "ttr_p50", "ttr_p99",
        )
    acc = {k: 0.0 for k in keys}
    rej = np.zeros(mig.NUM_PROFILES)
    arrp = np.zeros(mig.NUM_PROFILES)
    traces_acc = None
    for r in range(runs):
        sched = make_scheduler(scheduler_name, cfg.metric)
        res = run_simulation(sched, cfg, seed=cfg.seed + r * 9973)
        for k in keys:
            acc[k] += getattr(res, k)
        rej += res.rejects_by_profile
        arrp += res.arrivals_by_profile
        if res.traces is not None:
            if traces_acc is None:
                traces_acc = {k: v.copy() for k, v in res.traces.items()}
            else:
                for k in res.traces:
                    traces_acc[k] += res.traces[k]
    out = {k: v / runs for k, v in acc.items()}
    out["rejects_by_profile"] = rej / runs
    out["arrivals_by_profile"] = arrp / runs
    if traces_acc is not None:
        out["traces"] = {k: v / runs for k, v in traces_acc.items()}
        out["demand_grid"] = np.asarray(cfg.demand_grid)
    return out
