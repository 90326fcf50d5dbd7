"""Reference of the multi-tenant queued protocol (``steady-queued``) under
``mfi``, one replica at a time, in plain NumPy.

The steady protocol with a bounded wait queue in front.  At every live
event, after the slot's releases and before the arrival: drop waiting
requests whose lease deadline has passed (``end <= t``) or that waited
longer than the patience budget, then try to place ONE request, the head:
the least ``(priority, arrival slot, event index)`` (the lowest priority
value first, then the longest wait, then arrival order).  A placed head
keeps its original deadline.  Then the arrival is placed by MFI; a
dropped arrival joins the queue if it has room.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from portbench.reference import common, steady as _steady
from portbench.reference.common import Replica, Rules, Running, decode_slots
from portbench.reference.lanes import compare as compare_lanes  # noqa: F401  (every lane)

QUEUE_FIELDS = dict(parked=bool, wadm_eidx=np.int32, wadm_gpu=np.int32,
                    wadm_aidx=np.int32)


def replay(events: Dict[str, np.ndarray], rows: int, rules: Rules, capacity: int,
           patience: int, snapshot_at: Optional[int] = None):
    """Replay one replica's queued stream columns for its first ``rows``
    events.  Returns ``(trace, state)``: the trace fields ``(rows,)`` and,
    at event ``snapshot_at``, ``(patterns (M,), sorted event indexes of
    the waiting requests)``."""
    fleet = rules.fleet
    rep = Replica(rules)
    pid, new_slot, wlive = events["pid"], events["new_slot"], events["wlive"]
    end, prio = events["end"], events["prio"]
    slot = decode_slots(new_slot)
    out = _steady.empty_trace(rows, defrag=False)
    out.update({name: np.zeros(rows, dt) for name, dt in QUEUE_FIELDS.items()})
    for name in ("wadm_eidx", "wadm_gpu", "wadm_aidx"):
        out[name][:] = -1
    waiting = []  # (prio, arrival slot, eidx, pid, end)
    state = None
    for e in range(rows):
        if e == snapshot_at:
            state = dict(bits=rep.bits.copy(), waiting=sorted(w[2] for w in waiting))
        t = int(slot[e])
        out["free_sum"][e], out["active"][e], out["frag"][e] = rep.measure()
        if new_slot[e]:
            rep.release_until(t)
        if wlive[e]:
            waiting = [w for w in waiting if w[4] > t and t - w[1] <= patience]
            if waiting:
                head = min(waiting)
                sel = rules.select(rep.bits, head[3])
                if sel is not None:
                    g, j, _ = sel
                    waiting.remove(head)
                    rep.place(Running(head[4], g, fleet.anchors[head[3]][j], head[3], head[2]))
                    out["wadm_eidx"][e], out["wadm_gpu"][e], out["wadm_aidx"][e] = head[2], g, j
        p = int(pid[e])
        if p < 0:
            continue
        sel = rules.select(rep.bits, p)
        if sel is not None:
            g, j, _ = sel
            rep.place(Running(int(end[e]), g, fleet.anchors[p][j], p, e))
            out["ok"][e], out["gpu"][e], out["aidx"][e] = True, g, j
        elif wlive[e] and len(waiting) < capacity:
            waiting.append((int(prio[e]), t, e, p, int(end[e])))
            out["parked"][e] = True
    if snapshot_at == rows:
        state = dict(bits=rep.bits.copy(), waiting=sorted(w[2] for w in waiting))
    return out, state


def run(cols: Dict[str, np.ndarray], rows: int, cell, snapshot_at: int):
    """:func:`replay` with the cell's rules and wait queue."""
    proto = cell.config["protocol"]
    return replay(cols, rows, cell.rules, int(proto["wait_slots"]),
                  int(proto["wait_patience"]), snapshot_at)


def jain(values) -> float:
    """Jain's index (Σx)² / (n·Σx²) of per-tenant acceptance; 1 when empty
    or all zero."""
    x = np.asarray(list(values), dtype=np.float64)
    sq = float(np.square(x).sum()) if x.size else 0.0
    if sq == 0.0:
        return 1.0
    s = float(x.sum())
    return s * s / (x.size * sq)


def aggregate(cols: Dict[str, np.ndarray], trace: Dict[str, np.ndarray], cell) -> dict:
    """The queued figures of the checked replicas' ``(E, Q)`` rows: an
    arrival counts as accepted when placed at once or admitted later from
    the queue; its wait is the slots between the two events; the median
    and 99th percentile of the waits, Jain's index over the tenants'
    acceptance, and the admissions from the queue."""
    ok, wadm = trace["ok"], trace["wadm_eidx"]
    slot, tenant, meas = cols["slot"], cols["tenant"], cols["measuring"]
    runs = ok.shape[1]
    late = np.zeros_like(ok)
    wait = np.zeros(ok.shape, np.float64)
    for r in range(runs):
        at = np.flatnonzero(wadm[:, r] >= 0)
        orig = wadm[at, r]
        late[orig, r] = True
        wait[orig, r] = slot[at, r] - slot[orig, r]
    accepted_any = ok | late
    out = common.aggregate(meas, cols["sample"], cols["pid"], accepted_any,
                           trace["free_sum"], trace["active"], trace["frag"],
                           cell.fleet.capacity, cell.fleet.classes)
    p50, p99, fair = np.zeros(runs), np.zeros(runs), np.zeros(runs)
    for r in range(runs):
        w = wait[:, r][accepted_any[:, r] & meas[:, r]]
        p50[r] = np.percentile(w, 50) if len(w) else 0.0
        p99[r] = np.percentile(w, 99) if len(w) else 0.0
        m = meas[:, r]
        fair[r] = jain(
            (accepted_any[:, r] & m & (tenant[:, r] == tn)).sum() / (m & (tenant[:, r] == tn)).sum()
            for tn in np.unique(tenant[:, r][m]))
    out.update(wait_p50=float(p50.mean()), wait_p99=float(p99.mean()),
               fairness=float(fair.mean()),
               queue_admits=float((late & meas).sum(axis=0).mean()))
    return out
