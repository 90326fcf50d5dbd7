"""Reference of the steady (accept-or-drop) protocol under ``mfi`` and
``mfi-defrag``, one replica at a time, in plain NumPy.

Per event, in the paper's order: measure the cluster at the slot boundary
(before the drain), release the leases that end at this slot (first event
of a slot only), place the arrival by MFI or drop it.  Under ``mfi-defrag``
a dropped arrival may instead move ONE running workload: every running
workload is tried as the victim; the request takes the victim's freed
room by MFI, the victim is re-placed by MFI on the cluster that now holds
the request, and the candidate of least ``(total F after, victim gpu,
victim anchor)`` wins.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from portbench.reference import common
from portbench.reference.common import BIG, Replica, Rules, Running, decode_slots
from portbench.reference.lanes import compare as compare_lanes  # noqa: F401  (every lane)

#: trace fields this protocol yields, with their dtypes
FIELDS = dict(ok=bool, gpu=np.int32, aidx=np.int32, free_sum=np.int32,
              active=np.int32, frag=np.float32)
DEFRAG_FIELDS = dict(mig=bool, mig_from_gpu=np.int32, mig_from_anchor=np.int32,
                     mig_to_gpu=np.int32, mig_to_anchor=np.int32)


def empty_trace(rows: int, defrag: bool) -> Dict[str, np.ndarray]:
    fields = dict(FIELDS, **(DEFRAG_FIELDS if defrag else {}))
    out = {name: np.zeros(rows, dt) for name, dt in fields.items()}
    for name in DEFRAG_FIELDS:
        if name in out and name != "mig":
            out[name][:] = -1
    return out


def migrate(rep: Replica, pid: int):
    """The single-migration search for a request of class ``pid`` that no
    GPU can take: ``(victim, (gpu, anchor idx), (new gpu, new anchor idx))``
    of the winning candidate, or ``None``."""
    rules, fleet = rep.rules, rep.rules.fleet
    victims = sorted(rep.running(), key=lambda w: (w.gpu, w.anchor))
    if not victims:
        return None
    g = np.array([w.gpu for w in victims])
    vpid = np.array([w.pid for w in victims])
    vwin = np.array([fleet.window(w.pid, w.anchor) for w in victims], np.int64)
    # the request can only fit where the victim left room: its own GPU
    freed = rep.bits[g] & ~vwin                                   # (V,)
    dreq = rules.delta(freed, pid)                                # (V, A)
    j = np.argmin(dreq, axis=1)
    fits = dreq[np.arange(len(victims)), j] < BIG
    placed = freed | rules.windows[pid][j]                        # victim's GPU after the request
    # re-place each victim by MFI on the cluster holding the request
    best_d = np.full(len(victims), BIG)
    best_g = np.zeros(len(victims), np.int64)
    best_j = np.zeros(len(victims), np.int64)
    for q in np.unique(vpid):
        sel = np.flatnonzero(vpid == q)
        rows = np.broadcast_to(rep.bits, (len(sel), fleet.num_gpus)).copy()
        rows[np.arange(len(sel)), g[sel]] = placed[sel]
        d = rules.delta(rows, q).reshape(len(sel), -1)            # (V_q, M·A)
        k = np.argmin(d, axis=1)                                  # least (ΔF, gpu, anchor)
        best_d[sel] = d[np.arange(len(sel)), k]
        best_g[sel], best_j[sel] = np.divmod(k, rules.windows[q].shape[0])
    ok = fits & (best_d < BIG)
    if not ok.any():
        return None
    f = rules.F
    total = f[rep.bits].sum() - f[rep.bits[g]] + f[placed] + best_d
    total = np.where(ok, total, BIG)
    v = int(np.argmin(total))  # victims are in (gpu, anchor) order
    return victims[v], (int(g[v]), int(j[v])), (int(best_g[v]), int(best_j[v]))


def replay(events: Dict[str, np.ndarray], rows: int, rules: Rules, defrag: bool,
           ring_k: int, snapshot_at: Optional[int] = None):
    """Replay one replica's stream columns (``events[name]`` of shape
    ``(E,)``) for its first ``rows`` events.  Returns ``(trace, state)``:
    the trace fields ``(rows,)`` and, at event ``snapshot_at``, the
    patterns ``bits (M,)``."""
    fleet = rules.fleet
    rep = Replica(rules)
    pid, exp_row, new_slot = events["pid"], events["exp_row"], events["new_slot"]
    slot = decode_slots(new_slot)
    out = empty_trace(rows, defrag)
    state = None
    for e in range(rows):
        if e == snapshot_at:
            state = dict(bits=rep.bits.copy())
        t = int(slot[e])
        out["free_sum"][e], out["active"][e], out["frag"][e] = rep.measure()
        if new_slot[e]:
            rep.release_until(t)
        p = int(pid[e])
        if p < 0:
            continue
        end = t + (int(exp_row[e]) - t) % ring_k   # the ring row is end mod (T + 1)
        sel = rules.select(rep.bits, p)
        if sel is None and defrag:
            found = migrate(rep, p)
            if found is not None:
                w, (g, j), (ng, nj) = found
                rep.by_end[w.end].remove(w)
                rep.bits[w.gpu] &= ~fleet.window(w.pid, w.anchor)
                new_anchor = fleet.anchors[w.pid][nj]
                rep.place(Running(w.end, ng, new_anchor, w.pid, w.eidx))
                out["mig"][e] = True
                out["mig_from_gpu"][e], out["mig_from_anchor"][e] = w.gpu, w.anchor
                out["mig_to_gpu"][e], out["mig_to_anchor"][e] = ng, new_anchor
                sel = (g, j, 0)
        if sel is None:
            continue
        g, j, _ = sel
        rep.place(Running(end, g, fleet.anchors[p][j], p, e))
        out["ok"][e], out["gpu"][e], out["aidx"][e] = True, g, j
    if snapshot_at == rows:
        state = dict(bits=rep.bits.copy())
    return out, state


def run(cols: Dict[str, np.ndarray], rows: int, cell, snapshot_at: int):
    """:func:`replay` with the cell's rules, scheduler and ring."""
    return replay(cols, rows, cell.rules, cell.defrag, cell.T + 1, snapshot_at)


def aggregate(cols: Dict[str, np.ndarray], trace: Dict[str, np.ndarray], cell) -> dict:
    """The paper's figures of the checked replicas' ``(E, Q)`` rows."""
    return common.aggregate(cols["measuring"], cols["sample"], cols["pid"], trace["ok"],
                            trace["free_sum"], trace["active"], trace["frag"],
                            cell.fleet.capacity, cell.fleet.classes)
