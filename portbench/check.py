"""What decides ``correct``: the window's output against the plain reference.

For the checked replicas, the reference (``reference/<protocol>.py``)
replays the same stream and the comparison counts

* ``trace_mismatch``: trace entries (every field the program returns for
  every event the window stepped, in every pass) that differ;
* ``state_mismatch``: entries of the carry the window left (occupancy,
  F and free slices per GPU; the waiting requests) that differ from the
  reference's state after the same events;
* ``aggregate_mismatch``: values of the program's own aggregate of the
  checked replicas' rows (``aggregate`` / ``_aggregate_queued``) that
  differ from the reference's figures;
* ``lane_mismatch``: entries of every trace field of EVERY replica the
  window stepped, and of the state it left, that differ from the plain
  PyTorch replay of all lanes (``reference/lanes.py``, where the
  protocol's reference gives ``compare_lanes``).

Every quantity is an integer, or a float worked out from integers by the
same operations, so each limit is 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

LIMITS = {"trace_mismatch": 0, "state_mismatch": 0, "aggregate_mismatch": 0,
          "lane_mismatch": 0}


def _diff(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int((a != b).sum())


def compare(cell, fields: Dict[str, np.ndarray], replicas: np.ndarray,
            got: List[Dict[str, np.ndarray]], covered: List[int],
            port_states: List[dict], last_hi: int, proto,
            window: Optional[dict] = None) -> dict:
    """``got``/``covered``: per pass, the checked replicas' ``(E, Q)`` rows
    and how many were stepped.  ``window`` (for ``lane_mismatch``): the
    window's ``calls`` (``(lo, hi, trace of all lanes)``), the stream's
    ``ring`` geometry, the ``device`` to replay on and the program's
    ``state`` of all lanes."""
    ref = cell.module("reference")
    rules = cell.rules
    h = max(covered)
    q = len(replicas)
    want: Dict[str, np.ndarray] = {}
    states = []
    for i, r in enumerate(replicas):
        cols = {k: a[:, r] for k, a in fields.items() if a is not None}
        tr, state = ref.run(cols, h, cell, snapshot_at=last_hi)
        for name, a in tr.items():
            want.setdefault(name, np.zeros((h, q), a.dtype))[:, i] = a
        states.append(state)

    trace_bad = 0
    bad_rows = 0
    row_masks = []
    for rows, have in zip(covered, got):
        row_bad = np.zeros((rows, q), bool)
        for name in set(want) | set(have):
            if name not in want or name not in have:
                trace_bad += rows * q
                row_bad[:] = True
                continue
            neq = have[name][:rows] != want[name][:rows]
            trace_bad += int(neq.sum())
            row_bad |= neq
        bad_rows += int(row_bad.sum())
        row_masks.append(row_bad)

    state_bad = 0
    s = rules.fleet.slices
    for have, exp in zip(port_states, states):
        bits = exp["bits"]
        state_bad += _diff(have["bits"], bits)
        state_bad += _diff(have["f"], rules.F[bits].astype(np.float32))
        state_bad += _diff(have["free"], (s - rules.popcount[bits]).astype(np.int32))
        if "waiting" in exp or "waiting" in have:
            a, b = set(have.get("waiting", ())), set(exp.get("waiting", ()))
            state_bad += len(a ^ b)

    best = int(np.argmax(covered))
    cols = {k: a[:h][:, replicas] for k, a in fields.items() if a is not None}
    port_agg = proto.port_aggregate(cols, {k: a[:h] for k, a in got[best].items()}, cell)
    ref_agg = ref.aggregate(cols, {k: a[:h] for k, a in want.items()}, cell)
    agg_bad = sum(_diff(port_agg[k], ref_agg[k]) if k in port_agg else 1 for k in ref_agg)
    agg_bad += sum(1 for k in port_agg if k not in ref_agg)

    values = {"trace_mismatch": trace_bad, "state_mismatch": state_bad,
              "aggregate_mismatch": agg_bad}
    failed = bad_rows
    if window is not None and hasattr(ref, "compare_lanes"):
        lanes = ref.compare_lanes(cell, fields, window["ring"], window["calls"], replicas,
                                  window["device"], window.get("state"))
        values["lane_mismatch"] = lanes["trace_bad"] + lanes["state_bad"]
        # replica-events found wrong by either comparison, each once
        failed = lanes["bad_rows"] + sum(
            int((m_bad & ~mask[:rows]).sum())
            for m_bad, mask, rows in zip(row_masks, lanes["masks"], covered))
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
    rows = sum(covered) * q
    correct = rows > 0 and all(v <= LIMITS[k] for k, v in values.items())
    return dict(correct=bool(correct), failed_rows=failed, rows=rows, checks=checks)
