#!/usr/bin/env python3
"""The control of ``correct``: the reference put in the program's place
with one stated guarantee broken, which the comparison has to fail.

The broken guarantee is the tie-break: the configuration states that a
request goes to the least ``(ΔF, gpu, anchor)``; the control places it
at the LAST minimum, the highest ``(gpu, anchor)`` among equal ΔF, as a
reduction that keeps any minimum would (an unordered argmin is the step
a faster select kernel would tempt).  Everything else is the reference.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

makes each seed's stream as a run does (on the card when there is one),
replays the checked replicas (NumPy) and every lane (``reference/lanes.py``
with ``last_tie``) over one whole pass with the control, and prints the
numbers the comparison reads, one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (HERE.parent, HERE.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402

from portbench import cell as cellmod, check  # noqa: E402
from portbench.reference.common import BIG, Rules  # noqa: E402


class LastTieRules(Rules):
    """MFI that keeps the last of equal minima."""

    def select(self, bits, pid):
        d = self.delta(bits, pid).reshape(-1)
        k = d.shape[0] - 1 - int(np.argmin(d[::-1]))
        g, j = divmod(k, self.windows[pid].shape[0])
        if d[k] >= BIG:
            return None
        return g, j, int(d[k])


class _AsProgram:
    """The control's own aggregate stands where the program's would."""

    def __init__(self, ref):
        self.ref = ref

    def port_aggregate(self, cols, trace, cell):
        return self.ref.aggregate(cols, trace, cell)


def lane_trace(cell, fields, rows: int, ring, device) -> dict:
    """The control over every lane: the all-lane replay keeping the last
    of equal minima (and making no migration), its ``(rows, R)`` trace."""
    import torch

    from portbench.reference.lanes import Replay

    rp = Replay(cell, fields, rows, ring, device, last_tie=True)
    out = {}
    for e in range(rows):
        for name, v in rp.step(None).items():
            out.setdefault(name, []).append(v)
    return {name: torch.stack(v).cpu().numpy() for name, v in out.items()}


def readings(cell, fields, replicas, rows: int, ring=None, device=None) -> dict:
    """Replay the checked replicas' first ``rows`` events with the control
    and compare them with the reference as a run's window is compared;
    with ``ring`` and ``device``, every lane too."""
    ref = cell.module("reference")
    broken = cellmod.Cell(**{**cell.__dict__, "rules": LastTieRules(cell.fleet, cell.config["metric"])})
    have = {}
    states = []
    for i, r in enumerate(replicas):
        cols = {k: a[:, r] for k, a in fields.items() if a is not None}
        tr, state = ref.run(cols, rows, broken, snapshot_at=rows)
        for name, a in tr.items():
            have.setdefault(name, np.zeros((rows, len(replicas)), a.dtype))[:, i] = a
        bits = state["bits"]
        states.append(dict(state, f=cell.rules.F[bits].astype(np.float32),
                           free=(cell.fleet.slices - cell.rules.popcount[bits]).astype(np.int32)))
    window = None
    if ring is not None:
        window = dict(calls=[(0, rows, lane_trace(cell, fields, rows, ring, device))],
                      ring=ring, device=device)
    return check.compare(cell, fields, replicas, [have], [rows], states, rows, _AsProgram(ref),
                         window=window)


def main(argv=None, overrides=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = cellmod.load(args.workload, overrides)
    import torch

    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    from portbench.run import CHECKED, _checked_replicas

    proto = cell.module("protocols")
    for seed in args.seeds:
        st = proto.make_stream(cell, seed, torch.device(device))
        replicas = _checked_replicas(seed, st.n_events, CHECKED)
        out = readings(cell, st.fields, replicas, st.shape[0], (st.ring_rows, st.ring_cols),
                       torch.device(device))
        print(json.dumps(dict(workload=cell.name, seed=seed, device=device,
                              correct=out["correct"], rows=out["rows"],
                              checks={k: v["value"] for k, v in out["checks"].items()})))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
