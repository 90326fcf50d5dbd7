"""The multi-tenant queued protocol (``steady-queued``) as the program
runs it: the steady stream plus a tenant and a priority per arrival, the
wait ring's arguments, and the waiting requests read from its state."""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.protocols import steady as _steady

QUEUED = True


program_spec = _steady.program_spec


def make_stream(cell, seed: int, device):
    return _steady.make_stream(cell, seed, device, queued=QUEUED)


def engine_kwargs(cell) -> dict:
    proto = cell.config["protocol"]
    return dict(protocol=cell.protocol, wait_slots=int(proto["wait_slots"]),
                wait_patience=int(proto["wait_patience"]))


def port_state(carry, replicas: np.ndarray):
    import torch

    out = _steady.port_state(carry, replicas)
    idx = torch.as_tensor(replicas, device=carry.free.device)
    pid = carry.wait_pid[idx].cpu().numpy()
    eidx = carry.wait_eidx[idx].cpu().numpy()
    for i, st in enumerate(out):
        st["waiting"] = sorted(int(x) for x in eidx[i][pid[i] >= 0])
    return out


def port_lanes(carry):
    """Every replica's state, and its waiting requests' event indexes
    ``(R, W)`` sorted, -1 last."""
    import torch

    out = _steady.port_lanes(carry)
    top = torch.iinfo(torch.int32).max
    w = torch.where(carry.wait_pid >= 0, carry.wait_eidx, top).sort(dim=1).values
    out["waiting"] = torch.where(w == top, -1, w).to(torch.int32)
    return out


def port_aggregate(cols: Dict[str, np.ndarray], trace: Dict[str, np.ndarray], cell) -> dict:
    from repro_torch.sim import batched

    events = batched.EventStream(**{k: cols.get(k) for k in batched.EventStream._fields})
    tr = batched.EventTrace(**{k: trace.get(k) for k in batched.EventTrace._fields})
    return batched._aggregate_queued(events, tr, _steady.program_spec(cell), cols["pid"].shape[1])
