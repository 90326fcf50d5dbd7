"""The steady (accept-or-drop) protocol as the program runs it: the
stream the cell's mix draws, the engine's arguments, and the program's
state and aggregate read for the check."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench import stream as _stream

QUEUED = False


def make_stream(cell, seed: int, device, queued: bool = QUEUED) -> _stream.Stream:
    """The cell's stream from ``seed``; ``queued`` adds tenants and priorities."""
    mix, proto = cell.mix, cell.config["protocol"]
    return _stream.generate(
        replicas=int(mix["replicas"]), probs=mix["class_shares"], T=cell.T,
        warm=cell.warm, meas=cell.meas, rate=cell.rate,
        sample_every=int(proto["sample_every"]), seed=seed, device=device,
        queued=queued, tenants=int(proto.get("tenants", 1)),
        priorities=int(proto.get("priorities", 1)), ring_cols=int(mix["ring_cols"]))


def program_spec(cell):
    """The program's fleet: the configuration's device model, as many as
    it states, from the program's own placement tables."""
    from repro_torch.core import mig

    fleet = cell.config["fleet"]
    return mig.ClusterSpec.homogeneous(mig.DEVICE_MODELS[fleet["model"]], int(fleet["gpus"]))


def engine_kwargs(cell) -> dict:
    """Keyword arguments of ``simulate_chunked`` and ``init_carry`` that the
    protocol sets."""
    return dict(protocol=cell.protocol, wait_slots=0, wait_patience=0)


def port_state(carry, replicas: np.ndarray) -> List[Dict[str, np.ndarray]]:
    """The program's state of each checked replica: occupancy patterns
    (from the occupancy planes), F and free slices per GPU."""
    import torch

    idx = torch.as_tensor(replicas, device=carry.free.device)
    occ = carry.occ[idx].cpu().numpy().astype(np.int64)           # (Q, M, S)
    bits = (occ << np.arange(occ.shape[-1])).sum(axis=-1)
    f = carry.f[idx].cpu().numpy()
    free = carry.free[idx].cpu().numpy()
    return [dict(bits=bits[i], f=f[i], free=free[i]) for i in range(len(replicas))]


def port_lanes(carry) -> Dict[str, object]:
    """The program's state of every replica, on its device, copied out of
    the carry: patterns ``(R, M)`` from the occupancy planes, F and free
    slices per GPU."""
    import torch

    s = carry.occ.shape[-1]
    weight = torch.ones((), dtype=torch.int32, device=carry.occ.device) << torch.arange(
        s, dtype=torch.int32, device=carry.occ.device)
    bits = (carry.occ.to(torch.int32) * weight).sum(dim=-1, dtype=torch.int32)
    return dict(bits=bits, f=carry.f.clone(), free=carry.free.clone())


def port_aggregate(cols: Dict[str, np.ndarray], trace: Dict[str, np.ndarray], cell) -> dict:
    """The program's own aggregate of the checked replicas' rows."""
    from repro_torch.sim import batched

    events = batched.EventStream(**{k: cols.get(k) for k in batched.EventStream._fields})
    tr = batched.EventTrace(**{k: trace.get(k) for k in batched.EventTrace._fields})
    return batched.aggregate(events, tr, program_spec(cell), cols["pid"].shape[1])
