"""The benchmark's event-stream generator: one law for every mix file.

The law is the paper's steady protocol (arXiv:2511.18906 §V): in each of
``warm + meas`` slots a Poisson number of arrivals at the mix's offered
load; each arrival draws its demand class from the mix's shares and a
duration uniform on ``[1, T]`` slots.  The stream has one event per
arrival, one heartbeat per slot that has none (so consecutive events
never skip a slot) and a trailing sentinel that closes the last slot; it
is right-padded to the longest replica with no-op lanes.  The format is
the one :func:`repro_torch.sim.batched.simulate_chunked` consumes: every
field ``(E, R)``, C-contiguous, in numpy on the host.

Every draw is made on ``device`` from a ``torch.Generator`` seeded with
the run's seed, in a few whole-array calls; the same seed on the same
device gives the same stream.  The queued protocol adds a tenant and a
priority per arrival, drawn uniformly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Stream:
    """A generated stream: ``fields`` as the engine takes them (``(E, R)``
    numpy each, ``None`` where the protocol has no such field), the ring's
    geometry and each replica's number of events before its sentinel."""

    fields: Dict[str, Optional[np.ndarray]]
    ring_rows: int
    ring_cols: int
    n_events: np.ndarray  # (R,)

    @property
    def shape(self):
        return self.fields["pid"].shape


def generate(*, replicas: int, probs, T: int, warm: int, meas: int, rate: float,
             sample_every: int, seed: int, device, queued: bool = False,
             tenants: int = 1, priorities: int = 1, ring_cols: int = 1) -> Stream:
    """Draw a stream of ``replicas`` replicas; the figures are sampled at
    every ``sample_every``-th slot boundary of the measurement window.
    ``ring_cols`` is the least width of the expiry ring: the stream widens
    it when more leases of one replica end in one slot."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    r, slots = replicas, warm + meas
    ring_k = T + 1  # leases end in (t, t + T]: one ring revolution
    i64 = dict(dtype=torch.int64, device=dev)

    counts = torch.poisson(torch.full((r, slots), float(rate), dtype=torch.float64,
                                      device=dev), generator=g).to(torch.int64)
    per_slot = counts.clamp(min=1)                       # a heartbeat where none arrive
    n_events = per_slot.sum(dim=1)                       # (R,)
    e_max = int(n_events.max()) + 1                      # + the trailing sentinel
    starts = torch.cumsum(per_slot, dim=1) - per_slot    # (R, slots): first lane of each slot

    lane = torch.arange(e_max, **i64).expand(r, -1)
    mark = torch.zeros((r, e_max + 1), **i64)
    mark.scatter_(1, starts, 1)
    slot = torch.cumsum(mark[:, :e_max], dim=1) - 1     # (R, E): the lane's slot
    real = lane < n_events[:, None]
    slot = torch.where(real, slot, slots)
    slot_c = slot.clamp(max=slots - 1)
    within = lane - torch.gather(starts, 1, slot_c)
    arrival = real & (within < torch.gather(counts, 1, slot_c))
    new_slot = (real & (within == 0)) | (lane == n_events[:, None])

    cum = torch.tensor(np.cumsum(np.asarray(probs, np.float64)), dtype=torch.float64, device=dev)
    u = torch.rand((r, e_max), generator=g, dtype=torch.float64, device=dev)
    pid = torch.searchsorted(cum, u, right=True).clamp(max=cum.shape[0] - 1)
    pid = torch.where(arrival, pid, -1)
    dur = torch.randint(1, T + 1, (r, e_max), generator=g, **i64)
    end = torch.where(arrival, slot + dur, 0)

    # the ring's column: rank among the replica's earlier arrivals that end
    # in the same slot (so no two live leases share a ring cell)
    span = slots + T + 1
    key = torch.where(arrival, torch.arange(r, **i64)[:, None] * span + end, -1 - lane)
    flat = key.reshape(-1)
    sk, order = torch.sort(flat, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    pos = torch.arange(sk.shape[0], **i64)
    rank_sorted = pos - torch.cummax(torch.where(first, pos, 0), dim=0).values
    col = torch.empty_like(rank_sorted)
    col[order] = rank_sorted
    col = torch.where(arrival, col.view(r, e_max), 0)
    del key, flat, sk, order, first, pos, rank_sorted
    cols = max(int(ring_cols), int(col.max()) + 1)

    exp_row = torch.where(arrival, end % ring_k, ring_k + 1)   # ring_k + 1: the trash row
    prev = slot - 1
    sample = new_slot & (prev >= warm) & ((prev - warm) % sample_every == 0)
    fields = dict(
        pid=pid, exp_row=exp_row, exp_col=col, drain_row=slot % ring_k,
        new_slot=new_slot, sample=sample, measuring=arrival & (slot >= warm),
    )
    if queued:
        fields.update(
            slot=slot, end=end,
            prio=torch.where(arrival, torch.randint(0, priorities, (r, e_max), generator=g, **i64), 0),
            tenant=torch.where(arrival, torch.randint(0, tenants, (r, e_max), generator=g, **i64), 0),
            wlive=slot < slots,
        )
    host = {}
    for name, t in fields.items():
        t = t if t.dtype == torch.bool else t.to(torch.int32)
        host[name] = t.t().contiguous().cpu().numpy()
    for name in ("slot", "end", "prio", "tenant", "wlive"):
        host.setdefault(name, None)
    return Stream(host, ring_rows=ring_k + 2, ring_cols=cols,
                  n_events=n_events.cpu().numpy())
