"""The reference over every replica the window stepped: the steady and
queued protocols under MFI, replayed for all R lanes at once in plain
PyTorch on the run's device, from the rules of ``common.py``.

Per event, as ``steady.py`` and ``steady-queued.py`` do it one replica at
a time: measure the cluster (free slices, active GPUs, float32 mean F),
release the ring row of leases that end at a new slot, then (queued, at a
live event) drop the waiting requests past their deadline or patience and
place the head, the least ``(priority, arrival slot, event index)``, by
MFI if it fits; then place the arrival at its least ``(ΔF, gpu, anchor)``,
or park it (queued) or drop it.  A lease sits in the ring cell that the
stream gives its arrival event (``exp_row``, ``exp_col``), and the state
is the replay's own, driven by its own decisions.

Under ``mfi-defrag`` the single-migration search is not replayed here: a
migration the program reports on an arrival that fits nowhere is taken as
given once it is legal (its victim runs where it says, the victim lands on
a free window of its own class, the arrival on a free window of the
victim's old GPU) and applied; which victim the search should have moved
is the checked replicas' comparison (``check.py``).

``last_tie`` keeps the LAST of equal minima instead, for the control.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

STEADY = ("ok", "gpu", "aidx", "free_sum", "active", "frag")
QUEUE = ("parked", "wadm_eidx", "wadm_gpu", "wadm_aidx")
MIG = ("mig", "mig_from_gpu", "mig_from_anchor", "mig_to_gpu", "mig_to_anchor")
BIG = torch.iinfo(torch.int32).max


class Tables:
    """The fleet's rules as device tables: F and the popcount per pattern,
    each class's windows by anchor index, anchor value to index."""

    def __init__(self, rules, device):
        fleet = rules.fleet
        p, s, m = fleet.classes, fleet.slices, fleet.num_gpus
        a = max(len(x) for x in fleet.anchors)
        win = np.zeros((p, a), np.int32)
        valid = np.zeros((p, a), bool)
        aidx = np.full((p, s), -1, np.int64)
        for q in range(p):
            for j, anchor in enumerate(fleet.anchors[q]):
                win[q, j], valid[q, j], aidx[q, anchor] = fleet.window(q, anchor), True, j
        low = np.array([(x & -x).bit_length() - 1 for x in range(1 << s)], np.int32)
        dev = torch.device(device)
        self.M, self.S, self.A = m, s, a
        self.F = torch.as_tensor(rules.F.astype(np.int32), device=dev)
        self.pop = torch.as_tensor(rules.popcount.astype(np.int32), device=dev)
        self.win = torch.as_tensor(win, device=dev)
        self.valid = torch.as_tensor(valid, device=dev)
        self.n_anchors = self.valid.sum(dim=1)
        self.aidx = torch.as_tensor(aidx, device=dev)
        self.low = torch.as_tensor(low, device=dev)
        self.off = int(rules.F.max())
        if (2 * self.off + 1) * m * a >= BIG:
            raise ValueError("the fleet is too large for int32 keys")
        self.order = torch.arange(m * a, dtype=torch.int32, device=dev).view(m, a)
        self.inv = torch.tensor(np.float32(1.0) / np.float32(m), device=dev)


def _at(a: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """``a[rows, lanes]`` of an ``(E, R)`` field."""
    return a[rows.long(), lanes]


class Replay:
    """The replay of one pass of the stream over all lanes.

    ``fields`` are the stream's ``(E, R)`` host arrays, of which the first
    ``rows`` are uploaded; ``ring`` is the stream's ``(ring_rows,
    ring_cols)``.  :meth:`step` replays the next event and returns the
    trace row it expects, ``(R,)`` per field."""

    def __init__(self, cell, fields: Dict[str, Optional[np.ndarray]], rows: int,
                 ring: Tuple[int, int], device, last_tie: bool = False):
        self.dev = torch.device(device)
        self.t = Tables(cell.rules, self.dev)
        self.queued = fields.get("wlive") is not None
        self.defrag = cell.defrag
        self.last_tie = last_tie
        proto = cell.config["protocol"]
        self.capacity = int(proto.get("wait_slots", 0))
        self.patience = int(proto.get("wait_patience", 0))
        names = ["pid", "exp_row", "exp_col", "drain_row", "new_slot"]
        if self.queued:
            names += ["end", "prio", "wlive"]
        self.s = {k: torch.from_numpy(np.ascontiguousarray(fields[k][:rows])).to(self.dev)
                  for k in names}
        self.slot = (torch.cumsum(self.s["new_slot"], dim=0, dtype=torch.int32) - 1)
        self.R = int(self.s["pid"].shape[1])
        self.ring_rows, self.ring_cols = ring
        self.lanes = torch.arange(self.R, device=self.dev)
        self.cols = torch.arange(self.ring_cols, device=self.dev)
        self.reset()

    def reset(self) -> None:
        """A fresh pass: an empty cluster, ring and queue."""
        r, m, cells = self.R, self.t.M, self.ring_rows * self.ring_cols
        self.e = 0
        self.bits = torch.zeros((r, m), dtype=torch.int32, device=self.dev)
        self.ring_gpu = torch.zeros((r, cells), dtype=torch.int32, device=self.dev)
        self.ring_win = torch.zeros((r, cells), dtype=torch.int32, device=self.dev)
        self.ring_pid = torch.zeros((r, cells), dtype=torch.int32, device=self.dev)
        self.wq = torch.full((r, max(self.capacity, 1)), -1, dtype=torch.int32, device=self.dev)

    # -- rules -------------------------------------------------------------
    def select(self, pid: torch.Tensor, want: torch.Tensor):
        """MFI for each lane's class ``pid`` (``want`` lanes only):
        ``(fits, gpu, anchor index)``, the least ``(ΔF, gpu, anchor)``."""
        t = self.t
        p = pid.clamp(min=0).long()
        w = t.win[p][:, None, :]                                   # (R, 1, A)
        b = self.bits[:, :, None]                                  # (R, M, 1)
        after = (b | w).reshape(-1)
        d = (t.F.index_select(0, after).view(self.R, t.M, t.A)
             - t.F.index_select(0, self.bits.reshape(-1)).view(self.R, t.M, 1))
        order = (t.M * t.A - 1) - t.order if self.last_tie else t.order
        key = (d + t.off) * (t.M * t.A) + order
        free = ((b & w) == 0) & t.valid[p][:, None, :]
        key = torch.where(free, key, BIG).view(self.R, -1)
        best, k = key.min(dim=1)
        fits = want & (best < BIG)
        return fits, (k // t.A).to(torch.int32), (k % t.A).to(torch.int32)

    def place(self, mask, eidx, pid, gpu, aidx) -> None:
        """Place the lanes' ``mask`` leases: class ``pid`` at ``(gpu, anchor
        index)``, in the ring cell of their arrival event ``eidx``."""
        t = self.t
        win = torch.where(mask, t.win[pid.clamp(min=0).long(), aidx.clamp(0, t.A - 1).long()], 0)
        self.bits.index_put_((self.lanes, gpu.clamp(0, t.M - 1).long()), win, accumulate=True)
        cell = (_at(self.s["exp_row"], eidx, self.lanes).long() * self.ring_cols
                + _at(self.s["exp_col"], eidx, self.lanes).long())[:, None]
        for ring, value in ((self.ring_win, win), (self.ring_gpu, gpu), (self.ring_pid, pid)):
            ring.scatter_(1, cell, torch.where(mask, value, ring.gather(1, cell)[:, 0])[:, None])

    # -- one event -----------------------------------------------------------
    def step(self, given: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Replay event ``self.e``; ``given`` is the program's trace row,
        read only for the migrations it reports."""
        t, s, e, lanes = self.t, self.s, self.e, self.lanes
        out = {}
        fb = t.F.index_select(0, self.bits.reshape(-1)).view(self.R, t.M)
        used = t.pop.index_select(0, self.bits.reshape(-1)).view(self.R, t.M)
        out["free_sum"] = (t.M * t.S - used.sum(dim=1)).to(torch.int32)
        out["active"] = (self.bits != 0).sum(dim=1).to(torch.int32)
        out["frag"] = fb.sum(dim=1).to(torch.float32) * t.inv

        new = s["new_slot"][e]
        cells = s["drain_row"][e].long()[:, None] * self.ring_cols + self.cols[None, :]
        win = self.ring_win.gather(1, cells)
        gone = torch.where(new[:, None], win, 0)
        self.bits.scatter_add_(1, self.ring_gpu.gather(1, cells).long(), -gone)
        self.ring_win.scatter_(1, cells, win - gone)

        slot = self.slot[e]
        pid = s["pid"][e]
        arrival = pid >= 0
        if self.queued:
            live_ev = s["wlive"][e]
            wq = self.wq
            held = wq >= 0
            ei = wq.clamp(min=0).long()
            lw = lanes[:, None]
            w_slot = self.slot[ei, lw]
            keep = held & (s["end"][ei, lw] > slot[:, None]) & (slot[:, None] - w_slot <= self.patience)
            keep = torch.where(live_ev[:, None], keep, held)
            wq = torch.where(keep, wq, -1)
            hkey = (s["prio"][ei, lw].long() << 42) | (w_slot.long() << 21) | ei
            h = torch.where(keep, hkey, torch.iinfo(torch.int64).max).argmin(dim=1)
            has = keep.any(dim=1) & live_ev
            h_e = wq.gather(1, h[:, None])[:, 0]
            h_pid = _at(s["pid"], h_e.clamp(min=0), lanes)
            fits, g, j = self.select(h_pid, has)
            self.place(fits, h_e.clamp(min=0), h_pid, g, j)
            wq = wq.scatter(1, h[:, None], torch.where(fits, -1, h_e)[:, None])
            out["wadm_eidx"] = torch.where(fits, h_e, -1)
            out["wadm_gpu"] = torch.where(fits, g, -1)
            out["wadm_aidx"] = torch.where(fits, j, -1)

        fits, g, j = self.select(pid, arrival)
        placed, pg, pj = fits, g, j
        if self.defrag:
            moved = self._migrate(pid, arrival & ~fits, given, out)
            placed = fits | moved
            pg = torch.where(fits, g, given["gpu"] if given is not None else g)
            pj = torch.where(fits, j, given["aidx"] if given is not None else j)
        self.place(placed, torch.full_like(pid, e), pid, pg, pj)
        out["ok"] = placed
        out["gpu"] = torch.where(placed, pg, 0)
        out["aidx"] = torch.where(placed, pj, 0)
        if self.queued:
            room = (wq >= 0).sum(dim=1) < self.capacity
            park = arrival & ~placed & live_ev & room
            free_at = (wq < 0).to(torch.int32).argmax(dim=1)[:, None]
            wq = wq.scatter(1, free_at, torch.where(park, e, wq.gather(1, free_at)[:, 0])[:, None])
            self.wq = wq
            out["parked"] = park
        self.e += 1
        return out

    def _migrate(self, pid, dropped, given, out) -> torch.Tensor:
        """Apply the migrations the program reports on ``dropped`` lanes
        where they are legal; fill ``out``'s migration fields; return the
        lanes whose arrival is then placed."""
        t = self.t
        out["mig"] = torch.zeros_like(dropped)
        for name in MIG[1:]:
            out[name] = torch.full_like(pid, -1)
        if given is None:
            return out["mig"]
        idx = torch.nonzero(given["mig"] & dropped).squeeze(1)
        if idx.numel() == 0:
            return out["mig"]
        fg, fa = given["mig_from_gpu"][idx], given["mig_from_anchor"][idx]
        tg, ta = given["mig_to_gpu"][idx], given["mig_to_anchor"][idx]
        rg, rj = given["gpu"][idx], given["aidx"][idx]
        rp = pid[idx].long()
        rw, rgpu, rpid = self.ring_win[idx], self.ring_gpu[idx], self.ring_pid[idx]
        match = (rw != 0) & (rgpu == fg[:, None]) & (t.low[rw.long()] == fa[:, None])
        c = match.to(torch.int32).argmax(dim=1)[:, None]
        vwin = rw.gather(1, c)[:, 0]
        vpid = rpid.gather(1, c)[:, 0].long()
        in_m = lambda x: (x >= 0) & (x < t.M)  # noqa: E731
        tj = t.aidx[vpid, ta.clamp(0, t.S - 1).long()]
        legal = ((match.sum(dim=1) == 1) & in_m(fg) & in_m(tg) & (ta >= 0) & (ta < t.S)
                 & (tj >= 0) & (rg == fg) & (rj >= 0) & (rj < t.n_anchors[rp]))
        nwin = torch.where(legal, t.win[vpid, tj.clamp(min=0)], 0)
        qwin = torch.where(legal, t.win[rp, rj.clamp(0, t.A - 1).long()], 0)
        from_bits = self.bits[idx, fg.clamp(0, t.M - 1).long()] - vwin
        to_bits = torch.where(tg == fg, from_bits | qwin,
                              self.bits[idx, tg.clamp(0, t.M - 1).long()])
        good = legal & ((from_bits & qwin) == 0) & ((to_bits & nwin) == 0)
        fgl, tgl = fg.clamp(0, t.M - 1).long(), tg.clamp(0, t.M - 1).long()
        self.bits.index_put_((idx, fgl), torch.where(good, -vwin, 0), accumulate=True)
        self.bits.index_put_((idx, tgl), torch.where(good, nwin, 0), accumulate=True)
        self.ring_win[idx] = rw.scatter(1, c, torch.where(good, nwin, vwin)[:, None])
        self.ring_gpu[idx] = rgpu.scatter(1, c, torch.where(good, tg, fg)[:, None])
        moved = torch.zeros_like(dropped)
        moved[idx] = good
        out["mig"] = moved
        for name, value in zip(MIG[1:], (fg, fa, tg, ta)):
            out[name][idx] = torch.where(good, value, -1)
        return moved

    def state(self) -> Dict[str, torch.Tensor]:
        """The replayed state: patterns ``(R, M)`` and, queued, the waiting
        requests' event indexes ``(R, W)`` sorted, -1 last."""
        out = dict(bits=self.bits)
        if self.queued:
            w = torch.where(self.wq >= 0, self.wq, torch.iinfo(torch.int32).max)
            w = w.sort(dim=1).values
            out["waiting"] = torch.where(w == torch.iinfo(torch.int32).max, -1, w)
        return out


def compare(cell, fields, ring, calls: List[Tuple[int, int, Dict[str, np.ndarray]]],
            replicas: np.ndarray, device, program_state=None, last_tie: bool = False) -> dict:
    """Replay every lane of the window's ``calls`` (``(lo, hi, trace)`` in
    window order; ``lo == 0`` starts a pass, ``trace`` holds the rows
    ``lo:hi`` of all lanes) and count the entries that differ.

    Returns ``trace_bad`` (trace entries), ``state_bad`` (entries of the
    state the window left, against ``program_state``'s ``bits``, ``f``,
    ``free`` and ``waiting``), ``bad_rows`` (replica-events with a wrong
    entry) and per pass an ``(E, Q)`` mask of the wrong rows of the
    checked ``replicas``."""
    dev = torch.device(device)
    rows = max(hi for _, hi, _ in calls)
    rp = Replay(cell, fields, rows, ring, dev, last_tie)
    q = torch.as_tensor(replicas, device=dev)
    trace_bad = torch.zeros((), dtype=torch.int64, device=dev)
    bad_rows = torch.zeros((), dtype=torch.int64, device=dev)
    masks = []
    for lo, hi, trace in calls:
        if lo == 0:
            rp.reset()
            masks.append(torch.zeros((rows, len(replicas)), dtype=torch.bool, device=dev))
        if rp.e != lo:
            raise ValueError(f"call starts at event {lo}, the replay is at {rp.e}")
        have = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in trace.items()}
        for i in range(hi - lo):
            row = {k: v[i] for k, v in have.items()}
            want = rp.step(row)
            wrong = torch.zeros(rp.R, dtype=torch.bool, device=dev)
            for name in set(want) | set(row):
                if name in want and name in row:
                    neq = want[name] != row[name]
                else:
                    neq = torch.ones(rp.R, dtype=torch.bool, device=dev)
                trace_bad += neq.sum()
                wrong |= neq
            bad_rows += wrong.sum()
            masks[-1][lo + i] = wrong[q]
    state_bad = 0
    if program_state is not None:
        mine = rp.state()
        bits = mine["bits"]
        f = rp.t.F[bits.long()].to(torch.float32)
        free = (rp.t.S - rp.t.pop[bits.long()]).to(torch.int32)
        for name, want in (("bits", bits), ("f", f), ("free", free),
                           ("waiting", mine.get("waiting"))):
            have = program_state.get(name)
            if want is None and have is None:
                continue
            if want is None or have is None or tuple(have.shape) != tuple(want.shape):
                state_bad += bits.numel()
                continue
            state_bad += int((have.to(dev) != want).sum())
    return dict(trace_bad=int(trace_bad), state_bad=state_bad, bad_rows=int(bad_rows),
                masks=[m.cpu().numpy() for m in masks])
