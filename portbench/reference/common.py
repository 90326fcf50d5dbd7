"""Plain NumPy reference of the paper's placement rules (arXiv:2511.18906).

Written from the paper, not from the program under test: it imports
nothing but NumPy.  A GPU's occupancy is an ``S``-bit pattern (bit ``i``
set = memory slice ``i`` taken), so every rule below is a table over the
``2**S`` patterns or a bit operation on them:

* a demand class ``p`` may start at each of its Table I anchors ``a``; it
  takes the window of ``mem(p)`` slices from ``a``, and may be placed only
  where that window is wholly free;
* Algorithm 1, the fragmentation score ("blocked" reading): F(m) sums, over
  every (class, anchor) row of Table I, the row's slice count where the
  row's window holds an occupied slice and the row's slice count still fits
  the GPU's free slices;
* MFI (Algorithm 2) places a request at the feasible (gpu, anchor) of least
  ΔF = F(after) - F(before), ties broken by the lower gpu, then the lower
  anchor.

Every score is a small integer, so the comparisons are exact.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

BIG = np.int64(1) << 40


@dataclasses.dataclass(frozen=True)
class Fleet:
    """The fleet's one device model, as a configuration file states it."""

    num_gpus: int
    slices: int
    mem: Tuple[int, ...]                 # memory slices per demand class
    anchors: Tuple[Tuple[int, ...], ...]  # legal anchors per demand class

    @classmethod
    def from_config(cls, config: dict) -> "Fleet":
        fleet = config["fleet"]
        classes = fleet["classes"]
        return cls(
            num_gpus=int(fleet["gpus"]),
            slices=int(fleet["mem_slices"]),
            mem=tuple(int(c["mem"]) for c in classes),
            anchors=tuple(tuple(int(a) for a in c["anchors"]) for c in classes),
        )

    @property
    def classes(self) -> int:
        return len(self.mem)

    def window(self, pid: int, anchor: int) -> int:
        return ((1 << self.mem[pid]) - 1) << anchor

    @property
    def capacity(self) -> int:
        return self.num_gpus * self.slices


class Rules:
    """Tables of one fleet: F per pattern, each class's anchor windows."""

    def __init__(self, fleet: Fleet, metric: str = "blocked"):
        if metric != "blocked":
            raise ValueError(f"the reference states the blocked metric only, got {metric!r}")
        self.fleet = fleet
        s = fleet.slices
        patterns = np.arange(1 << s, dtype=np.int64)
        self.popcount = np.array([bin(x).count("1") for x in range(1 << s)], np.int64)
        free = s - self.popcount
        score = np.zeros(1 << s, np.int64)
        for p in range(fleet.classes):  # every (class, anchor) row of Table I
            for a in fleet.anchors[p]:
                hit = (patterns & fleet.window(p, a)) != 0
                score += fleet.mem[p] * (hit & (fleet.mem[p] <= free))
        self.F = score
        # per class: (A,) windows, in anchor order (= the anchor index)
        self.windows = [np.array([fleet.window(p, a) for a in fleet.anchors[p]], np.int64)
                        for p in range(fleet.classes)]

    def delta(self, bits: np.ndarray, pid: int) -> np.ndarray:
        """ΔF of class ``pid`` at each anchor of each pattern in ``bits``
        (any shape ``X``): ``X + (A,)``, ``BIG`` where the window is taken."""
        w = self.windows[pid]
        b = bits[..., None]
        d = self.F[b | w] - self.F[b]
        return np.where((b & w) == 0, d, BIG)

    def select(self, bits: np.ndarray, pid: int) -> Optional[Tuple[int, int, int]]:
        """MFI over the fleet's patterns ``bits (M,)``: ``(gpu, anchor index,
        ΔF)`` of the least ``(ΔF, gpu, anchor)``, or ``None``."""
        d = self.delta(bits, pid)
        k = int(np.argmin(d))  # first minimum in (gpu, anchor) order
        g, j = divmod(k, d.shape[1])
        if d[g, j] >= BIG:
            return None
        return g, j, int(d[g, j])


@dataclasses.dataclass
class Running:
    """A placed workload."""

    end: int
    gpu: int
    anchor: int
    pid: int
    eidx: int


class Replica:
    """One replica's cluster: patterns, running workloads by end slot."""

    def __init__(self, rules: Rules):
        self.rules = rules
        self.bits = np.zeros(rules.fleet.num_gpus, np.int64)
        self.by_end: Dict[int, List[Running]] = {}
        self.inv_gpus = np.float32(1.0) / np.float32(rules.fleet.num_gpus)

    def measure(self) -> Tuple[int, int, np.float32]:
        """``(free_sum, active, frag)`` of the current state; frag is the
        float32 mean F (the sum times the float32 reciprocal of M)."""
        s = self.rules.fleet.slices
        used = self.rules.popcount[self.bits]
        free_sum = int(self.bits.shape[0] * s - used.sum())
        active = int((self.bits != 0).sum())
        frag = np.float32(self.rules.F[self.bits].sum()) * self.inv_gpus
        return free_sum, active, np.float32(frag)

    def release_until(self, t: int) -> None:
        """Release every workload whose lease ended by slot ``t``."""
        for end in [e for e in self.by_end if e <= t]:
            for w in self.by_end.pop(end):
                self.bits[w.gpu] &= ~self.rules.fleet.window(w.pid, w.anchor)

    def place(self, w: Running) -> None:
        win = self.rules.fleet.window(w.pid, w.anchor)
        if self.bits[w.gpu] & win:
            raise AssertionError(f"double booking on GPU {w.gpu}")
        self.bits[w.gpu] |= win
        self.by_end.setdefault(w.end, []).append(w)

    def running(self) -> List[Running]:
        return [w for ws in self.by_end.values() for w in ws]


def decode_slots(new_slot: np.ndarray) -> np.ndarray:
    """Each event's slot: slots advance by one at every ``new_slot`` lane
    (one event at least per slot, a sentinel after the last)."""
    return np.cumsum(new_slot.astype(np.int64)) - 1


def steady_params(fleet: Fleet, probs: np.ndarray, load: float, warm_h: int,
                  meas_h: int) -> Tuple[int, int, int, float]:
    """The steady protocol's ``(T, warm, meas, rate)``: T = ⌈capacity /
    E[mem]⌉ slots (durations uniform on [1, T]), warm-up and measurement
    in whole T, Poisson rate = load · capacity / (E[duration] · E[mem])."""
    mean_mem = float(np.asarray(probs) @ np.asarray(fleet.mem, np.float64))
    t = int(np.ceil(fleet.capacity / mean_mem))
    rate = load * fleet.capacity / ((1 + t) / 2 * mean_mem)
    return t, warm_h * t, meas_h * t, rate


def aggregate(measuring, sample, pid, ok, free_sum, active, frag, capacity: int,
              classes: int) -> Dict[str, object]:
    """The paper's steady-protocol figures of ``(E, R)`` traces: acceptance
    over the measurement window's arrivals, and utilization, active GPUs
    and mean F averaged over its sampled slot boundaries."""
    cap = float(capacity)
    runs = ok.shape[1]
    arrived = np.maximum(measuring.sum(axis=0), 1)
    accepted = (ok & measuring).sum(axis=0)
    nsamp = np.maximum(sample.sum(axis=0), 1)
    util = ((cap - free_sum) / cap * sample).sum(axis=0) / nsamp
    act = (active * sample).sum(axis=0) / nsamp
    fr = (frag * sample).sum(axis=0) / nsamp
    return {
        "acceptance_rate": float((accepted / arrived).mean()),
        "allocated_workloads": float(accepted.mean()),
        "active_gpus": float(act.mean()),
        "utilization": float(util.mean()),
        "frag_severity": float(fr.mean()),
        "rejects_by_profile": np.stack(
            [((pid == p) & measuring & ~ok).sum() for p in range(classes)]) / runs,
        "arrivals_by_profile": np.stack(
            [((pid == p) & measuring).sum() for p in range(classes)]) / runs,
    }
