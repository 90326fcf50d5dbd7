"""Batched Monte-Carlo simulation engine in PyTorch (steady protocol).

R replicas step together through a host-presampled event stream: per event
the staged :class:`EngineCore` runs *measure* (slot-boundary metrics),
*expire* (drain this slot's expiry-ring row), *select* (the policy's
decision) and *commit* over all replicas at once.  The replica axis is an
explicit leading ``R`` dimension of every state tensor, and the event scan
is a Python loop over events on state tensors that stay on the device:
nothing leaves the device until the trace is fetched once at the end.
State is updated in place: the reference's ``x.at[i].add`` with repeated
indices becomes ``index_add_`` on a flattened ``(R·M, ·)`` view, which
sums repeated indices exactly because every quantity is an integer held
in float32/int32.

Policies are the registry's :class:`~repro_torch.core.policy.PolicySpec`\\ s,
lowered to a masked-refinement lexicographic argmin over the
``(R, M, A)`` candidate tensor (:func:`_lower_select`).  Under
``use_kernel`` the stages go through the hand-written CUDA kernels:
``select_from_base`` for argmin-fusable specs (mfi, ff, bf-bi, wf-bi),
``delta_from_base`` for ΔF specs that keep the plain argmin
(``kernel_lowering="delta"``), and ``fragscore`` for the drain/commit
rescore on homogeneous fleets (which then tracks occupancy).  rr carries
the unfusable ``rr-distance`` key, so its argmin stays plain torch.

Every decision, metric and trace field matches the JAX reference package
bit for bit: the trace dtypes (bool/int32/int32/int32/int32/float32, laid
out ``(E_max, R)``) reproduce its golden SHA-256 hashes, and
:func:`state_from_numpy` / :func:`state_to_numpy` carry a replica state
between the two packages.

Entry points take ``device=None``, meaning ``"cuda"``; with no card they
raise.  Pass ``device="cpu"`` to run the plain torch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import cluster as tcluster
from repro_torch.core import mig
from repro_torch.core.policy import (
    REQUEST_KEYS,
    PolicyLike,
    PolicySpec,
    key_base,
    list_policies,
    resolve,
)
from repro_torch.kernels.fragscore import fragscore as _k
from repro_torch.kernels.fragscore.ref import lex_argmin
from repro_torch.sim import distributions
from repro_torch.sim.simulator import (
    SAMPLE_EVERY,
    SimConfig,
    request_probs,
    steady_params,
)

#: batched-capable registered policies at import time
POLICIES = list_policies(engine="batched")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (device=None means 'cuda') but "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "the plain torch versions on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Protocol descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Protocol:
    """Static load-protocol descriptor (the reference's fields).

    ``boundary_metrics`` samples utilization / active-GPU / fragmentation
    at slot boundaries before the drain (the steady protocol);
    ``post_metrics`` samples after every commit (cumulative); ``queued``
    and ``faulted`` add the wait ring and the fault stage.  Only the
    steady protocol is ported so far.
    """

    name: str
    boundary_metrics: bool
    post_metrics: bool
    queued: bool = False
    faulted: bool = False
    fault_retries: int = 2
    fault_backoff: int = 2


PROTOCOLS: Dict[str, Protocol] = {
    "steady": Protocol("steady", boundary_metrics=True, post_metrics=False),
    "cumulative": Protocol("cumulative", boundary_metrics=False, post_metrics=True),
    "steady-queued": Protocol(
        "steady-queued", boundary_metrics=True, post_metrics=False, queued=True
    ),
    "steady-faulted": Protocol(
        "steady-faulted", boundary_metrics=True, post_metrics=False,
        queued=True, faulted=True,
    ),
}

#: where each protocol that is not ported yet stands in ROADMAP.md
_NOT_PORTED = {
    "cumulative": "ROADMAP.md §1 item 4, cumulative protocol",
    "steady-queued": "ROADMAP.md §1 item 6, queued protocol",
    "steady-faulted": "ROADMAP.md §1 item 7, faulted protocol",
}


def resolve_protocol(protocol: Union[str, Protocol]) -> Protocol:
    """Name-or-descriptor -> :class:`Protocol`; unknown names raise
    ``ValueError``, protocols not ported yet ``NotImplementedError``."""
    if isinstance(protocol, Protocol):
        proto = protocol
    elif protocol in PROTOCOLS:
        proto = PROTOCOLS[protocol]
    else:
        raise ValueError(
            f"unknown protocol {protocol!r}; options: {tuple(sorted(PROTOCOLS))}"
        )
    if proto != PROTOCOLS["steady"]:
        raise NotImplementedError(
            f"protocol {proto.name!r} is not ported to repro_torch yet "
            f"({_NOT_PORTED.get(proto.name, 'only the steady protocol is')})"
        )
    return proto


# ---------------------------------------------------------------------------
# Stacked per-model placement tables
# ---------------------------------------------------------------------------


class SpecTables(NamedTuple):
    """Per-model placement tables of a ClusterSpec, stacked and padded.

    Axis glossary: ``K`` distinct models, ``N`` common (padded) placement
    count, ``A`` common (padded) anchor count, ``P`` demand classes,
    ``S`` memory slices.  Padded placement rows have all-zero windows and
    ``V = 0`` so they never count toward any score; padded anchor columns
    are marked invalid in ``profile_valid``.
    """

    W: torch.Tensor               # (K, N, S) float32 — placement windows
    V: torch.Tensor               # (K, N) float32 — window sizes (0 where padded)
    slices: torch.Tensor          # (K,) int32 — memory slices per model
    profile_rows: torch.Tensor    # (K, P, A) int32 — row into W/V per anchor
    profile_masks: torch.Tensor   # (K, P, A, S) int32 — anchor window bitmask
    profile_anchors: torch.Tensor  # (K, P, A) int32 — anchor index (-1 pad)
    profile_valid: torch.Tensor   # (K, P, A) bool — anchor validity
    profile_mem: torch.Tensor     # (K, P) float32 — slice demand per class
    maskwin: torch.Tensor         # (K, P, A, N) float32 — slices each anchor adds per window
    maskpos: torch.Tensor         # (K, P, A, N) float32 — (maskwin > 0)


def _spec_tables_np(spec: mig.ClusterSpec) -> Dict[str, np.ndarray]:
    """The stacked tables of ``spec`` as numpy arrays (reference layout)."""
    models = spec.models
    K = len(models)
    P = mig.NUM_PROFILES
    N = max(m.num_placements for m in models)
    A = max(m.max_anchors for m in models)
    S = spec.num_mem_slices

    W = np.zeros((K, N, S), np.float32)
    V = np.zeros((K, N), np.float32)
    slices = np.array([m.num_mem_slices for m in models], np.int32)
    rows_t = np.zeros((K, P, A), np.int32)
    masks_t = np.zeros((K, P, A, S), np.int32)
    anchors_t = np.full((K, P, A), -1, np.int32)
    valid_t = np.zeros((K, P, A), bool)
    mem_t = np.zeros((K, P), np.float32)
    for k, m in enumerate(models):
        n = m.num_placements
        W[k, :n, : m.num_mem_slices] = m.placement_masks
        V[k, :n] = m.placement_mem
        pm, pa, pv = tcluster._np_profile_tables(m, max_anchors=A)
        masks_t[k, :, :, : m.num_mem_slices] = pm
        anchors_t[k] = pa
        valid_t[k] = pv
        mem_t[k] = m.profile_mem
        for pid in range(P):
            s = m.profile_placement_rows(pid)
            rows_t[k, pid, : s.stop - s.start] = np.arange(s.start, s.stop)
    # occupied-slice count each profile anchor adds to every placement window
    maskwin = np.einsum("kpas,kns->kpan", masks_t.astype(np.float32), W)
    return dict(
        W=W, V=V, slices=slices, profile_rows=rows_t, profile_masks=masks_t,
        profile_anchors=anchors_t, profile_valid=valid_t, profile_mem=mem_t,
        maskwin=maskwin, maskpos=(maskwin > 0).astype(np.float32),
    )


def tables_from_numpy(d: Mapping[str, np.ndarray], device) -> SpecTables:
    """:class:`SpecTables` from numpy arrays keyed by field name — the
    port's own tables, or the reference's ``SpecTables`` after
    ``jax.device_get(...)._asdict()``."""
    dev = torch.device(device)
    return SpecTables(**{
        name: torch.from_numpy(np.array(d[name])).to(dev)
        for name in SpecTables._fields
    })


@functools.lru_cache(maxsize=None)
def _spec_tables(spec: mig.ClusterSpec, device: str) -> SpecTables:
    return tables_from_numpy(_spec_tables_np(spec), device)


def spec_tables(spec: mig.ClusterSpec, device="cpu") -> SpecTables:
    """Build (and cache per device) the stacked tables of a cluster spec."""
    return _spec_tables(spec, str(torch.device(device)))


def _default_spec(num_gpus: int) -> mig.ClusterSpec:
    return mig.ClusterSpec.homogeneous(mig.A100_80GB, num_gpus)


# ---------------------------------------------------------------------------
# Fragmentation scoring from the window-count state
# ---------------------------------------------------------------------------


def _frag_from_base(base, free, metric: str, v) -> torch.Tensor:
    """F(m) per GPU from window counts ``base (..., N)``, free slices
    ``free (...)`` and per-GPU window sizes ``v (..., N)``: float32."""
    if metric == "partial":
        counted = (base > 0) & (base < v)
    else:  # blocked
        counted = base > 0
    eligible = v <= free[..., None].to(torch.float32)
    return torch.where(counted & eligible, v, 0.0).sum(dim=-1)


def _delta_from_base(base, free, metric: str, v, mw, mp, mem_g, f_before):
    """ΔF of every anchor dry-run of each replica's request: (R, M, A).

    ``v (M, N)``, ``mw/mp (R, M, A, N)`` and ``mem_g (R, M)`` are the
    per-GPU gathers ``V[midx]``, ``maskwin/maskpos[midx, pid]`` and
    ``profile_mem[midx, pid]``.  For the "blocked" metric the counted
    predicate after a placement decomposes as ``(base > 0) | (mw > 0)``, so
    the table is an occupied sum plus one batched contraction; "partial"
    needs the dense ``(R, M, A, N)`` form.  Integer-valued, exact.
    """
    free_after = free.to(torch.float32) - mem_g  # (R, M)
    elig = v <= free_after[..., None]            # (R, M, N)
    if metric == "partial":
        ba = base[:, :, None, :] + mw            # (R, M, A, N)
        counted = (ba > 0) & (ba < v[:, None, :])
        f_after = torch.where(
            counted & elig[:, :, None, :], v[:, None, :], 0.0
        ).sum(dim=-1)
    else:
        cb = base > 0                            # (R, M, N)
        s_occ = torch.where(cb & elig, v, 0.0).sum(dim=-1)  # (R, M)
        cross = torch.einsum("rmn,rman->rma", torch.where(~cb & elig, v, 0.0), mp)
        f_after = s_occ[..., None] + cross
    return f_after - f_before[..., None]


def make_frag_fn(metric: str = "blocked", model: mig.DeviceModel = mig.A100_80GB,
                 device="cpu"):
    """(Q, S) occupancy -> (Q,) F scores through the ``fragscore`` kernel,
    for a homogeneous fleet of ``model``."""
    dev = torch.device(device)
    w = torch.tensor(model.placement_masks, dtype=torch.float32, device=dev)
    v = torch.tensor(model.placement_mem, dtype=torch.float32, device=dev)
    return lambda occ: _k.fragscore(occ, w, v, metric=metric)


def make_delta_fn(spec: mig.ClusterSpec, metric: str = "blocked", device="cpu"):
    """ΔF dispatch ``(base, free, f, pid) -> (R, M, A)`` through the
    ``delta_from_base`` kernel: one launch covers every replica and every
    device model of the fleet (the kernel gathers each row's model)."""
    tables = spec_tables(spec, device)
    midx32 = torch.as_tensor(spec.model_index, device=torch.device(device))

    def delta_fn(base, free, f, pid):
        return _k.delta_from_base(
            base, free, f, pid, midx32, tables.V, tables.maskwin,
            tables.profile_mem, metric=metric,
        )

    return delta_fn


def _effective_keys(pspec: PolicySpec):
    """Static ``((base, sign), …)`` kernel encoding of a spec's keys.

    Request-scoped keys are constant over one request's candidates — they
    never narrow the refinement — so the fused kernel drops them.
    """
    return tuple(
        (key_base(k), -1.0 if k.startswith("-") else 1.0)
        for k in pspec.keys
        if key_base(k) not in REQUEST_KEYS
    )


def make_select_fn(
    spec: mig.ClusterSpec, pspec: PolicySpec, metric: str = "blocked", device="cpu"
):
    """Fused select dispatch ``(base, free, f, pid) -> (gpu, aidx, ok)``
    through the ``select_from_base`` kernel: one launch per event for all
    replicas and every device model.  Requires ``pspec.argmin_fusable``."""
    tables = spec_tables(spec, device)
    midx32 = torch.as_tensor(spec.model_index, device=torch.device(device))
    keys = _effective_keys(pspec)

    def select_fn(base, free, f, pid):
        return _k.select_from_base(
            base, free, f, pid, midx32, tables.V, tables.maskwin,
            tables.profile_rows, tables.profile_valid, tables.profile_anchors,
            tables.profile_mem, keys=keys, metric=metric,
        )

    return select_fn


# ---------------------------------------------------------------------------
# PolicySpec lowering: lexicographic keys -> masked refinement argmin
# ---------------------------------------------------------------------------


def _key_tensor(base_key, feasible, free, mem_g, delta, anchors_g, cursor, midx):
    """One scoring key as an (R, M, A)-broadcastable float32 tensor."""
    m = feasible.shape[1]
    dev = feasible.device
    if base_key == "frag-delta":
        return delta  # (R, M, A)
    if base_key == "free-slices":
        return (free.to(torch.float32) - mem_g)[..., None]  # (R, M, 1)
    if base_key == "gpu":
        return torch.arange(m, dtype=torch.float32, device=dev)[None, :, None]
    if base_key == "anchor":
        # real anchor VALUES, not padded column indexes: on mixed fleets the
        # index<->value mapping differs per model (padded -1 columns are
        # infeasible, so they never win)
        return anchors_g.to(torch.float32)  # (R, M, A)
    if base_key == "rr-distance":
        ids = torch.arange(m, dtype=torch.int32, device=dev)
        prio = torch.remainder(ids[None, :] - cursor[:, None], m)
        return prio.to(torch.float32)[..., None]
    if base_key == "model-group":
        return midx.to(torch.float32)[None, :, None]
    if base_key in REQUEST_KEYS:
        # request-scoped keys are constant over one request's candidates
        return torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
    raise ValueError(f"unknown scoring key {base_key!r}")  # unreachable


def _lower_select(spec, feasible, free, mem_g, delta, anchors_g, cursor, midx):
    """Compile a spec's key list against the (R, M, A) feasibility tensor:
    each key narrows the mask to its minimizers (``-`` negates), the first
    surviving flat index breaks remaining ties.  Returns ``(gpu, aidx, ok)``."""
    vals = []
    for key in spec.keys:
        val = _key_tensor(
            key_base(key), feasible, free, mem_g, delta, anchors_g, cursor, midx
        )
        vals.append(-val if key.startswith("-") else val)
    return lex_argmin(feasible, vals)


def _feasibility(base, rows, valid) -> torch.Tensor:
    """(R, M, A) bool — anchors whose window has zero occupied slices."""
    return (torch.gather(base, 2, rows.long()) == 0) & valid


def _select(spec, base, free, f, metric, tables, midx, vg, pid, cursor,
            delta_fn=None, select_fn=None):
    """Shared decision path: ``(gpu, aidx, ok)`` per replica.

    ``select_fn`` runs the whole stage in the fused kernel; ``delta_fn``
    routes only the ΔF table through its kernel; ``None`` uses plain torch.
    """
    if select_fn is not None:
        return select_fn(base, free, f, pid)
    mi, pi = midx[None, :], pid.long()[:, None]
    rows = tables.profile_rows[mi, pi]       # (R, M, A)
    valid = tables.profile_valid[mi, pi]     # (R, M, A)
    mem_g = tables.profile_mem[mi, pi]       # (R, M)
    anchors_g = tables.profile_anchors[mi, pi]  # (R, M, A), -1 where padded
    feasible = _feasibility(base, rows, valid)
    delta = None
    if spec.requires_delta_f:  # ΔF table only for specs whose keys use it
        if delta_fn is not None:
            delta = delta_fn(base, free, f, pid)
        else:
            delta = _delta_from_base(
                base, free, metric, vg, tables.maskwin[mi, pi],
                tables.maskpos[mi, pi], mem_g, f,
            )
    return _lower_select(spec, feasible, free, mem_g, delta, anchors_g, cursor, midx)


class PolicyDecision(NamedTuple):
    """One placement decision (``-1`` where n/a; migrations are not ported
    yet, so ``mig`` is always False)."""

    gpu: torch.Tensor
    anchor: torch.Tensor
    ok: torch.Tensor
    mig: torch.Tensor
    vic_gpu: torch.Tensor
    vic_anchor: torch.Tensor
    new_gpu: torch.Tensor
    new_anchor: torch.Tensor


def _no_defrag(pspec: PolicySpec) -> None:
    if pspec.defrag:
        raise NotImplementedError(
            f"policy {pspec.name!r}: defrag specs are not ported to "
            "repro_torch yet (ROADMAP.md §1 item 5, mfi-defrag)"
        )


def policy_select_full(
    occ,
    profile_id: int,
    policy: PolicyLike,
    metric: str = "blocked",
    spec: Optional[mig.ClusterSpec] = None,
    cursor: int = 0,
    device=None,
) -> PolicyDecision:
    """One placement decision on a raw occupancy ``(M, S)``, lowered
    exactly like the engine step (through the derived ``base``/``free``)."""
    dev = resolve_device(device)
    pspec = resolve(policy, engine="batched")
    _no_defrag(pspec)
    occ = torch.as_tensor(np.asarray(occ), dtype=torch.int32, device=dev)
    spec = spec if spec is not None else _default_spec(int(occ.shape[0]))
    tables = spec_tables(spec, dev)
    midx = torch.as_tensor(spec.model_index, device=dev).long()
    base = torch.einsum("ms,mns->mn", occ.to(torch.float32), tables.W[midx])
    free = tables.slices[midx] - occ.sum(dim=1, dtype=torch.int32)
    vg = tables.V[midx]
    f = _frag_from_base(base, free, metric, vg)
    pid = torch.full((1,), int(profile_id), dtype=torch.int32, device=dev)
    cur = torch.full((1,), int(cursor), dtype=torch.int32, device=dev)
    gpu, aidx, ok = _select(
        pspec, base[None], free[None], f[None], metric, tables, midx, vg, pid, cur
    )
    gpu, aidx, ok = gpu[0].long(), aidx[0].long(), ok[0]
    anchor = torch.where(ok, tables.profile_anchors[midx[gpu], pid[0].long(), aidx], -1)
    neg1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    return PolicyDecision(
        gpu=torch.where(ok, gpu, -1).to(torch.int32),
        anchor=anchor.to(torch.int32),
        ok=ok,
        mig=torch.tensor(False, device=dev),
        vic_gpu=neg1, vic_anchor=neg1, new_gpu=neg1, new_anchor=neg1,
    )


def policy_select(
    occ,
    profile_id: int,
    policy: PolicyLike,
    metric: str = "blocked",
    spec: Optional[mig.ClusterSpec] = None,
    cursor: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One placement decision on a raw occupancy: ``(gpu, anchor, accepted)``."""
    d = policy_select_full(
        occ, profile_id, policy, metric=metric, spec=spec, cursor=cursor,
        device=device,
    )
    return d.gpu, d.anchor, d.ok


# ---------------------------------------------------------------------------
# Replica state, event stream, trace and the staged event step
# ---------------------------------------------------------------------------


class ReplicaState(NamedTuple):
    """Per-replica engine state; every field has a leading ``R`` axis and
    is updated in place by the stages."""

    occ: Optional[torch.Tensor]  # (R, M, S) int32 — only with the fragscore kernel
    base: torch.Tensor       # (R, M, N) float32 — occ @ W[midx]ᵀ, kept incrementally
    free: torch.Tensor       # (R, M) int32
    f: torch.Tensor          # (R, M) float32 — per-GPU F score, kept incrementally
    rr: torch.Tensor         # (R,) int32 — RoundRobin cursor
    ring_gpu: torch.Tensor   # (R, K+2, E) int32 — expiry ring, keyed end_slot % K
    ring_mask: torch.Tensor  # (R, K+2, E, S) int32


class EventStream(NamedTuple):
    """Host-precomputed per-event inputs, each ``(E_max, R)`` numpy."""

    pid: np.ndarray        # profile id, -1 for heartbeat/padding lanes
    exp_row: np.ndarray    # ring row (end_slot % K; trash row for padding)
    exp_col: np.ndarray    # ring column (host-assigned, collision-free)
    drain_row: np.ndarray  # ring row to drain when new_slot
    new_slot: np.ndarray   # first event of its slot (drain + maybe sample)
    sample: np.ndarray     # sample metrics of the just-finished slot
    measuring: np.ndarray  # arrival inside the measurement window


class EventMeta(NamedTuple):
    """Host-only per-event annotations, ``(E_max, R)``."""

    slot: np.ndarray  # arrival/heartbeat slot (total_slots for padding)
    end: np.ndarray   # absolute end slot of the arrival (0 for non-arrivals)


class EventTrace(NamedTuple):
    """Per-event outputs, each ``(E_max, R)`` (torch on the device while
    the engine runs, numpy after :func:`trace_to_numpy`)."""

    ok: object        # bool — arrival accepted
    gpu: object       # int32 — chosen GPU (0 when not accepted)
    aidx: object      # int32 — chosen anchor index (unmasked)
    free_sum: object  # int32 — Σ free slices at slot boundary (pre-drain)
    active: object    # int32 — active-GPU count at slot boundary (pre-drain)
    frag: object      # float32 — cluster-mean F at slot boundary (pre-drain)


_TRACE_DTYPES = (torch.bool, torch.int32, torch.int32, torch.int32, torch.int32,
                 torch.float32)


def _init_state(tables: SpecTables, midx: torch.Tensor, runs: int,
                ring_rows: int, ring_cols: int, track_occ: bool) -> ReplicaState:
    dev = tables.W.device
    num_gpus = midx.shape[0]
    n, s = tables.W.shape[1], tables.W.shape[2]
    i32 = dict(dtype=torch.int32, device=dev)
    return ReplicaState(
        occ=torch.zeros((runs, num_gpus, s), **i32) if track_occ else None,
        base=torch.zeros((runs, num_gpus, n), dtype=torch.float32, device=dev),
        free=tables.slices[midx].to(torch.int32).expand(runs, num_gpus).clone(),
        f=torch.zeros((runs, num_gpus), dtype=torch.float32, device=dev),
        rr=torch.zeros((runs,), **i32),
        ring_gpu=torch.zeros((runs, ring_rows, ring_cols), **i32),
        ring_mask=torch.zeros((runs, ring_rows, ring_cols, s), **i32),
    )


def _occ_from_ring(st: ReplicaState, num_gpus: int) -> torch.Tensor:
    """Occupancy rebuilt from the expiry ring: in the steady protocol every
    running workload is one live ring entry (drained, stale and trash
    entries hold zero masks)."""
    r, rows, cols, s = st.ring_mask.shape
    occ = torch.zeros((r * num_gpus, s), dtype=torch.int32, device=st.base.device)
    rows_of = torch.arange(r, device=occ.device)[:, None, None] * num_gpus + st.ring_gpu
    occ.index_add_(0, rows_of.reshape(-1).long(), st.ring_mask.reshape(-1, s))
    return occ.view(r, num_gpus, s)


def state_from_numpy(d: Mapping[str, np.ndarray], device) -> ReplicaState:
    """A :class:`ReplicaState` from numpy arrays keyed by field name — e.g.
    the reference's vmapped ``ReplicaState`` after ``jax.device_get`` (its
    extra fields, ``None`` in the steady non-defrag protocol, are ignored).
    A missing ``occ`` is rebuilt from the expiry ring."""
    dev = torch.device(device)
    fields = {
        name: torch.from_numpy(np.array(d[name])).to(dev)
        for name in ReplicaState._fields
        if name != "occ"
    }
    st = ReplicaState(occ=None, **fields)
    occ = d.get("occ")
    if occ is None:
        return st._replace(occ=_occ_from_ring(st, st.base.shape[1]))
    return st._replace(occ=torch.from_numpy(np.array(occ)).to(dev))


def state_to_numpy(st: ReplicaState) -> Dict[str, np.ndarray]:
    """The state's tensors as numpy arrays keyed by field name."""
    return {
        name: t.cpu().numpy() for name, t in st._asdict().items() if t is not None
    }


def _rows(t: torch.Tensor) -> torch.Tensor:
    """State ``t (R, M, ...)`` as ``(R·M, ...)`` rows — a view, so that
    in-place updates reach the state (raises if ``t`` is not contiguous)."""
    return t.view((-1,) + tuple(t.shape[2:]))


@dataclasses.dataclass
class EngineCore:
    """The staged event step for ``runs`` replicas of one configuration.

    Stage order within one event is the simulators' semantic order:
    *measure* the just-finished slot, *expire* this slot's ring row,
    *select*, *commit*.  ``frag_fn``/``delta_fn``/``select_fn`` route the
    stages through the CUDA kernels when set.
    """

    spec: PolicySpec
    protocol: Protocol
    metric: str
    tables: SpecTables
    midx: torch.Tensor        # (M,) int64 model index per GPU
    runs: int
    frag_fn: Optional[object] = None
    delta_fn: Optional[object] = None
    select_fn: Optional[object] = None

    def __post_init__(self):
        dev = self.tables.W.device
        self.vg = self.tables.V[self.midx]                  # (M, N)
        self.slices_g = self.tables.slices[self.midx]       # (M,)
        self.wg = self.tables.W[self.midx]                  # (M, N, S)
        self.ridx = torch.arange(self.runs, device=dev)     # (R,)
        # the reference's compiled mean multiplies the sum by the float32
        # reciprocal of M (18 / 5 gives 3.6000001, not 3.6), so does this
        one = torch.tensor(1.0, dtype=torch.float32)
        self.inv_num_gpus = (one / float(self.midx.shape[0])).to(dev)

    def _rescore(self, st: ReplicaState, idx) -> torch.Tensor:
        """F of the GPUs at ``idx`` (an advanced index into the (R, M) axes)."""
        if self.frag_fn is not None:
            occ = st.occ[idx]
            return self.frag_fn(occ.reshape(-1, occ.shape[-1])).view(occ.shape[:-1])
        gi = idx[1]
        return _frag_from_base(st.base[idx], st.free[idx], self.metric, self.vg[gi])

    def _stage_boundary_measure(self, st: ReplicaState):
        """Slot-boundary metrics (state == end of slot t-1)."""
        frag = st.f.sum(dim=1) * self.inv_num_gpus
        free_sum = st.free.sum(dim=1, dtype=torch.int32)
        active = (st.free < self.slices_g).sum(dim=1, dtype=torch.int32)
        return frag, free_sum, active

    def _stage_expire(self, st: ReplicaState, drain_row, new_slot) -> None:
        """Drain this slot's expiry-ring row (first event of the slot only)."""
        ns = new_slot.to(torch.int32)
        dr = drain_row.long()
        rel_gpu = st.ring_gpu[self.ridx, dr].long()                    # (R, E)
        rel_mask = st.ring_mask[self.ridx, dr] * ns[:, None, None]     # (R, E, S)
        idx = (self.ridx[:, None], rel_gpu)
        flat = (self.ridx[:, None] * self.midx.shape[0] + rel_gpu).reshape(-1)
        rel_win = torch.einsum(
            "res,rens->ren", rel_mask.to(torch.float32), self.wg[rel_gpu]
        )  # (R, E, N) — window counts each release frees, per its GPU's model
        if st.occ is not None:
            _rows(st.occ).index_add_(0, flat, -rel_mask.reshape(flat.shape[0], -1))
        _rows(st.base).index_add_(0, flat, -rel_win.reshape(flat.shape[0], -1))
        st.free.view(-1).index_add_(0, flat, rel_mask.sum(dim=-1, dtype=torch.int32).view(-1))
        # rescore exactly the touched rows (duplicates write equal values)
        st.f[idx] = self._rescore(st, idx)
        st.ring_mask[self.ridx, dr] = st.ring_mask[self.ridx, dr] * (1 - ns)[:, None, None]

    def _stage_select(self, st: ReplicaState, pid_c, valid):
        """Place (or reject) the arrival; ``pid == -1`` lanes still select
        with ``pid_c = 0`` and are masked by ``valid`` (as in the reference)."""
        gpu, aidx, ok = _select(
            self.spec, st.base, st.free, st.f, self.metric, self.tables,
            self.midx, self.vg, pid_c, st.rr, delta_fn=self.delta_fn,
            select_fn=self.select_fn,
        )
        return gpu, aidx, ok & valid

    def _stage_commit(self, st: ReplicaState, pid_c, gpu, aidx, ok, exp_row, exp_col) -> None:
        """Commit the accepted placement: occupancy/window/free updates, the
        rescore of the touched row, the cursor and the expiry-ring insert."""
        t = self.tables
        oki = ok.to(torch.int32)
        gpu_c = torch.where(ok, gpu.long(), 0)
        kg = self.midx[gpu_c]
        pl, al = pid_c.long(), aidx.long()
        mask = t.profile_masks[kg, pl, al] * oki[:, None]              # (R, S)
        mwin = t.maskwin[kg, pl, al] * oki.to(torch.float32)[:, None]  # (R, N)
        idx = (self.ridx, gpu_c)
        if st.occ is not None:
            st.occ[idx] += mask
        st.base[idx] += mwin
        st.free[idx] -= mask.sum(dim=-1, dtype=torch.int32)
        st.f[idx] = self._rescore(st, idx)
        if self.spec.stateful_cursor:  # advance the cursor past the chosen GPU
            nxt = ((gpu_c + 1) % self.midx.shape[0]).to(torch.int32)
            st.rr.copy_(torch.where(ok, nxt, st.rr))
        ring = (self.ridx, exp_row.long(), exp_col.long())
        st.ring_gpu[ring] = torch.where(ok, gpu_c.to(torch.int32), st.ring_gpu[ring])
        st.ring_mask[ring] += mask

    def step(self, st: ReplicaState, x) -> EventTrace:
        """One event for every replica; returns this event's trace row."""
        pid, exp_row, exp_col, drain_row, new_slot = x
        frag, free_sum, active = self._stage_boundary_measure(st)
        self._stage_expire(st, drain_row, new_slot)
        valid = pid >= 0
        pid_c = pid.clamp(min=0)
        gpu, aidx, ok = self._stage_select(st, pid_c, valid)
        self._stage_commit(st, pid_c, gpu, aidx, ok, exp_row, exp_col)
        return EventTrace(
            ok=ok,
            gpu=torch.where(ok, gpu.long(), 0).to(torch.int32),
            aidx=aidx.to(torch.int32),
            free_sum=free_sum,
            active=active,
            frag=frag,
        )


def _build_core(
    *,
    policy: PolicyLike,
    metric: str,
    num_gpus: int,
    use_kernel: bool,
    runs: int,
    device,
    kernel_spec: Optional[mig.ClusterSpec] = None,
    protocol: Union[str, Protocol] = "steady",
    midx: Optional[torch.Tensor] = None,
    tables: Optional[SpecTables] = None,
) -> EngineCore:
    """Validate one engine configuration and build its staged core.

    Kernel dispatch under ``use_kernel``: the occupancy-based ``fragscore``
    rescore needs one placement table, so it runs on homogeneous fleets
    only; specs whose keys consume ΔF get the ``delta_from_base`` kernel;
    argmin-fusable specs run the whole select stage in ``select_from_base``.
    """
    dev = torch.device(device)
    pspec = resolve(policy, engine="batched")
    proto = resolve_protocol(protocol)
    _no_defrag(pspec)
    if tables is None:  # homogeneous A100-80GB default
        cspec = _default_spec(num_gpus)
        tables = spec_tables(cspec, dev)
        midx = torch.as_tensor(cspec.model_index, device=dev)
    frag_fn = delta_fn = select_fn = None
    if use_kernel:
        if not pspec.kernel_lowering:
            raise ValueError(
                f"policy {pspec.name!r} opts out of kernel lowering "
                "(PolicySpec.kernel_lowering=False); run with use_kernel=False"
            )
        kspec = kernel_spec if kernel_spec is not None else _default_spec(num_gpus)
        if kspec.is_homogeneous:
            frag_fn = make_frag_fn(metric, kspec.models[0], dev)
        if pspec.requires_delta_f:
            delta_fn = make_delta_fn(kspec, metric, dev)
        if pspec.fused_argmin:
            select_fn = make_select_fn(kspec, pspec, metric, dev)
    return EngineCore(
        spec=pspec, protocol=proto, metric=metric, tables=tables,
        midx=midx.to(dev).long(), runs=runs, frag_fn=frag_fn,
        delta_fn=delta_fn, select_fn=select_fn,
    )


def _simulate(
    events: EventStream,
    *,
    policy: PolicyLike,
    metric: str,
    num_gpus: int,
    ring_rows: int,
    ring_cols: int,
    use_kernel: bool,
    kernel_spec: Optional[mig.ClusterSpec] = None,
    protocol: Union[str, Protocol] = "steady",
    midx: Optional[torch.Tensor] = None,
    tables: Optional[SpecTables] = None,
    state: Optional[ReplicaState] = None,
    device=None,
) -> Tuple[ReplicaState, EventTrace]:
    """Run the event loop over ``events`` (each field ``(E, R)``).

    The stream moves to the device once; the trace is written into
    preallocated device tensors; there is no host synchronisation inside
    the loop.  ``state`` continues from a given replica state (updated in
    place), e.g. one carried over from the reference package.
    """
    dev = resolve_device(device)
    runs = events.pid.shape[1]
    core = _build_core(
        policy=policy, metric=metric, num_gpus=num_gpus, use_kernel=use_kernel,
        runs=runs, device=dev, kernel_spec=kernel_spec, protocol=protocol,
        midx=midx, tables=tables,
    )
    track_occ = core.frag_fn is not None
    if state is None:
        state = _init_state(core.tables, core.midx, runs, ring_rows, ring_cols, track_occ)
    elif not track_occ:
        state = state._replace(occ=None)
    elif state.occ is None:
        state = state._replace(occ=_occ_from_ring(state, core.midx.shape[0]))
    xs = [
        torch.as_tensor(np.ascontiguousarray(a)).to(dev)
        for a in (events.pid, events.exp_row, events.exp_col,
                  events.drain_row, events.new_slot)
    ]
    e_max = xs[0].shape[0]
    trace = EventTrace(*[
        torch.empty((e_max, runs), dtype=dt, device=dev) for dt in _TRACE_DTYPES
    ])
    for e in range(e_max):
        row = core.step(state, [x[e] for x in xs])
        for buf, val in zip(trace, row):
            buf[e] = val
    return state, trace


def trace_to_numpy(trace: EventTrace) -> EventTrace:
    """Fetch a device trace to the host (the run's one synchronisation)."""
    return EventTrace(*[t.cpu().numpy() for t in trace])


# ---------------------------------------------------------------------------
# Host-side arrival pre-sampling + public entry point
# ---------------------------------------------------------------------------


def _rank_within_groups(keys: np.ndarray) -> np.ndarray:
    """Rank of each element within its equal-key group (first-occurrence order)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    starts = np.r_[0, np.flatnonzero(np.diff(ks)) + 1]
    lengths = np.diff(np.r_[starts, len(ks)])
    ranks_sorted = np.arange(len(ks)) - np.repeat(starts, lengths)
    ranks = np.empty(len(ks), dtype=np.int64)
    ranks[order] = ranks_sorted
    return ranks


def _ring_columns(
    is_arrival: np.ndarray, end: np.ndarray, span: int
) -> Tuple[np.ndarray, int]:
    """Collision-free ring columns: rank among same-(replica, end) arrivals.

    ``span`` must exceed every end slot so the per-replica key blocks never
    overlap.  Returns ``(exp_col, ring_cols)``.
    """
    runs, e_max = is_arrival.shape
    exp_col = np.zeros((runs, e_max), dtype=np.int32)
    flat = np.flatnonzero(is_arrival)  # C-order == per-replica arrival order
    keys = (np.repeat(np.arange(runs), e_max)[flat].astype(np.int64) * span
            + end.ravel()[flat])
    ranks = _rank_within_groups(keys)
    exp_col.ravel()[flat] = ranks
    ring_cols = max(1, int(ranks.max()) + 1 if len(ranks) else 1)
    return exp_col, ring_cols


def presample_arrivals(
    cfg: SimConfig, runs: int, seed=None
) -> Tuple[EventStream, EventMeta, int, int]:
    """Build per-replica steady-protocol event streams on host.

    Returns ``(events, meta, ring_rows, ring_cols)``.  One event per
    Poisson arrival plus one heartbeat per empty slot (so consecutive
    events never skip a slot), plus a trailing sentinel that samples the
    final slot; streams are right-padded to the longest replica with no-op
    lanes.  The draws are the reference's, in the reference's order, so
    the streams are byte-identical to it.
    """
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    probs = request_probs(cfg)
    T, warm, meas, rate = steady_params(cfg)
    total_slots = warm + meas
    ring_k = T + 1  # end slots live in (t, t + T] — one ring revolution

    counts = rng.poisson(rate, size=(runs, total_slots))
    ev_per_slot = np.maximum(counts, 1)  # heartbeat for empty slots
    n_events = ev_per_slot.sum(axis=1)  # (R,)
    e_max = int(n_events.max()) + 1  # +1 trailing sentinel

    pid = np.full((runs, e_max), -1, dtype=np.int32)
    slot = np.full((runs, e_max), total_slots, dtype=np.int32)
    new_slot = np.zeros((runs, e_max), dtype=bool)
    end = np.zeros((runs, e_max), dtype=np.int64)  # absolute end slot

    for r in range(runs):
        n = n_events[r]
        slots_r = np.repeat(np.arange(total_slots), ev_per_slot[r])
        within = np.arange(n) - np.repeat(
            np.cumsum(ev_per_slot[r]) - ev_per_slot[r], ev_per_slot[r]
        )
        is_arr = within < counts[r, slots_r]
        na = int(is_arr.sum())
        pid[r, :n][is_arr] = distributions.sample_profile_probs(probs, na, rng)
        slot[r, :n] = slots_r
        new_slot[r, :n] = within == 0
        end[r, :n][is_arr] = slots_r[is_arr] + rng.integers(1, T + 1, size=na)
        new_slot[r, n] = True  # sentinel: drains/samples the final slot

    is_arrival = pid >= 0
    exp_col, ring_cols = _ring_columns(is_arrival, end, total_slots + T + 1)

    exp_row = np.where(is_arrival, end % ring_k, ring_k + 1).astype(np.int32)
    drain_row = (slot % ring_k).astype(np.int32)
    prev = slot - 1
    sample = (
        new_slot & (prev >= warm) & ((prev - warm) % SAMPLE_EVERY == 0)
    )
    measuring = is_arrival & (slot >= warm)

    events = EventStream(
        pid=pid.T,
        exp_row=exp_row.T,
        exp_col=exp_col.T,
        drain_row=drain_row.T,
        new_slot=new_slot.T,
        sample=sample.T,
        measuring=measuring.T,
    )
    meta = EventMeta(slot=slot.T, end=end.T)
    return events, meta, ring_k + 2, ring_cols


def run_batched(
    policy: PolicyLike,
    cfg: SimConfig,
    runs: int = 64,
    use_kernel: Optional[bool] = None,
    device=None,
) -> Dict[str, float]:
    """Average ``runs`` replicas of the steady protocol on the device.

    Returns the reference's ``run_many`` aggregate keys.  ``use_kernel``
    routes the stages through the CUDA kernels (default: on a CUDA device,
    unless the spec opts out via ``kernel_lowering=False``); on the CPU the
    kernel wrappers compute their plain torch versions.
    """
    dev = resolve_device(device)
    pspec = resolve(policy, engine="batched")
    proto = resolve_protocol(cfg.protocol)
    spec = cfg.spec()
    if use_kernel is None:
        use_kernel = dev.type == "cuda" and bool(pspec.kernel_lowering)
    events, _, ring_rows, ring_cols = presample_arrivals(cfg, runs)
    _, trace = _simulate(
        events,
        policy=pspec,
        metric=cfg.metric,
        num_gpus=cfg.num_gpus,
        ring_rows=ring_rows,
        ring_cols=ring_cols,
        use_kernel=use_kernel,
        kernel_spec=spec if use_kernel else None,
        protocol=proto,
        midx=torch.as_tensor(spec.model_index, device=dev),
        tables=spec_tables(spec, dev),
        device=dev,
    )
    return aggregate(events, trace_to_numpy(trace), spec, runs)


def aggregate(
    events: EventStream, trace: EventTrace, spec, runs: int
) -> Dict[str, float]:
    """Reduce per-event steady traces (numpy) against host-known flags to
    ``run_many`` keys.  ``spec`` is the ClusterSpec (or an int GPU count)."""
    if isinstance(spec, int):
        spec = _default_spec(spec)
    cap = float(spec.total_mem_slices)
    ok = np.asarray(trace.ok)
    meas = events.measuring
    samp = events.sample

    arrived = np.maximum(meas.sum(axis=0), 1)  # (R,)
    accepted = (ok & meas).sum(axis=0)
    nsamp = np.maximum(samp.sum(axis=0), 1)
    util = ((cap - trace.free_sum) / cap * samp).sum(axis=0) / nsamp
    active = (trace.active * samp).sum(axis=0) / nsamp
    frag = (trace.frag * samp).sum(axis=0) / nsamp
    arrivals_p = np.stack(
        [((events.pid == p) & meas).sum() for p in range(mig.NUM_PROFILES)]
    )
    rejects_p = np.stack(
        [((events.pid == p) & meas & ~ok).sum() for p in range(mig.NUM_PROFILES)]
    )
    return {
        "acceptance_rate": float((accepted / arrived).mean()),
        "allocated_workloads": float(accepted.mean()),
        "active_gpus": float(active.mean()),
        "utilization": float(util.mean()),
        "frag_severity": float(frag.mean()),
        "rejects_by_profile": rejects_p / runs,
        "arrivals_by_profile": arrivals_p / runs,
    }
