"""Batched Monte-Carlo simulation engine in PyTorch.

R replicas step together through a host-presampled event stream: per event
the staged :class:`EngineCore` runs *measure* (slot-boundary metrics;
steady protocols), *expire* (drain this slot's expiry-ring row), *fault*
(faulted protocol: this slot's GPU failures and recoveries, evicting and
re-queueing the failed GPUs' workloads), *wait* (queued protocols: prune
the wait ring and try to admit its head), *select* (the policy's
decision), *migrate* (defrag specs: the single-migration search on
reject), *commit*, *park* (queued: a rejected arrival enters the wait
ring) and *post-measure* (cumulative protocol) over all replicas at
once.  The replica axis is an explicit leading ``R`` dimension of every
state tensor, and the event scan is a Python loop over
events on state tensors that stay on the device: nothing leaves the
device until the trace is fetched once at the end.  State is updated in
place: the reference's ``x.at[i].add`` with repeated indices becomes
``index_add_`` on a flattened ``(R·M, ·)`` view, which sums repeated
indices exactly because every quantity is an integer held in
float32/int32.

Four protocols run here: ``steady`` (the paper's experiment),
``cumulative`` (one arrival per slot until the demand grid is crossed),
``steady-queued`` (the steady stream with a bounded, tenant-aware wait
ring) and ``steady-faulted`` (the queued protocol under per-GPU failures
with retry and backoff).  :func:`simulate_chunked` drives any of them in
chunks of events from a host stream staged through pinned buffers, with
the carry checkpointed through :mod:`repro_torch.checkpoint`.  Both
entry points split the replica axis across the visible cards (``shard=``,
:func:`shard_events`): each card steps its own contiguous block of R/D
replicas, and one Python loop over the events steps every block in turn.

Policies are the registry's :class:`~repro_torch.core.policy.PolicySpec`\\ s,
lowered to a masked-refinement lexicographic argmin over the
``(R, M, A)`` candidate tensor (:func:`_lower_select`).  Under
``use_kernel`` the stages go through the hand-written CUDA kernels:
``select_from_base`` for argmin-fusable specs (mfi, ff, bf-bi, wf-bi; the
queued protocol's wait head too; not under the faulted protocol, whose
up-mask the kernel cannot see), ``delta_from_base`` for ΔF specs that
keep the plain argmin (``kernel_lowering="delta"``, and every ΔF spec
under the faulted protocol), ``migrate_refine``
for the migrate search of fusable defrag specs (mfi-defrag), and
``fragscore`` for the drain/commit rescore on homogeneous fleets (which
then tracks occupancy).  rr carries the unfusable ``rr-distance`` key, so
its argmin stays plain torch.

Every decision, metric and trace field matches the JAX reference package
bit for bit: the trace fields keep the reference's dtypes and order
(``_TRACE_DTYPES``: bool ``ok``, int32 ``gpu``/``aidx``; the steady
protocols' int32 ``free_sum``/``active`` and float32 ``frag``; the
cumulative protocol's int32 ``post_free``/``post_active`` and float32
``post_frag``; defrag specs' bool ``mig`` and four int32 ``mig*``; the
queued protocol's bool ``parked`` and int32 ``wadm_eidx``/``wadm_gpu``/
``wadm_aidx``; the faulted protocol's int32 ``evicted``/``evict_lost``/
``evict_esum``; each laid out ``(E_max, R)``, ``None`` where the protocol
or spec produces no such field), so they reproduce its golden SHA-256
hashes, and :func:`state_from_numpy` / :func:`state_to_numpy` carry a
replica state, wait ring and fault planes included, between the two
packages.

Entry points take ``device=None``, meaning ``"cuda"``; with no card they
raise.  Pass ``device="cpu"`` to run the plain torch versions on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import heapq
import time
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

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
    queue_order,
    resolve,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.fragscore import fragscore as _k
from repro_torch.kernels.fragscore.ref import (
    BIG, class_rows, first_true, lex_argmin, lex_top2, refine_rows,
)
from repro_torch.sim import distributions
from repro_torch.sim.simulator import (
    SAMPLE_EVERY,
    SimConfig,
    jain_fairness,
    request_probs,
    steady_params,
)

#: batched-capable registered policies at import time
POLICIES = list_policies(engine="batched")


# ---------------------------------------------------------------------------
# Protocol descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Protocol:
    """Static load-protocol descriptor (the reference's fields).

    ``boundary_metrics`` samples utilization / active-GPU / fragmentation
    at slot boundaries before the drain (the steady protocols);
    ``post_metrics`` samples after every commit (cumulative); ``queued``
    adds the wait ring and ``faulted`` the fault stage, whose retry budget
    and backoff base ride in ``fault_retries``/``fault_backoff``
    (:func:`run_batched` fills them from ``SimConfig.fault_model``).
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

def resolve_protocol(protocol: Union[str, Protocol]) -> Protocol:
    """Name-or-descriptor -> :class:`Protocol`; unknown names raise
    ``ValueError``."""
    if isinstance(protocol, Protocol):
        return protocol
    if protocol in PROTOCOLS:
        return PROTOCOLS[protocol]
    raise ValueError(
        f"unknown protocol {protocol!r}; options: {tuple(sorted(PROTOCOLS))}"
    )


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
    # the migrate kernel sums windows as bit sets of their sizes
    if not (np.all(V == np.floor(V)) and np.all((V >= 0) & (V <= 32))):
        raise ValueError(f"window sizes must be whole slices in [0, 32]: {np.unique(V)}")
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


def spec_tables(spec: mig.ClusterSpec, device=None) -> SpecTables:
    """Build (and cache per device) the stacked tables of a cluster spec;
    ``device=None`` means ``"cuda"``."""
    return _spec_tables(spec, str(resolve_device(device)))


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
    """ΔF of every anchor dry-run on rows ``base (..., M, N)``: ``(..., M, A)``.

    ``v (..., M, N)``, ``mw/mp (..., M, A, N)`` and ``mem_g (..., M)`` are
    the per-row gathers ``V[midx]``, ``maskwin/maskpos[midx, pid]`` and
    ``profile_mem[midx, pid]`` (the migrate search gathers them per victim).
    For the "blocked" metric the counted predicate after a placement
    decomposes as ``(base > 0) | (mw > 0)``, so the table is an occupied sum
    plus one batched contraction over ``mp`` (``mw`` is not read and may be
    None); "partial" needs the dense ``(..., M, A, N)`` form.
    Integer-valued, exact.
    """
    free_after = free.to(torch.float32) - mem_g  # (..., M)
    elig = v <= free_after[..., None]            # (..., M, N)
    if metric == "partial":
        ba = base[..., None, :] + mw             # (..., M, A, N)
        counted = (ba > 0) & (ba < v[..., None, :])
        f_after = torch.where(
            counted & elig[..., None, :], v[..., None, :], 0.0
        ).sum(dim=-1)
    else:
        cb = base > 0                            # (..., M, N)
        s_occ = torch.where(cb & elig, v, 0.0).sum(dim=-1)  # (..., M)
        cross = (mp @ torch.where(~cb & elig, v, 0.0)[..., None])[..., 0]
        f_after = s_occ[..., None] + cross
    return f_after - f_before[..., None]


def _maskwin_rows(tables, metric: str, k, p):
    """``maskwin[k, p]`` where :func:`_delta_from_base` reads it (the
    "partial" metric), else None."""
    return class_rows(tables.maskwin, k, p) if metric == "partial" else None


def make_frag_fn(metric: str = "blocked", model: mig.DeviceModel = mig.A100_80GB,
                 device=None):
    """(Q, S) occupancy -> (Q,) F scores through the ``fragscore`` kernel,
    for a homogeneous fleet of ``model``."""
    dev = resolve_device(device)
    w = torch.tensor(model.placement_masks, dtype=torch.float32, device=dev)
    v = torch.tensor(model.placement_mem, dtype=torch.float32, device=dev)
    return lambda occ: _k.fragscore(occ, w, v, metric=metric)


def make_delta_fn(spec: mig.ClusterSpec, metric: str = "blocked", device=None):
    """ΔF dispatch ``(base, free, f, pid) -> (R, M, A)`` through the
    ``delta_from_base`` kernel: one launch covers every replica and every
    device model of the fleet (the kernel gathers each row's model)."""
    dev = resolve_device(device)
    tables = spec_tables(spec, dev)
    midx32 = torch.as_tensor(spec.model_index, device=dev)

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
    spec: mig.ClusterSpec, pspec: PolicySpec, metric: str = "blocked", device=None
):
    """Fused select dispatch ``(base, free, f, pid) -> (gpu, aidx, ok)``
    through the ``select_from_base`` kernel: one launch per event for all
    replicas and every device model.  Requires ``pspec.argmin_fusable``."""
    dev = resolve_device(device)
    tables = spec_tables(spec, dev)
    midx32 = torch.as_tensor(spec.model_index, device=dev)
    keys = _effective_keys(pspec)

    def select_fn(base, free, f, pid):
        return _k.select_from_base(
            base, free, f, pid, midx32, tables.V, tables.maskwin,
            tables.profile_rows, tables.profile_valid, tables.profile_anchors,
            tables.profile_mem, keys=keys, metric=metric,
        )

    return select_fn


def make_migrate_fn(
    spec: mig.ClusterSpec, pspec: PolicySpec, metric: str = "blocked", device=None
):
    """Migrate-search dispatch through the ``migrate_refine`` kernel:
    ``(base, free, f, base2, free2, f2, rg, rp, kc) -> (g1, ok1, a1, k1, g2,
    ok2, a2, k2, ap, okp, kp)`` — the per-class best and runner-up
    untouched rows and the per-victim patched-row refinements that
    :func:`_migrate_search` consumes.  One launch per event covers every
    replica, class, victim and device model; no host merge."""
    dev = resolve_device(device)
    tables = spec_tables(spec, dev)
    midx32 = torch.as_tensor(spec.model_index, device=dev)
    keys = _effective_keys(pspec)

    def migrate_fn(base, free, f, base2, free2, f2, rg, rp, kc):
        return _k.migrate_refine(
            base, free, f, base2, free2, f2, rg, rp, kc, midx32, tables.V,
            tables.maskwin, tables.profile_rows, tables.profile_valid,
            tables.profile_anchors, tables.profile_mem, keys=keys, metric=metric,
        )

    return migrate_fn


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
            delta_fn=None, select_fn=None, gpu_ok=None):
    """Shared decision path: ``(gpu, aidx, ok)`` per replica.

    ``select_fn`` runs the whole stage in the fused kernel; ``delta_fn``
    routes only the ΔF table through its kernel; ``None`` uses plain torch.
    ``gpu_ok (R, M)`` masks out GPUs that are down (faulted protocol).
    """
    if select_fn is not None:
        return select_fn(base, free, f, pid)
    mi, pi = midx[None, :], pid.long()[:, None]
    rows = tables.profile_rows[mi, pi]       # (R, M, A)
    valid = tables.profile_valid[mi, pi]     # (R, M, A)
    mem_g = tables.profile_mem[mi, pi]       # (R, M)
    anchors_g = tables.profile_anchors[mi, pi]  # (R, M, A), -1 where padded
    feasible = _feasibility(base, rows, valid)
    if gpu_ok is not None:
        feasible = feasible & gpu_ok[:, :, None]
    delta = None
    if spec.requires_delta_f:  # ΔF table only for specs whose keys use it
        if delta_fn is not None:
            delta = delta_fn(base, free, f, pid)
        else:
            delta = _delta_from_base(
                base, free, metric, vg, _maskwin_rows(tables, metric, mi, pi),
                class_rows(tables.maskpos, mi, pi), mem_g, f,
            )
    return _lower_select(spec, feasible, free, mem_g, delta, anchors_g, cursor, midx)


# ---------------------------------------------------------------------------
# Row-wise / grid-wise refinement variants (the migrate stage's selections)
# ---------------------------------------------------------------------------


def _key_rows(base_key, free, mem_g, delta, anchors_g, cursor, gidx, kidx, num_gpus):
    """One scoring key as a ``(..., A)``-broadcastable tensor for *per-row*
    selection: each row is an independent single-GPU candidate whose GPU
    index is ``gidx`` and model index ``kidx`` (broadcastable to the rows;
    the leading axis is the replica's, as in ``cursor (R,)``)."""
    if base_key == "frag-delta":
        return delta
    if base_key == "free-slices":
        return (free.to(torch.float32) - mem_g)[..., None]
    if base_key == "gpu":
        return gidx.to(torch.float32)[..., None]
    if base_key == "anchor":
        return anchors_g.to(torch.float32)
    if base_key == "rr-distance":
        cur = cursor.view((-1,) + (1,) * (gidx.dim() - 1))
        prio = torch.remainder(gidx.to(torch.int32) - cur, num_gpus)
        return prio.to(torch.float32)[..., None]
    if base_key == "model-group":
        return kidx.to(torch.float32)[..., None]
    if base_key in REQUEST_KEYS:
        # request-scoped keys are constant over one request's candidates
        return torch.zeros((1,), dtype=torch.float32, device=gidx.device)
    raise ValueError(f"unknown scoring key {base_key!r}")  # unreachable


def _refine_rows(spec, feasible, free, mem_g, delta, anchors_g, cursor, gidx,
                 kidx, num_gpus, return_keys=False):
    """Per-row spec selection: one independent argmin along the anchor axis
    of every row of ``feasible (..., A)``.  Returns ``(aidx, ok)``; with
    ``return_keys`` also the winner's signed key values ``(..., L)``, taken
    unmasked at the first surviving column (column 0 for an all-infeasible
    row) — the row's representative in a cross-row comparison by
    ``(keys…, gpu)``, which the factored migrate search relies on."""
    vals = []
    for key in spec.keys:
        val = _key_rows(key_base(key), free, mem_g, delta, anchors_g, cursor,
                        gidx, kidx, num_gpus)
        vals.append(-val if key.startswith("-") else val)
    aidx, ok, keys = refine_rows(feasible, vals)
    return (aidx, ok, keys) if return_keys else (aidx, ok)


def _key_grid(base_key, free, mem_g, delta, anchors_g, cursor, midx):
    """One scoring key as a ``(..., M, A)``-broadcastable tensor for batched
    whole-cluster selection (one independent (gpu, anchor) argmin per
    leading row): ``free/mem_g (..., M)``, ``delta/anchors_g (..., M, A)``."""
    m = free.shape[-1]
    dev = free.device
    if base_key == "frag-delta":
        return delta
    if base_key == "free-slices":
        return (free.to(torch.float32) - mem_g)[..., None]
    if base_key == "gpu":
        return torch.arange(m, dtype=torch.float32, device=dev)[:, None]
    if base_key == "anchor":
        return anchors_g.to(torch.float32)
    if base_key == "rr-distance":  # pragma: no cover — defrag+rr is rejected
        cur = cursor.view((-1,) + (1,) * (free.dim() - 1))
        prio = torch.remainder(torch.arange(m, dtype=torch.int32, device=dev) - cur, m)
        return prio.to(torch.float32)[..., None]
    if base_key == "model-group":
        return midx.to(torch.float32)[:, None]
    if base_key in REQUEST_KEYS:
        return torch.zeros((1,), dtype=torch.float32, device=dev)
    raise ValueError(f"unknown scoring key {base_key!r}")  # unreachable


def _refine_grid(spec, feasible, free, mem_g, delta, anchors_g, cursor, midx):
    """Batched whole-cluster spec selection: an independent ``(gpu, anchor)``
    argmin over the trailing ``(M, A)`` axes of every leading row of
    ``feasible (..., M, A)``.  Returns ``(gpu, aidx, ok)``, each ``(...)``."""
    mask = feasible
    for key in spec.keys:
        val = _key_grid(key_base(key), free, mem_g, delta, anchors_g, cursor, midx)
        if key.startswith("-"):
            val = -val
        masked = torch.where(mask, val, BIG)
        mask = mask & (masked == masked.amin(dim=(-2, -1), keepdim=True))
    a = feasible.shape[-1]
    flat = mask.flatten(-2)
    k = first_true(flat)
    return k // a, k % a, flat.any(dim=-1)


# ---------------------------------------------------------------------------
# Migrate stage: the batched single-migration defrag search
# ---------------------------------------------------------------------------


class MigrationResult(NamedTuple):
    """Chosen migration of one event per replica (entries masked by ``mig``);
    every field has a leading ``R`` axis."""

    mig: torch.Tensor         # (R,) bool — a migration was committed
    gpu: torch.Tensor         # (R,) int32 — request GPU (= victim's old GPU)
    aidx: torch.Tensor        # (R,) int32 — request anchor index
    vic_row: torch.Tensor     # (R,) int32 — victim's ring row
    vic_col: torch.Tensor     # (R,) int32 — victim's ring column
    vic_gpu: torch.Tensor     # (R,) int32 — victim's old GPU
    vic_anchor: torch.Tensor  # (R,) int32 — victim's old anchor value
    vic_pid: torch.Tensor     # (R,) int32 — victim's demand class
    new_gpu: torch.Tensor     # (R,) int32 — victim's new GPU
    new_aidx: torch.Tensor    # (R,) int32 — victim's new anchor index
    new_anchor: torch.Tensor  # (R,) int32 — victim's new anchor value
    old_mask: torch.Tensor    # (R, S) int32 — victim's old window bitmask
    old_mwin: torch.Tensor    # (R, N) float32 — window counts the old mask held
    new_mask: torch.Tensor    # (R, S) int32 — victim's new window bitmask
    new_mwin: torch.Tensor    # (R, N) float32 — window counts the new mask adds


def _at(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t (R, C, ...)`` at each replica's columns ``idx (R,)`` or ``(R, X)``."""
    r = torch.arange(t.shape[0], device=t.device).view((-1,) + (1,) * (idx.dim() - 1))
    return t[r, idx]


def _victims(spec, metric, tables, midx, vg, base, free, rg, rm, rp, ra, pid_c, cursor):
    """The front half of both searches, per ring entry ``(R, C)``: evacuate
    the victim from its GPU, re-select the request on the freed GPU and
    place it there."""
    num_gpus = midx.shape[0]
    rgl, rpl, ral = rg.long(), rp.long(), ra.long()
    kc = midx[rgl]                                     # (R, C) victim model index
    vgc = vg[rgl]                                      # (R, C, N) window sizes

    # -- evacuate the victim from its own GPU -------------------------------
    mwin_vic = tables.maskwin[kc, rpl, ral]            # (R, C, N)
    base_v = _at(base, rgl) - mwin_vic
    free_v = _at(free, rgl) + rm.sum(dim=-1, dtype=torch.int32)
    f_v = _frag_from_base(base_v, free_v, metric, vgc)

    # -- re-select the request on the freed GPU -----------------------------
    pc = pid_c.long()[:, None]
    mem_req = tables.profile_mem[kc, pc]               # (R, C)
    feas_req = ((torch.gather(base_v, 2, tables.profile_rows[kc, pc].long()) == 0)
                & tables.profile_valid[kc, pc])        # (R, C, A)
    delta_req = None
    if spec.requires_delta_f:
        delta_req = _delta_from_base(
            base_v, free_v, metric, vgc, _maskwin_rows(tables, metric, kc, pc),
            class_rows(tables.maskpos, kc, pc),
            mem_req, f_v,
        )
    aidx_req, ok_req = _refine_rows(
        spec, feas_req, free_v, mem_req, delta_req, tables.profile_anchors[kc, pc],
        cursor, rg, kc, num_gpus,
    )

    # -- place the request on the freed GPU ---------------------------------
    al = aidx_req.long()
    base2 = base_v + tables.maskwin[kc, pc, al]        # (R, C, N)
    free2 = free_v - tables.profile_masks[kc, pc, al].sum(dim=-1, dtype=torch.int32)
    f2 = _frag_from_base(base2, free2, metric, vgc)
    return dict(kc=kc, vgc=vgc, mwin_vic=mwin_vic, aidx_req=aidx_req, ok_req=ok_req,
                base2=base2, free2=free2, f2=f2)


def _choose(tables, midx, vg, metric, base, free, f, v, rg, rm, rp, ra, present, want,
            new_gpu, new_aidx, ok_vic, slot, cols) -> MigrationResult:
    """Score every candidate by the total cluster F after both moves and
    pick the canonical lex-min ``(total F, victim gpu, victim anchor)`` of
    each replica; ``slot (R, C)`` is each candidate's flat ring slot."""
    rgl, rpl = rg.long(), rp.long()
    ng, na = new_gpu.long(), new_aidx.long()
    kv = midx[ng]                                                # (R, C)
    mask_new = tables.profile_masks[kv, rpl, na]                 # (R, C, S)
    mwin_new = tables.maskwin[kv, rpl, na]                       # (R, C, N)
    same = ng == rgl
    base_gv = torch.where(same[..., None], v["base2"], _at(base, ng))
    free_gv = torch.where(same, v["free2"], _at(free, ng))
    vgn = vg[ng]
    f_gv_before = _frag_from_base(base_gv, free_gv, metric, vgn)
    f_gv_after = _frag_from_base(
        base_gv + mwin_new, free_gv - mask_new.sum(dim=-1, dtype=torch.int32), metric, vgn
    )
    total = f.sum(dim=1, keepdim=True) - _at(f, rgl) + v["f2"] + f_gv_after - f_gv_before

    vic_anchor = tables.profile_anchors[v["kc"], rpl, ra.long()]  # (R, C)
    cmask = present & v["ok_req"] & ok_vic & want[:, None]
    for val in (total, rg.to(torch.float32), vic_anchor.to(torch.float32)):
        masked = torch.where(cmask, val, BIG)
        cmask = cmask & (masked == masked.amin(dim=1, keepdim=True))
    j = first_true(cmask)                                        # (R,)
    orig = _at(slot, j)                                          # winner's ring slot
    i32 = torch.int32
    return MigrationResult(
        mig=_at(cmask, j),
        gpu=_at(rg, j).to(i32),
        aidx=_at(v["aidx_req"], j).to(i32),
        vic_row=(orig // cols).to(i32),
        vic_col=(orig % cols).to(i32),
        vic_gpu=_at(rg, j).to(i32),
        vic_anchor=_at(vic_anchor, j).to(i32),
        vic_pid=_at(rp, j).to(i32),
        new_gpu=_at(ng, j).to(i32),
        new_aidx=_at(na, j).to(i32),
        new_anchor=tables.profile_anchors[_at(kv, j), _at(rpl, j), _at(na, j)].to(i32),
        old_mask=_at(rm, j),
        old_mwin=_at(v["mwin_vic"], j),
        new_mask=_at(mask_new, j),
        new_mwin=_at(mwin_new, j),
    )


def _class_tables(tables, midx):
    """Whole-cluster tables of every demand class: ``rows``, ``valid``,
    ``anchors (P, M, A)`` and ``mem (P, M)``."""
    return (tables.profile_rows[midx].transpose(0, 1),
            tables.profile_valid[midx].transpose(0, 1),
            tables.profile_anchors[midx].transpose(0, 1),
            tables.profile_mem[midx].transpose(0, 1))


def _feasible_all(base, rows_all, valid_all):
    """``(R, P, M, A)`` feasibility of every class on the untouched cluster."""
    r, m, n = base.shape
    p, _, a = rows_all.shape
    rows = rows_all.long()[None].expand(r, p, m, a)
    return (torch.gather(base[:, None].expand(r, p, m, n), 3, rows) == 0) & valid_all


def _delta_all(tables, midx, vg, metric, base, free, f, mem_all):
    """ΔF of every demand class on the untouched cluster, ``(R, P, M, A)``:
    the class tables ``(P, M, …)`` broadcast against the replica state
    ``(R, 1, M, …)``."""
    return _delta_from_base(
        base[:, None], free[:, None], metric, vg, tables.maskwin[midx].transpose(0, 1),
        tables.maskpos[midx].transpose(0, 1), mem_all, f[:, None],
    )


def _delta_patch(tables, metric, v, rp):
    """ΔF of each victim's class on its patched row, ``(R, C, A)``."""
    kc, rpl = v["kc"], rp.long()
    return _delta_from_base(
        v["base2"], v["free2"], metric, v["vgc"], _maskwin_rows(tables, metric, kc, rpl),
        class_rows(tables.maskpos, kc, rpl), tables.profile_mem[kc, rpl], v["f2"],
    )


def _feasible_patch(tables, v, rp):
    """``(R, C, A)`` feasibility of each victim's class on its patched row."""
    kc, rpl = v["kc"], rp.long()
    return ((torch.gather(v["base2"], 2, tables.profile_rows[kc, rpl].long()) == 0)
            & tables.profile_valid[kc, rpl])


def _ring_entries(ring_gpu, ring_mask, ring_pid, ring_aidx):
    """Flatten the ring planes to ``(R, C)`` entries plus the live flags."""
    r, rows, cols = ring_gpu.shape
    c = rows * cols
    rm = ring_mask.reshape(r, c, ring_mask.shape[-1])
    return (ring_gpu.reshape(r, c), rm, ring_pid.reshape(r, c),
            ring_aidx.reshape(r, c), rm.sum(dim=-1) > 0)


def _migrate_search_dense(spec, metric, tables, midx, vg, base, free, f, ring_gpu,
                          ring_mask, ring_pid, ring_aidx, pid_c, cursor, want
                          ) -> MigrationResult:
    """Dense form of the single-migration search: the full victim × cluster
    ``(R, C, M, A)`` re-placement grid over every ring slot, dead ones
    included, lex-refined per victim.  The oracle :func:`_migrate_search`
    is held to in the tests; the engine never runs it."""
    r, _, cols = ring_gpu.shape
    rg, rm, rp, ra, present = _ring_entries(ring_gpu, ring_mask, ring_pid, ring_aidx)
    v = _victims(spec, metric, tables, midx, vg, base, free, rg, rm, rp, ra, pid_c, cursor)
    rpl = rp.long()

    rows_all, valid_all, anchors_all, mem_all = _class_tables(tables, midx)
    onehot = (torch.arange(midx.shape[0], device=base.device)
              == rg.long()[..., None])                                   # (R, C, M)
    feas_grid = torch.where(onehot[..., None], _feasible_patch(tables, v, rp)[:, :, None],
                            _at(_feasible_all(base, rows_all, valid_all), rpl))
    free_grid = torch.where(onehot, v["free2"][..., None], free[:, None, :])
    delta_grid = None
    if spec.requires_delta_f:
        delta_grid = torch.where(
            onehot[..., None], _delta_patch(tables, metric, v, rp)[:, :, None],
            _at(_delta_all(tables, midx, vg, metric, base, free, f, mem_all), rpl),
        )
    new_gpu, new_aidx, ok_vic = _refine_grid(
        spec, feas_grid, free_grid, mem_all[rpl], delta_grid, anchors_all[rpl], cursor, midx
    )
    slot = torch.arange(rg.shape[1], device=base.device).expand(r, -1)
    return _choose(tables, midx, vg, metric, base, free, f, v, rg, rm, rp, ra, present,
                   want, new_gpu, new_aidx, ok_vic, slot, cols)


def _migrate_search(spec, metric, tables, midx, vg, base, free, f, ring_gpu, ring_mask,
                    ring_pid, ring_aidx, pid_c, cursor, want, delta_fn=None,
                    migrate_fn=None) -> MigrationResult:
    """Factored masked single-migration search over live ring entries.

    For every candidate victim (a running workload): evacuate it, re-select
    the request on the victim's GPU (the only GPU where feasibility can
    have appeared — the arrival was just rejected everywhere), re-place the
    victim anywhere through the spec's keys, and score the candidate by the
    total cluster fragmentation after both moves.  The winner minimizes
    ``(total F, victim gpu, victim anchor)``; ``want (R,)`` gates the stage.

    Evacuating a victim perturbs exactly one GPU row, so the re-placement
    candidates split into the victim's *patched* row and ``M - 1``
    *untouched* rows shared by every victim of the same demand class: once
    per event a per-class ``(P, M, A)`` row refinement keeps the best and
    runner-up row of each class (the runner-up serves victims whose own GPU
    is the best row), and per victim only the patched row is refined.  With
    ``migrate_fn`` both refinements run in one ``migrate_refine`` launch;
    without it in plain torch, where ``delta_fn`` (if given) builds the
    per-class ΔF tables, one launch per class.

    Dead ring slots are compacted away first: every running workload holds
    at least one slice, so at most ``C_live = min(C, M·S)`` entries are
    live, and a stable sort of the dead flags keeps them first, in ring
    order.
    """
    r, _, cols = ring_gpu.shape
    num_gpus = midx.shape[0]
    rg, rm, rp, ra, present = _ring_entries(ring_gpu, ring_mask, ring_pid, ring_aidx)
    c_total, s = rm.shape[1], rm.shape[2]

    # -- live-candidate compaction: dead ring slots cost nothing ------------
    c_live = min(c_total, num_gpus * s)
    if c_live < c_total:
        live = torch.argsort((~present).to(torch.int8), dim=1, stable=True)[:, :c_live]
        rg, rp, ra, present = (torch.gather(t, 1, live) for t in (rg, rp, ra, present))
        rm = torch.gather(rm, 1, live[..., None].expand(r, c_live, s))
    else:
        live = torch.arange(c_total, device=base.device).expand(r, -1)
    v = _victims(spec, metric, tables, midx, vg, base, free, rg, rm, rp, ra, pid_c, cursor)
    rgl, rpl, kc = rg.long(), rp.long(), v["kc"]

    if migrate_fn is not None:
        g1, ok1, aw1, kw1, g2, ok2, aw2, kw2, ap, okp, kp = migrate_fn(
            base, free, f, v["base2"], v["free2"], v["f2"], rg.contiguous(),
            rp.contiguous(), kc.to(torch.int32),
        )
    else:
        # -- per-class row winners on the untouched cluster (once per event)
        p_ = mig.NUM_PROFILES
        rows_all, valid_all, anchors_all, mem_all = _class_tables(tables, midx)
        delta_all = None
        if spec.requires_delta_f:
            if delta_fn is not None:
                delta_all = torch.stack([
                    delta_fn(base, free, f,
                             torch.full((r,), p, dtype=torch.int32, device=base.device))
                    for p in range(p_)
                ], dim=1)
            else:
                delta_all = _delta_all(tables, midx, vg, metric, base, free, f, mem_all)
        aw, okw, kw = _refine_rows(
            spec, _feasible_all(base, rows_all, valid_all), free[:, None], mem_all,
            delta_all, anchors_all, cursor,
            torch.arange(num_gpus, device=base.device)[None, None], midx[None, None],
            num_gpus, return_keys=True,
        )                                                         # (R, P, M[, L])
        g1, ok1, g2, ok2 = lex_top2(kw, okw)                      # (R, P)
        aw1, aw2 = (torch.gather(aw, 2, g[..., None])[..., 0] for g in (g1, g2))
        kw1, kw2 = (torch.gather(kw, 2, g[..., None, None].expand(-1, -1, 1, kw.shape[-1]))
                    [:, :, 0] for g in (g1, g2))

        # -- per victim: refine its patched row -----------------------------
        ap, okp, kp = _refine_rows(
            spec, _feasible_patch(tables, v, rp), v["free2"], tables.profile_mem[kc, rpl],
            _delta_patch(tables, metric, v, rp) if spec.requires_delta_f else None,
            tables.profile_anchors[kc, rpl], cursor, rg, kc, num_gpus, return_keys=True,
        )

    # -- per victim: best untouched row (excluding its own GPU) -------------
    def at_class(t):  # (R, P, ...) -> (R, C, ...) at each victim's class
        idx = rpl.view(rpl.shape + (1,) * (t.dim() - 2)).expand(rpl.shape + t.shape[2:])
        return torch.gather(t, 1, idx)

    use2 = at_class(g1) == rgl                    # own GPU was the best row
    gu = torch.where(use2, at_class(g2), at_class(g1)).long()
    oku = torch.where(use2, at_class(ok2), at_class(ok1))
    au = torch.where(use2, at_class(aw2), at_class(aw1)).long()
    ku = torch.where(use2[..., None], at_class(kw2), at_class(kw1))

    # -- lex-merge the two row winners: (keys…, gpu) ------------------------
    ku_e = torch.where(oku[..., None], ku, BIG)
    kp_e = torch.where(okp[..., None], kp, BIG)
    lt = torch.zeros_like(oku)
    eq = torch.ones_like(oku)
    for i in range(ku.shape[-1]):
        lt = lt | (eq & (ku_e[..., i] < kp_e[..., i]))
        eq = eq & (ku_e[..., i] == kp_e[..., i])
    pick_u = oku & (lt | (eq & (gu < rgl)))
    return _choose(tables, midx, vg, metric, base, free, f, v, rg, rm, rp, ra, present,
                   want, torch.where(pick_u, gu, rgl), torch.where(pick_u, au, ap.long()),
                   oku | okp, live, cols)


class PolicyDecision(NamedTuple):
    """One placement decision, migration included (``-1`` where n/a)."""

    gpu: torch.Tensor
    anchor: torch.Tensor
    ok: torch.Tensor
    mig: torch.Tensor
    vic_gpu: torch.Tensor
    vic_anchor: torch.Tensor
    new_gpu: torch.Tensor
    new_anchor: torch.Tensor


def _workload_ring(spec: mig.ClusterSpec, workloads, s: int, device):
    """One replica's one-row ring holding ``workloads`` — ``(gpu, profile
    id, anchor)`` triples — as ``(ring_gpu, ring_mask, ring_pid,
    ring_aidx)`` of shapes ``(1, 1, C)`` and ``(1, 1, C, S)``."""
    wl = list(workloads) if workloads else []
    cols = max(1, len(wl))
    ring_gpu = np.zeros((1, 1, cols), np.int32)
    ring_mask = np.zeros((1, 1, cols, s), np.int32)
    ring_pid = np.zeros((1, 1, cols), np.int32)
    ring_aidx = np.zeros((1, 1, cols), np.int32)
    for i, (g, p, anchor) in enumerate(wl):
        prof = spec.model_of(int(g)).profiles[int(p)]
        ring_gpu[0, 0, i] = g
        ring_mask[0, 0, i, anchor:anchor + prof.mem] = 1
        ring_pid[0, 0, i] = p
        ring_aidx[0, 0, i] = prof.anchors.index(int(anchor))
    return tuple(torch.as_tensor(a, device=device)
                 for a in (ring_gpu, ring_mask, ring_pid, ring_aidx))


def policy_select_full(
    occ,
    profile_id: int,
    policy: PolicyLike,
    metric: str = "blocked",
    spec: Optional[mig.ClusterSpec] = None,
    cursor: int = 0,
    workloads: Optional[Sequence[Tuple[int, int, int]]] = None,
    device=None,
) -> PolicyDecision:
    """One placement decision on a raw occupancy ``(M, S)``, lowered
    exactly like the engine step (through the derived ``base``/``free``),
    defrag search included.

    ``workloads`` lists the running workloads as ``(gpu, profile_id,
    anchor)`` triples — the victims a defrag spec's migration search
    considers; it is ignored for other specs, and a defrag spec with no
    workloads has no migration candidates.
    """
    dev = resolve_device(device)
    pspec = resolve(policy, engine="batched")
    occ = torch.as_tensor(np.asarray(occ), dtype=torch.int32, device=dev)
    spec = spec if spec is not None else _default_spec(int(occ.shape[0]))
    tables = spec_tables(spec, dev)
    midx = torch.as_tensor(spec.model_index, device=dev).long()
    base = torch.einsum("ms,mns->mn", occ.to(torch.float32), tables.W[midx])[None]
    free = (tables.slices[midx] - occ.sum(dim=1, dtype=torch.int32))[None]
    vg = tables.V[midx]
    f = _frag_from_base(base, free, metric, vg)
    pid = torch.full((1,), int(profile_id), dtype=torch.int32, device=dev)
    cur = torch.full((1,), int(cursor), dtype=torch.int32, device=dev)
    gpu, aidx, ok = _select(pspec, base, free, f, metric, tables, midx, vg, pid, cur)
    neg1 = torch.full((1,), -1, dtype=torch.int32, device=dev)
    mig_out = (torch.zeros((1,), dtype=torch.bool, device=dev), neg1, neg1, neg1, neg1)
    if pspec.defrag:
        ring = _workload_ring(spec, workloads, int(tables.W.shape[2]), dev)
        res = _migrate_search(pspec, metric, tables, midx, vg, base, free, f, *ring,
                              pid, cur, want=~ok)
        gpu = torch.where(res.mig, res.gpu.long(), gpu)
        aidx = torch.where(res.mig, res.aidx.long(), aidx)
        ok = ok | res.mig
        mig_out = (res.mig,) + tuple(
            torch.where(res.mig, x, neg1)
            for x in (res.vic_gpu, res.vic_anchor, res.new_gpu, res.new_anchor)
        )
    anchor = torch.where(ok, tables.profile_anchors[midx[gpu], pid.long(), aidx], -1)
    return PolicyDecision(
        torch.where(ok, gpu, -1)[0].to(torch.int32), anchor[0].to(torch.int32), ok[0],
        *(x[0] for x in mig_out),
    )


def policy_select(
    occ,
    profile_id: int,
    policy: PolicyLike,
    metric: str = "blocked",
    spec: Optional[mig.ClusterSpec] = None,
    cursor: int = 0,
    workloads: Optional[Sequence[Tuple[int, int, int]]] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One placement decision on a raw occupancy: ``(gpu, anchor, accepted)``
    (``workloads`` as in :func:`policy_select_full`)."""
    d = policy_select_full(
        occ, profile_id, policy, metric=metric, spec=spec, cursor=cursor,
        workloads=workloads, device=device,
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
    ring_pid: Optional[torch.Tensor] = None   # (R, K+2, E) int32 — defrag specs only
    ring_aidx: Optional[torch.Tensor] = None  # (R, K+2, E) int32 — defrag specs only
    # wait ring (queued protocol only, else None): parked rejected arrivals,
    # -1 pid marks a free slot.  Each entry keeps its original expiry-ring
    # coordinates and absolute end slot; a wait-admit commits with them
    # unchanged (admission is legal only while end > t, so the row is still
    # less than one ring revolution ahead and the column collision-free).
    wait_pid: Optional[torch.Tensor] = None   # (R, Q) int32 — demand class, -1 = free
    wait_arr: Optional[torch.Tensor] = None   # (R, Q) int32 — arrival slot
    wait_end: Optional[torch.Tensor] = None   # (R, Q) int32 — absolute lease deadline
    wait_row: Optional[torch.Tensor] = None   # (R, Q) int32 — original expiry-ring row
    wait_col: Optional[torch.Tensor] = None   # (R, Q) int32 — original expiry-ring column
    wait_prio: Optional[torch.Tensor] = None  # (R, Q) int32 — priority class
    wait_ten: Optional[torch.Tensor] = None   # (R, Q) int32 — tenant id
    wait_eidx: Optional[torch.Tensor] = None  # (R, Q) int32 — original event index
    ev: Optional[torch.Tensor] = None         # (R,) int32 — running event index
    # faulted protocol only (else None): GPU availability, the ring planes
    # that let an eviction re-queue a live entry with its whole identity,
    # and the wait ring's retry and backoff bookkeeping
    up: Optional[torch.Tensor] = None         # (R, M) bool — GPU accepting placements
    ring_end: Optional[torch.Tensor] = None   # (R, K+2, E) int32 — absolute lease deadline
    ring_eidx: Optional[torch.Tensor] = None  # (R, K+2, E) int32 — original event index
    ring_prio: Optional[torch.Tensor] = None  # (R, K+2, E) int32 — priority class
    ring_ten: Optional[torch.Tensor] = None   # (R, K+2, E) int32 — tenant id
    wait_try: Optional[torch.Tensor] = None   # (R, Q) int32 — re-queue attempts so far
    wait_rdy: Optional[torch.Tensor] = None   # (R, Q) int32 — earliest admission slot


class EventStream(NamedTuple):
    """Host-precomputed per-event inputs, each ``(E_max, R)`` numpy."""

    pid: np.ndarray        # profile id, -1 for heartbeat/padding lanes
    exp_row: np.ndarray    # ring row (end_slot % K; trash row for padding)
    exp_col: np.ndarray    # ring column (host-assigned, collision-free)
    drain_row: np.ndarray  # ring row to drain when new_slot
    new_slot: np.ndarray   # first event of its slot (drain + maybe sample)
    sample: np.ndarray     # sample metrics of the just-finished slot
    measuring: np.ndarray  # arrival inside the measurement window
    # queued protocol only (None otherwise; shipped to the device):
    slot: Optional[np.ndarray] = None    # int32 — event slot (the wait stage's clock)
    end: Optional[np.ndarray] = None     # int32 — absolute end slot of the arrival
    prio: Optional[np.ndarray] = None    # int32 — priority class of the arrival
    tenant: Optional[np.ndarray] = None  # int32 — tenant id of the arrival
    wlive: Optional[np.ndarray] = None   # bool — real event (not padding/sentinel)
    # faulted protocol only, ``(E_max, R, M)``: set on the first event of
    # each slot only, so each slot's fail/recover set applies once
    fail: Optional[np.ndarray] = None     # bool — GPU m fails at this slot
    recover: Optional[np.ndarray] = None  # bool — GPU m recovers at this slot


class EventMeta(NamedTuple):
    """Host-only per-event annotations, ``(E_max, R)``."""

    slot: np.ndarray  # arrival/heartbeat slot (total_slots for padding)
    end: np.ndarray   # absolute end slot of the arrival (0 for non-arrivals)


class EventTrace(NamedTuple):
    """Per-event outputs, each ``(E_max, R)`` (torch on the device while
    the engine runs, numpy after :func:`trace_to_numpy`).  Fields past
    ``aidx`` exist where the protocol or spec produces them and are
    ``None`` otherwise, as in the reference: the slot-boundary metrics
    for the steady protocols, the ``post_*`` metrics for the cumulative
    one, the ``mig*`` fields for defrag specs, ``parked`` / ``wadm_*``
    for the queued protocols and ``evicted`` / ``evict_*`` for the faulted
    one."""

    ok: object        # bool — arrival accepted
    gpu: object       # int32 — chosen GPU (0 when not accepted)
    aidx: object      # int32 — chosen anchor index (unmasked)
    free_sum: object = None  # int32 — Σ free slices at slot boundary (pre-drain)
    active: object = None    # int32 — active-GPU count at slot boundary (pre-drain)
    frag: object = None      # float32 — cluster-mean F at slot boundary (pre-drain)
    post_free: object = None    # int32 — Σ free slices after the commit
    post_active: object = None  # int32 — active-GPU count after the commit
    post_frag: object = None    # float32 — cluster-mean F after the commit
    mig: object = None              # bool — a migration was committed
    mig_from_gpu: object = None     # int32 — victim's old GPU (-1 when no mig)
    mig_from_anchor: object = None  # int32 — victim's old anchor value
    mig_to_gpu: object = None       # int32 — victim's new GPU
    mig_to_anchor: object = None    # int32 — victim's new anchor value
    parked: object = None     # bool — the rejected arrival entered the wait ring
    wadm_eidx: object = None  # int32 — original event index of the wait-admit (-1 none)
    wadm_gpu: object = None   # int32 — the wait-admit's GPU (-1 none)
    wadm_aidx: object = None  # int32 — the wait-admit's anchor index (-1 none)
    evicted: object = None     # int32 — live entries evicted by failing GPUs
    evict_lost: object = None  # int32 — evictions lost (wait ring full, no retry budget)
    evict_esum: object = None  # int32 — Σ original event indexes of the evictions


_TRACE_DTYPES = dict(
    ok=torch.bool, gpu=torch.int32, aidx=torch.int32, free_sum=torch.int32,
    active=torch.int32, frag=torch.float32, post_free=torch.int32,
    post_active=torch.int32, post_frag=torch.float32, mig=torch.bool,
    mig_from_gpu=torch.int32, mig_from_anchor=torch.int32, mig_to_gpu=torch.int32,
    mig_to_anchor=torch.int32, parked=torch.bool, wadm_eidx=torch.int32,
    wadm_gpu=torch.int32, wadm_aidx=torch.int32, evicted=torch.int32,
    evict_lost=torch.int32, evict_esum=torch.int32,
)


def _trace_fields(proto: Protocol, pspec: PolicySpec) -> Tuple[str, ...]:
    """The trace fields a protocol and spec produce, in field order."""
    names = ["ok", "gpu", "aidx"]
    if proto.boundary_metrics:
        names += ["free_sum", "active", "frag"]
    if proto.post_metrics:
        names += ["post_free", "post_active", "post_frag"]
    if pspec.defrag:
        names += ["mig", "mig_from_gpu", "mig_from_anchor", "mig_to_gpu", "mig_to_anchor"]
    if proto.queued:
        names += ["parked", "wadm_eidx", "wadm_gpu", "wadm_aidx"]
    if proto.faulted:
        names += ["evicted", "evict_lost", "evict_esum"]
    return tuple(names)


def _init_state(tables: SpecTables, midx: torch.Tensor, runs: int,
                ring_rows: int, ring_cols: int, track_occ: bool,
                track_alloc: bool, wait_slots: int = 0,
                faulted: bool = False) -> ReplicaState:
    """The initial state; the faulted protocol tracks every live entry's
    whole identity on the ring (class and anchor planes too), so that an
    eviction can re-queue it."""
    dev = tables.W.device
    num_gpus = midx.shape[0]
    n, s = tables.W.shape[1], tables.W.shape[2]
    i32 = dict(dtype=torch.int32, device=dev)
    track_alloc = track_alloc or faulted
    st = ReplicaState(
        occ=torch.zeros((runs, num_gpus, s), **i32) if track_occ else None,
        base=torch.zeros((runs, num_gpus, n), dtype=torch.float32, device=dev),
        free=tables.slices[midx].to(torch.int32).expand(runs, num_gpus).clone(),
        f=torch.zeros((runs, num_gpus), dtype=torch.float32, device=dev),
        rr=torch.zeros((runs,), **i32),
        ring_gpu=torch.zeros((runs, ring_rows, ring_cols), **i32),
        ring_mask=torch.zeros((runs, ring_rows, ring_cols, s), **i32),
        ring_pid=torch.zeros((runs, ring_rows, ring_cols), **i32) if track_alloc else None,
        ring_aidx=torch.zeros((runs, ring_rows, ring_cols), **i32) if track_alloc else None,
    )
    if not wait_slots:
        return st
    fault_only = () if faulted else ("wait_try", "wait_rdy")
    wait = {name: torch.zeros((runs, wait_slots), **i32)
            for name in ReplicaState._fields
            if name.startswith("wait_") and name not in fault_only}
    wait["wait_pid"].fill_(-1)
    st = st._replace(ev=torch.zeros((runs,), **i32), **wait)
    if not faulted:
        return st
    ring = {name: torch.zeros((runs, ring_rows, ring_cols), **i32)
            for name in ("ring_end", "ring_eidx", "ring_prio", "ring_ten")}
    return st._replace(up=torch.ones((runs, num_gpus), dtype=torch.bool, device=dev), **ring)


def _occ_from_ring(st: ReplicaState, num_gpus: int) -> torch.Tensor:
    """Occupancy rebuilt from the expiry ring: in every protocol each
    running workload is one live ring entry (drained, stale, evicted and
    trash entries hold zero masks; parked requests hold none, and a failed
    GPU holds no live entry)."""
    r, rows, cols, s = st.ring_mask.shape
    occ = torch.zeros((r * num_gpus, s), dtype=torch.int32, device=st.base.device)
    rows_of = torch.arange(r, device=occ.device)[:, None, None] * num_gpus + st.ring_gpu
    occ.index_add_(0, rows_of.reshape(-1).long(), st.ring_mask.reshape(-1, s))
    return occ.view(r, num_gpus, s)


def state_from_numpy(d: Mapping[str, np.ndarray], device) -> ReplicaState:
    """A :class:`ReplicaState` from numpy arrays keyed by field name — e.g.
    the reference's vmapped ``ReplicaState`` after ``jax.device_get``.
    Every field present is carried (``ring_pid``/``ring_aidx`` of defrag
    specs, the wait ring with ``ev`` of the queued protocols, ``up``, the
    ``ring_end/eidx/prio/ten`` planes and ``wait_try/rdy`` of the faulted
    one); a missing field stays ``None``.  A missing ``occ`` is rebuilt
    from the expiry ring."""
    dev = torch.device(device)
    fields = {
        name: None if d.get(name) is None else torch.from_numpy(np.array(d[name])).to(dev)
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
    *measure* the just-finished slot (steady protocols), *expire* this
    slot's ring row, *fault* (faulted: this slot's failures and
    recoveries), *wait* (queued: admit the wait ring's head ahead of the
    arrival), *select*, *migrate* (defrag specs, on reject), *commit*,
    *park* (queued: a rejected arrival enters the wait ring) and *measure*
    the post-commit state (cumulative).  ``frag_fn``/``delta_fn``/
    ``select_fn``/``migrate_fn`` route the stages through the CUDA kernels
    when set.
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
    migrate_fn: Optional[object] = None
    wait_patience: int = 0    # queued protocol: max slots a request may wait

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
        if self.protocol.faulted:
            # btable[k]: the wait after re-queue attempt k (1-based),
            # fault_backoff · 2^(k-1), clamped at the retry budget
            b, r = self.protocol.fault_backoff, self.protocol.fault_retries
            self.btable = torch.tensor([b * 2 ** max(0, k - 1) for k in range(r + 2)],
                                       dtype=torch.int32, device=dev)

    def _rescore(self, st: ReplicaState, idx) -> torch.Tensor:
        """F of the GPUs at ``idx`` (an advanced index into the (R, M) axes)."""
        if self.frag_fn is not None:
            occ = st.occ[idx]
            return self.frag_fn(occ.reshape(-1, occ.shape[-1])).view(occ.shape[:-1])
        gi = idx[1]
        return _frag_from_base(st.base[idx], st.free[idx], self.metric, self.vg[gi])

    def _measure(self, st: ReplicaState):
        """Cluster metrics of the current state: ``(frag, free_sum, active)``
        — the slot-boundary measure of the steady protocols (state == end
        of slot t-1) and the post-commit measure of the cumulative one."""
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

    def _stage_fault(self, st: ReplicaState, fail, rec, t):
        """Faulted protocol: apply this slot's fail/recover lanes ``(R, M)``.

        Runs after the expire drain (a lease ending the very slot its GPU
        dies still completes) and before the wait stage.  A failing GPU is
        cleared wholesale: every live allocation is a ring entry, so zeroing
        its occupancy, window counts and F and restoring its free slices
        equals releasing each eviction; ``up`` masks it out of feasibility
        until its recover lane.  The evicted entries re-queue into the wait
        ring in flat ``(row, col)`` ring order: the k-th eviction takes the
        k-th free wait slot, and whatever exceeds the free slots (everything
        when the retry budget is zero) is a final loss.  Returns ``(evicted,
        evict_lost, evict_esum)``, each ``(R,)`` int32.
        """
        st.up.copy_((st.up | rec) & ~fail)
        r, rows, cols = st.ring_gpu.shape
        live = st.ring_mask.sum(dim=-1) > 0                              # (R, K+2, E)
        evict = torch.gather(fail, 1, st.ring_gpu.view(r, -1).long()).view(r, rows, cols) & live
        if st.occ is not None:
            st.occ.masked_fill_(fail[..., None], 0)
        st.base.masked_fill_(fail[..., None], 0.0)
        st.free.copy_(torch.where(fail, self.slices_g, st.free))
        st.f.masked_fill_(fail, 0.0)
        st.ring_mask.masked_fill_(evict[..., None], 0)
        ev_flat = evict.view(r, -1)                                      # flat (row, col) order
        n_ev = ev_flat.sum(dim=1, dtype=torch.int32)
        esum = (st.ring_eidx.view(r, -1) * ev_flat).sum(dim=1, dtype=torch.int32)
        if self.protocol.fault_retries < 1:
            return n_ev, n_ev, esum  # no retry budget: every eviction is lost

        # wait slot j, the pos-th free one, takes the eviction of rank pos:
        # the first flat ring index where the running eviction count
        # reaches pos + 1 (a gather per field, no scatter)
        free = st.wait_pid < 0
        pos = torch.cumsum(free, dim=1, dtype=torch.int32) - 1             # (R, Q)
        take = free & (pos < n_ev[:, None])
        cum = torch.cumsum(ev_flat, dim=1, dtype=torch.int32)             # (R, C)
        src = torch.searchsorted(cum, pos + 1).clamp_(max=cum.shape[1] - 1)

        def put(plane, v):
            plane.copy_(torch.where(take, v, plane))

        for plane, ring in ((st.wait_pid, st.ring_pid), (st.wait_end, st.ring_end),
                            (st.wait_prio, st.ring_prio), (st.wait_ten, st.ring_ten),
                            (st.wait_eidx, st.ring_eidx)):
            put(plane, torch.gather(ring.view(r, -1), 1, src))
        src32 = src.to(torch.int32)
        put(st.wait_row, src32 // cols)
        put(st.wait_col, src32 % cols)
        put(st.wait_arr, t[:, None])
        put(st.wait_try, 1)
        put(st.wait_rdy, t[:, None] + self.protocol.fault_backoff)  # btable[1]
        return n_ev, n_ev - take.sum(dim=1, dtype=torch.int32), esum

    def _stage_select(self, st: ReplicaState, pid_c, valid):
        """Place (or reject) the arrival; ``pid == -1`` lanes still select
        with ``pid_c = 0`` and are masked by ``valid`` (as in the reference)."""
        gpu, aidx, ok = _select(
            self.spec, st.base, st.free, st.f, self.metric, self.tables,
            self.midx, self.vg, pid_c, st.rr, delta_fn=self.delta_fn,
            select_fn=self.select_fn, gpu_ok=st.up,
        )
        return gpu, aidx, ok & valid

    def _stage_migrate(self, st: ReplicaState, pid_c, valid, gpu, aidx, ok):
        """Defrag search on reject; applies the victim's move in place.  Its
        old and new GPU may be the same, so the two updates run in turn."""
        res = _migrate_search(
            self.spec, self.metric, self.tables, self.midx, self.vg,
            st.base, st.free, st.f, st.ring_gpu, st.ring_mask, st.ring_pid,
            st.ring_aidx, pid_c, st.rr, want=valid & ~ok, delta_fn=self.delta_fn,
            migrate_fn=self.migrate_fn,
        )
        mi = res.mig.to(torch.int32)
        old = (self.ridx, res.vic_gpu.long())
        new = (self.ridx, res.new_gpu.long())
        st.base[old] -= res.old_mwin * res.mig.to(torch.float32)[:, None]
        st.base[new] += res.new_mwin * res.mig.to(torch.float32)[:, None]
        st.free[old] += res.old_mask.sum(dim=-1, dtype=torch.int32) * mi
        st.free[new] -= res.new_mask.sum(dim=-1, dtype=torch.int32) * mi
        if st.occ is not None:
            st.occ[old] -= res.old_mask * mi[:, None]
            st.occ[new] += res.new_mask * mi[:, None]
        rc = (self.ridx, res.vic_row.long(), res.vic_col.long())
        st.ring_mask[rc] += (res.new_mask - res.old_mask) * mi[:, None]
        st.ring_gpu[rc] = torch.where(res.mig, res.new_gpu, st.ring_gpu[rc])
        st.ring_aidx[rc] = torch.where(res.mig, res.new_aidx, st.ring_aidx[rc])
        gpu = torch.where(res.mig, res.gpu.long(), gpu)
        aidx = torch.where(res.mig, res.aidx.long(), aidx)
        return gpu, aidx, ok | res.mig, res

    def _stage_commit(self, st: ReplicaState, pid_c, gpu, aidx, ok, exp_row, exp_col,
                      mig_res: Optional[MigrationResult] = None, meta=None) -> None:
        """Commit the accepted placement: occupancy/window/free updates, the
        rescore of the touched row (and of a migrated victim's landing GPU),
        the cursor and the expiry-ring insert.  A replica that does not
        accept adds zero masks at GPU 0 and ring cell ``(exp_row, exp_col)``
        and rescores GPU 0 to its unchanged value, as in the reference.
        ``meta`` (faulted protocol: ``(end, prio, ten, eidx)``, each
        ``(R,)``) writes the entry's identity into the ring's fault planes."""
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
        if mig_res is not None:  # the victim's old GPU is gpu_c
            land = (self.ridx, torch.where(mig_res.mig, mig_res.new_gpu.long(), gpu_c))
            st.f[land] = self._rescore(st, land)
        if self.spec.stateful_cursor:  # advance the cursor past the chosen GPU
            nxt = ((gpu_c + 1) % self.midx.shape[0]).to(torch.int32)
            st.rr.copy_(torch.where(ok, nxt, st.rr))
        ring = (self.ridx, exp_row.long(), exp_col.long())
        st.ring_gpu[ring] = torch.where(ok, gpu_c.to(torch.int32), st.ring_gpu[ring])
        st.ring_mask[ring] += mask
        if st.ring_pid is not None:
            st.ring_pid[ring] = torch.where(ok, pid_c, st.ring_pid[ring])
            st.ring_aidx[ring] = torch.where(ok, aidx.to(torch.int32), st.ring_aidx[ring])
        if meta is not None:
            for plane, v in zip((st.ring_end, st.ring_prio, st.ring_ten, st.ring_eidx), meta):
                plane[ring] = torch.where(ok, v.to(torch.int32), plane[ring])

    def _stage_wait(self, st: ReplicaState, t, wlive):
        """Queued protocol: prune the wait ring, then try to admit its head.

        Entries whose lease deadline passed (``end <= t``) or whose wait
        exceeded the patience budget are dropped (final rejects).  Among
        the survivors the head is the lexicographic minimum of the spec's
        queue order (:func:`repro_torch.core.policy.queue_order`), the
        original event index breaking ties FIFO.  The head re-enters the
        spec's selection and, on acceptance, commits with its original ring
        coordinates.  ``wlive`` gates the stage to real events.  The head's
        index ``j (R,)`` stays on the device: every read and write goes
        through it as a gather or a scatter.  Under the faulted protocol a
        patience overrun re-arms with exponential backoff while the retry
        budget and the lease allow it (a final drop only past the budget),
        and the head is chosen among entries whose backoff ended
        (``wait_rdy <= t``).  Returns ``(eidx, gpu, aidx, ok_w)``, each
        ``(R,)``.
        """
        wl = wlive[:, None]
        tq = t[:, None]
        present = st.wait_pid >= 0
        age = tq - st.wait_arr                                          # (R, Q)
        if self.protocol.faulted:
            overdue = wl & present & (age > self.wait_patience)
            rearm = overdue & (st.wait_try < self.protocol.fault_retries) & (st.wait_end > tq)
            drop = wl & present & ((st.wait_end <= tq) | (overdue & ~rearm))
            keep = present & ~drop
            st.wait_arr.copy_(torch.where(rearm, tq, st.wait_arr))
            st.wait_try.add_(rearm.to(torch.int32))
            wait = self.btable[st.wait_try.clamp(0, self.btable.shape[0] - 1).long()]
            st.wait_rdy.copy_(torch.where(rearm, tq + wait, st.wait_rdy))
            mask = keep & wl & (st.wait_rdy <= tq)
        else:
            drop = wl & ((st.wait_end <= tq) | (age > self.wait_patience))
            keep = present & ~drop
            mask = keep & wl
        for key in queue_order(self.spec):
            base_k = key_base(key)
            if base_k == "priority":
                val = st.wait_prio.to(torch.float32)
            elif base_k == "wait-age":
                val = age.to(torch.float32)
            else:  # tenant
                val = st.wait_ten.to(torch.float32)
            if key.startswith("-"):
                val = -val
            masked = torch.where(mask, val, BIG)
            mask = mask & (masked == masked.amin(dim=1, keepdim=True))
        fifo = torch.where(mask, st.wait_eidx, 2**31 - 1)
        j = first_true(fifo == fifo.amin(dim=1, keepdim=True))         # (R,)
        head = mask.any(dim=1)
        at = (self.ridx, j)

        pid_w = st.wait_pid[at].clamp(min=0)
        gpu, aidx, sel_ok = _select(
            self.spec, st.base, st.free, st.f, self.metric, self.tables,
            self.midx, self.vg, pid_w, st.rr, delta_fn=self.delta_fn,
            select_fn=self.select_fn, gpu_ok=st.up,
        )
        ok_w = sel_ok & head
        meta = None
        if self.protocol.faulted:
            meta = (st.wait_end[at], st.wait_prio[at], st.wait_ten[at], st.wait_eidx[at])
        self._stage_commit(st, pid_w, gpu, aidx, ok_w, st.wait_row[at], st.wait_col[at],
                           meta=meta)
        st.wait_pid.copy_(torch.where(keep, st.wait_pid, -1))
        st.wait_pid[at] = torch.where(ok_w, -1, st.wait_pid[at])
        eidx = torch.where(ok_w, st.wait_eidx[at], -1)
        return eidx, gpu.to(torch.int32), aidx.to(torch.int32), ok_w

    def _stage_park(self, st: ReplicaState, can, values) -> None:
        """Insert a rejected arrival into the first free wait-ring slot;
        ``can`` already folds in validity, rejection and free capacity, and
        ``values`` maps each wait field to the arrival's ``(R,)`` value."""
        at = (self.ridx, first_true(st.wait_pid < 0))
        for name, v in values.items():
            plane = getattr(st, name)
            plane[at] = torch.where(can, v, plane[at])

    def step(self, st: ReplicaState, x) -> EventTrace:
        """One event for every replica; returns this event's trace row."""
        pid, exp_row, exp_col, drain_row, new_slot = x[:5]
        row = {}
        if self.protocol.boundary_metrics:
            row["frag"], row["free_sum"], row["active"] = self._measure(st)
        self._stage_expire(st, drain_row, new_slot)
        if self.protocol.queued:
            t, end, prio, ten, wlive = x[5:10]
        if self.protocol.faulted:  # after expire: same-slot completions win
            row["evicted"], row["evict_lost"], row["evict_esum"] = self._stage_fault(
                st, x[10], x[11], t)
        if self.protocol.queued:  # waiting requests admit ahead of the arrival
            row["wadm_eidx"], wadm_gpu, wadm_aidx, ok_w = self._stage_wait(st, t, wlive)
            row["wadm_gpu"] = torch.where(ok_w, wadm_gpu, -1)
            row["wadm_aidx"] = torch.where(ok_w, wadm_aidx, -1)
        valid = pid >= 0
        pid_c = pid.clamp(min=0)
        gpu, aidx, ok = self._stage_select(st, pid_c, valid)
        mig_res = None
        if self.spec.defrag:
            gpu, aidx, ok, mig_res = self._stage_migrate(st, pid_c, valid, gpu, aidx, ok)
        meta = (end, prio, ten, st.ev) if self.protocol.faulted else None
        self._stage_commit(st, pid_c, gpu, aidx, ok, exp_row, exp_col, mig_res, meta=meta)
        if self.protocol.queued:
            parked = valid & ~ok & wlive & (st.wait_pid < 0).any(dim=1)
            values = dict(wait_pid=pid_c, wait_arr=t, wait_end=end, wait_row=exp_row,
                          wait_col=exp_col, wait_prio=prio, wait_ten=ten, wait_eidx=st.ev)
            if self.protocol.faulted:  # fresh parks: no retry used, no backoff
                values.update(wait_try=torch.zeros_like(t), wait_rdy=t)
            self._stage_park(st, parked, values)
            st.ev.add_(1)
            row["parked"] = parked
        if self.protocol.post_metrics:
            row["post_frag"], row["post_free"], row["post_active"] = self._measure(st)
        if mig_res is not None:
            m = mig_res.mig
            row["mig"] = m
            for name, val in (("mig_from_gpu", mig_res.vic_gpu),
                              ("mig_from_anchor", mig_res.vic_anchor),
                              ("mig_to_gpu", mig_res.new_gpu),
                              ("mig_to_anchor", mig_res.new_anchor)):
                row[name] = torch.where(m, val, -1)
        return EventTrace(
            ok=ok, gpu=torch.where(ok, gpu.long(), 0).to(torch.int32),
            aidx=aidx.to(torch.int32), **row,
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
    wait_slots: int = 0,
    wait_patience: int = 0,
    midx: Optional[torch.Tensor] = None,
    tables: Optional[SpecTables] = None,
) -> EngineCore:
    """Validate one engine configuration and build its staged core.

    The one construction path of :func:`_simulate`, :func:`simulate_chunked`
    and :func:`init_carry`.  The queued protocols refuse defrag specs and
    need ``wait_slots > 0``, as in the reference.  Kernel dispatch under
    ``use_kernel``: the
    occupancy-based ``fragscore`` rescore needs one placement table, so it
    runs on homogeneous fleets only; specs whose keys consume ΔF get the
    ``delta_from_base`` kernel; argmin-fusable specs run the whole select
    stage (the wait head's too) in ``select_from_base`` and, for defrag
    specs, both refinements of the migrate search in ``migrate_refine`` (a
    delta-only defrag spec keeps ``delta_from_base`` and the plain migrate
    search).  Under the faulted protocol the select stage stays plain torch,
    since the fused kernel cannot see the up-mask; ``delta_from_base`` and
    ``fragscore`` still apply.
    """
    dev = torch.device(device)
    pspec = resolve(policy, engine="batched")
    proto = resolve_protocol(protocol)
    if proto.queued:
        if pspec.defrag:
            raise ValueError(
                f"policy {pspec.name!r}: defrag specs are not supported under "
                "the queued protocol (the migrate stage's victim table does "
                "not cover parked requests)"
            )
        if wait_slots <= 0:
            raise ValueError(
                f"protocol {proto.name!r} needs wait_slots > 0 "
                "(SimConfig.wait_capacity)"
            )
    if tables is None:  # homogeneous A100-80GB default
        cspec = _default_spec(num_gpus)
        tables = spec_tables(cspec, dev)
        midx = torch.as_tensor(cspec.model_index, device=dev)
    frag_fn = delta_fn = select_fn = migrate_fn = None
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
        # the fused select kernel cannot see the faulted protocol's
        # up-mask, so faulted runs keep the plain argmin (as the reference)
        if pspec.fused_argmin and not proto.faulted:
            select_fn = make_select_fn(kspec, pspec, metric, dev)
            if pspec.defrag:
                migrate_fn = make_migrate_fn(kspec, pspec, metric, dev)
    return EngineCore(
        spec=pspec, protocol=proto, metric=metric, tables=tables,
        midx=midx.to(dev).long(), runs=runs, frag_fn=frag_fn,
        delta_fn=delta_fn, select_fn=select_fn, migrate_fn=migrate_fn,
        wait_patience=wait_patience,
    )


def _simulate(events: EventStream, **kwargs) -> Tuple[ReplicaState, EventTrace]:
    """Run the event loop over ``events`` (each field ``(E, R)``); takes
    :func:`_setup_run`'s arguments.

    The stream moves to the device once; the trace is written into
    preallocated device tensors; there is no host synchronisation inside
    the loop (:func:`_event_loop`).  ``state`` continues from a given
    replica state (updated in place), e.g. one carried over from the
    reference package.
    """
    core, state, xs, trace = _setup_run(events, **kwargs)
    _event_loop(core, state, xs, trace)
    return state, trace


def _stream_fields(proto: Protocol) -> Tuple[str, ...]:
    """The stream fields shipped to the device, in the step's order (the
    reference's ``_scan_xs``); ``sample``/``measuring`` stay on the host."""
    names = ("pid", "exp_row", "exp_col", "drain_row", "new_slot")
    if proto.queued:  # the wait stage's clock + per-arrival queue attributes
        names += ("slot", "end", "prio", "tenant", "wlive")
    if proto.faulted:  # per-slot GPU fail/recover lanes, (E, R, M)
        names += ("fail", "recover")
    return names


def _setup_run(
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
    wait_slots: int = 0,
    wait_patience: int = 0,
    midx: Optional[torch.Tensor] = None,
    tables: Optional[SpecTables] = None,
    state: Optional[ReplicaState] = None,
    device=None,
):
    """Everything of a run before its event loop: the staged core, the
    replica state, the event stream on the device and the empty trace,
    ``(core, state, xs, trace)``."""
    dev = resolve_device(device)
    runs = events.pid.shape[1]
    core = _build_core(
        policy=policy, metric=metric, num_gpus=num_gpus, use_kernel=use_kernel,
        runs=runs, device=dev, kernel_spec=kernel_spec, protocol=protocol,
        wait_slots=wait_slots, wait_patience=wait_patience, midx=midx, tables=tables,
    )
    state = _prepare_state(core, state, ring_rows, ring_cols, wait_slots)
    xs = [_on_device(getattr(events, name), dev) for name in _stream_fields(core.protocol)]
    return core, state, xs, _empty_trace(core, xs[0].shape[0], dev)


def _on_device(a, dev: torch.device) -> torch.Tensor:
    """A stream field on ``dev``: a tensor already there as is, else a copy."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.as_tensor(np.ascontiguousarray(a)).to(dev)


def _prepare_state(core: EngineCore, state: Optional[ReplicaState], ring_rows: int,
                   ring_cols: int, wait_slots: int) -> ReplicaState:
    """The initial state of ``core``'s configuration, or ``state`` checked
    against it, with its occupancy dropped or rebuilt as the core needs."""
    track_occ = core.frag_fn is not None
    if state is None:
        return _init_state(core.tables, core.midx, core.runs, ring_rows, ring_cols,
                           track_occ, track_alloc=core.spec.defrag,
                           wait_slots=wait_slots if core.protocol.queued else 0,
                           faulted=core.protocol.faulted)
    if core.spec.defrag and state.ring_pid is None:
        raise ValueError(
            f"policy {core.spec.name!r}: a defrag spec continues only from a state "
            "with the ring_pid/ring_aidx allocation planes"
        )
    if core.protocol.queued and state.wait_pid is None:
        raise ValueError(
            f"protocol {core.protocol.name!r} continues only from a state with "
            "the wait ring (wait_* and ev)"
        )
    if core.protocol.faulted and state.up is None:
        raise ValueError(
            f"protocol {core.protocol.name!r} continues only from a state with "
            "the fault planes (up, ring_end/eidx/prio/ten, wait_try/rdy)"
        )
    if not track_occ:
        return state._replace(occ=None)
    if state.occ is None:
        return state._replace(occ=_occ_from_ring(state, core.midx.shape[0]))
    return state


def _empty_trace(core: EngineCore, events: int, device) -> EventTrace:
    """Preallocated ``(events, R)`` trace of the fields ``core`` produces."""
    return EventTrace(**{
        name: torch.empty((events, core.runs), dtype=_TRACE_DTYPES[name], device=device)
        for name in _trace_fields(core.protocol, core.spec)
    })


def _event_loop(core: EngineCore, state: ReplicaState, xs, trace: EventTrace) -> None:
    """Step every event of ``xs`` into ``trace``; nothing here waits for the
    device (``chip_smoke.py`` runs it under ``set_sync_debug_mode("error")``)."""
    _split_event_loop([(core, state, xs, trace)])


def _device_scope(dev: torch.device):
    """Make ``dev`` the current card while a block of replicas steps (the
    kernels' launchers set the thread's card); a no-op off CUDA."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _split_event_loop(blocks) -> None:
    """Step every event of each block's ``(core, state, xs, trace)``: one
    loop over the events, every block in turn within an event, each under
    its own card, so that every card has work queued; no host sync."""
    fields = [name for name in EventTrace._fields if getattr(blocks[0][3], name) is not None]
    split = len(blocks) > 1
    for e in range(blocks[0][2][0].shape[0]):
        for core, state, xs, trace in blocks:
            with _device_scope(core.midx.device) if split else contextlib.nullcontext():
                row = core.step(state, [x[e] for x in xs])
                for name in fields:
                    getattr(trace, name)[e] = getattr(row, name)


def trace_to_numpy(trace: EventTrace) -> EventTrace:
    """Fetch a device trace to the host (the run's one synchronisation)."""
    return EventTrace(*[None if t is None else t.cpu().numpy() for t in trace])


# ---------------------------------------------------------------------------
# Replica split across cards
# ---------------------------------------------------------------------------


def _visible_devices(dev: torch.device) -> List[torch.device]:
    """The devices a replica split may use: every card for a CUDA device,
    the one device otherwise."""
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _replica_devices(runs: int, shard: Optional[bool], device) -> Optional[List[torch.device]]:
    """The devices of a replica split, one per contiguous block of
    ``runs / D`` replicas, or ``None``: the reference's
    ``_replica_sharding`` rules and messages.  ``shard=None`` (auto) splits
    when more than one device is visible and ``runs`` divides evenly;
    ``True`` requires it (raises otherwise); ``False`` disables."""
    if shard is False:
        return None
    devices = _visible_devices(resolve_device(device))
    if len(devices) <= 1:
        if shard:
            raise ValueError("replica sharding requested but only one device is visible")
        return None
    if runs % len(devices) != 0:
        if shard:
            raise ValueError(f"runs={runs} does not divide across {len(devices)} devices")
        return None
    return devices


class ShardedStream(NamedTuple):
    """An event stream split along its replica axis: ``shards[i]`` holds
    replicas ``[i·R/D, (i+1)·R/D)`` of every field, as tensors on
    ``devices[i]``."""

    shards: Tuple[EventStream, ...]
    devices: Tuple[torch.device, ...]


def _blocks(runs: int, d: int):
    n = runs // d
    return [(i * n, (i + 1) * n) for i in range(d)]


def _split_field(a, lo: int, hi: int, dev: torch.device) -> Optional[torch.Tensor]:
    """Replicas ``lo:hi`` (axis 1) of a stream field, contiguous on ``dev``."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a[:, lo:hi].to(dev).contiguous()
    return torch.as_tensor(np.ascontiguousarray(a[:, lo:hi])).to(dev)


def _join_stream(events: ShardedStream) -> EventStream:
    """The whole host stream of a split one (numpy fields)."""
    return EventStream(*[
        None if getattr(events.shards[0], name) is None
        else np.concatenate([getattr(s, name).cpu().numpy() for s in events.shards], axis=1)
        for name in EventStream._fields
    ])


def shard_events(events, runs: int, shard: Optional[bool] = None, device=None):
    """Split the replica axis of an ``(E_max, R)`` event stream across the
    visible cards: a :class:`ShardedStream` of D contiguous blocks of R/D
    replicas, block i on card i, or ``events`` unchanged when there is no
    split (``shard`` as in :func:`_replica_devices`).  A stream already
    split onto the same devices comes back as is, with no copy."""
    if device is None and isinstance(events, ShardedStream):
        device = events.devices[0]
    devices = _replica_devices(runs, shard, device)
    if devices is None:
        return events
    if isinstance(events, ShardedStream):
        if events.devices == tuple(devices):
            return events
        events = _join_stream(events)
    return ShardedStream(
        shards=tuple(
            EventStream(*[_split_field(a, lo, hi, d) for a in events])
            for (lo, hi), d in zip(_blocks(runs, len(devices)), devices)),
        devices=tuple(devices),
    )


def _statics_on(kwargs: dict, dev: torch.device) -> dict:
    """A run's keyword arguments with its tables and model index on ``dev``."""
    out = dict(kwargs, device=dev)
    if kwargs.get("tables") is not None:
        out["tables"] = SpecTables(*[t.to(dev) for t in kwargs["tables"]])
    if kwargs.get("midx") is not None:
        out["midx"] = kwargs["midx"].to(dev)
    return out


def _split_state(state: ReplicaState, devices: Sequence[torch.device]) -> List[ReplicaState]:
    """A whole carry as D blocks of replicas, each a copy on its device."""
    runs = state.base.shape[0]
    return [ReplicaState(*[None if t is None else t[lo:hi].to(d, copy=True)
                           for t in state])
            for (lo, hi), d in zip(_blocks(runs, len(devices)), devices)]


def _join_state(states: Sequence[ReplicaState], dev: torch.device) -> ReplicaState:
    """The blocks' carries gathered in order into one carry on ``dev``."""
    return ReplicaState(*[
        None if parts[0] is None else torch.cat([t.to(dev) for t in parts])
        for parts in zip(*states)
    ])


def _join_traces(traces: Sequence[EventTrace], dev: torch.device) -> EventTrace:
    """The blocks' traces joined along the replica axis, in block order:
    numpy traces on the host, device traces on ``dev``."""
    def cat(parts):
        if isinstance(parts[0], np.ndarray):
            return np.concatenate(parts, axis=1)
        return torch.cat([t.to(dev) for t in parts], dim=1)

    return EventTrace(*[None if parts[0] is None else cat(parts) for parts in zip(*traces)])


def _simulate_split(events: ShardedStream, **kwargs) -> Tuple[ReplicaState, EventTrace]:
    """:func:`_simulate` over a split stream: each block builds its core,
    state and trace on its device, one event loop steps them all, and the
    run returns the carry gathered on the first device and the host trace
    joined along the replica axis."""
    blocks = [_setup_run(ev, **_statics_on(kwargs, d))
              for ev, d in zip(events.shards, events.devices)]
    _split_event_loop(blocks)
    first = events.devices[0]
    return (_join_state([b[1] for b in blocks], first),
            _join_traces([trace_to_numpy(b[3]) for b in blocks], first))


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


def presample_fault_slots(
    spec: mig.ClusterSpec,
    fault_model: mig.FaultModel,
    runs: int,
    total_slots: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-GPU alternating fail/recover slot tables, ``(runs, total_slots,
    M)`` bool each.

    Each GPU alternates ``Exp(mtbf)`` up-phases and ``Exp(mttr)``
    down-phases (per-model rates from :meth:`FaultModel.rates_for`), each
    phase ceiled to at least one slot, so fail and recover marks strictly
    alternate and never share a slot.  The draw order (replica, then GPU,
    then alternating phases) is the reference's, so a seeded ``rng`` gives
    its tables exactly.
    """
    m = spec.num_gpus
    rates = [fault_model.rates_for(spec.model_of(g).name) for g in range(m)]
    fail = np.zeros((runs, total_slots, m), dtype=bool)
    recover = np.zeros((runs, total_slots, m), dtype=bool)
    for r in range(runs):
        for g in range(m):
            mtbf, mttr = rates[g]
            t = 0.0
            while True:
                t += max(1.0, np.ceil(rng.exponential(mtbf)))
                if t >= total_slots:
                    break
                fail[r, int(t), g] = True
                t += max(1.0, np.ceil(rng.exponential(mttr)))
                if t >= total_slots:
                    break
                recover[r, int(t), g] = True
    return fail, recover


def presample_arrivals(
    cfg: SimConfig, runs: int, seed=None, queued: bool = False,
    fault_model: Optional[mig.FaultModel] = None,
) -> Tuple[EventStream, EventMeta, int, int]:
    """Build per-replica steady-protocol event streams on host.

    Returns ``(events, meta, ring_rows, ring_cols)``.  One event per
    Poisson arrival plus one heartbeat per empty slot (so consecutive
    events never skip a slot), plus a trailing sentinel that samples the
    final slot; streams are right-padded to the longest replica with no-op
    lanes.  The draws are the reference's, in the reference's order, so
    the streams are byte-identical to it.

    ``queued`` also fills the queued protocol's fields (the slot clock,
    absolute end slots, per-arrival tenant and priority, the live-event
    mask).  Tenant and priority are drawn strictly after the shared
    arrival stream, so every steady field is byte-identical with
    ``queued=False``.  ``fault_model`` (the faulted protocol, with
    ``queued``) also draws the per-GPU fail/recover lanes, strictly after
    every other draw, and puts each slot's lanes on the first event of that
    slot (sentinel and padding lanes carry none).
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

    queue = {}
    if queued:  # drawn after the shared stream: arrival sampling unchanged
        tenant = np.zeros((runs, e_max), dtype=np.int32)
        prio = np.zeros((runs, e_max), dtype=np.int32)
        for r in range(runs):
            sel = is_arrival[r]
            na = int(sel.sum())
            tenant[r, sel] = rng.integers(0, max(1, cfg.num_tenants), size=na)
            prio[r, sel] = rng.integers(0, max(1, cfg.num_priorities), size=na)
        wlive = slot < total_slots  # padding/sentinel lanes have no clock
        queue = dict(slot=slot.T.astype(np.int32), end=end.T.astype(np.int32),
                     prio=prio.T, tenant=tenant.T, wlive=wlive.T)
    if fault_model is not None:  # drawn strictly after every other draw
        spec = cfg.spec()
        fail_s, rec_s = presample_fault_slots(spec, fault_model, runs, total_slots, rng)
        m = spec.num_gpus
        fail = np.zeros((runs, e_max, m), dtype=bool)
        recover = np.zeros((runs, e_max, m), dtype=bool)
        first = new_slot & (slot < total_slots)  # sentinel/padding carry none
        rr_idx, ee_idx = np.nonzero(first)
        fail[rr_idx, ee_idx] = fail_s[rr_idx, slot[rr_idx, ee_idx]]
        recover[rr_idx, ee_idx] = rec_s[rr_idx, slot[rr_idx, ee_idx]]
        queue.update(fail=np.ascontiguousarray(fail.transpose(1, 0, 2)),
                     recover=np.ascontiguousarray(recover.transpose(1, 0, 2)))

    events = EventStream(
        pid=pid.T,
        exp_row=exp_row.T,
        exp_col=exp_col.T,
        drain_row=drain_row.T,
        new_slot=new_slot.T,
        sample=sample.T,
        measuring=measuring.T,
        **queue,
    )
    meta = EventMeta(slot=slot.T, end=end.T)
    return events, meta, ring_k + 2, ring_cols


def presample_cumulative(
    cfg: SimConfig, runs: int, seed=None
) -> Tuple[EventStream, EventMeta, int, int]:
    """Build per-replica cumulative-protocol event streams on host.

    One arrival per slot (no heartbeats, no padding), durations ``U[1,
    T]``.  Replica ``r`` draws from the host simulator's stream of run
    ``r`` (seed ``cfg.seed + r·9973``, profiles then durations), so
    :func:`run_batched` and :func:`repro_torch.sim.run_many` simulate the
    same arrivals per seed; the streams are byte-identical to the
    reference's.
    """
    base_seed = cfg.seed if seed is None else seed
    spec = cfg.spec()
    cap = spec.total_mem_slices
    probs = request_probs(cfg)
    mean_mem = distributions.mean_mem_from_probs(probs)
    T = int(np.ceil(cap / mean_mem))
    n = int(np.ceil(cfg.max_demand * cap / mean_mem)) + 20
    ring_k = T + 1

    pid = np.zeros((runs, n), dtype=np.int32)
    end = np.zeros((runs, n), dtype=np.int64)
    for r in range(runs):
        rng = np.random.default_rng(base_seed + r * 9973)
        pid[r] = distributions.sample_profile_probs(probs, n, rng)
        end[r] = np.arange(n) + rng.integers(1, T + 1, size=n)

    slot = np.tile(np.arange(n, dtype=np.int32), (runs, 1))
    new_slot = np.ones((runs, n), dtype=bool)
    exp_col, ring_cols = _ring_columns(np.ones_like(pid, bool), end, n + T + 1)
    exp_row = (end % ring_k).astype(np.int32)
    drain_row = (slot % ring_k).astype(np.int32)

    events = EventStream(
        pid=pid.T,
        exp_row=exp_row.T,
        exp_col=exp_col.T,
        drain_row=drain_row.T,
        new_slot=new_slot.T,
        sample=np.zeros((n, runs), dtype=bool),
        measuring=np.ones((n, runs), dtype=bool),
    )
    meta = EventMeta(slot=slot.T, end=end.T)
    return events, meta, ring_k + 2, ring_cols


# ---------------------------------------------------------------------------
# Chunked streaming driver: a staged host-to-device feed, the carry in place
# ---------------------------------------------------------------------------


def init_carry(
    runs: int,
    *,
    policy: PolicyLike,
    metric: str,
    num_gpus: int,
    ring_rows: int,
    ring_cols: int,
    use_kernel: bool = False,
    kernel_spec: Optional[mig.ClusterSpec] = None,
    protocol: Union[str, Protocol] = "steady",
    wait_slots: int = 0,
    wait_patience: int = 0,
    midx: Optional[torch.Tensor] = None,
    tables: Optional[SpecTables] = None,
    device=None,
) -> ReplicaState:
    """The initial carry of one configuration: the state :func:`_simulate`
    starts from (so chunking at any boundary is exact: the carry holds
    every datum that crosses events), and the template that
    :func:`load_stream_checkpoint` restores into."""
    dev = resolve_device(device)
    core = _build_core(
        policy=policy, metric=metric, num_gpus=num_gpus, use_kernel=use_kernel,
        runs=runs, device=dev, kernel_spec=kernel_spec, protocol=protocol,
        wait_slots=wait_slots, wait_patience=wait_patience, midx=midx, tables=tables,
    )
    return _prepare_state(core, None, ring_rows, ring_cols, wait_slots)


def save_stream_checkpoint(path, state: ReplicaState, events_done: int,
                           metadata: Optional[dict] = None) -> None:
    """Persist a chunked run's carry (a flat npz through
    :mod:`repro_torch.checkpoint.ckpt`, keyed as the reference keys it, so
    either package resumes the other's checkpoint).  ``events_done``, the
    events the carry has consumed, is the checkpoint's step: resume by
    presampling the same stream and calling :func:`simulate_chunked` with
    ``carry=state, start=events_done``."""
    from repro_torch.checkpoint import ckpt

    ckpt.save_checkpoint(path, state, step=int(events_done),
                         metadata={"kind": "replica-carry", **(metadata or {})})


def load_stream_checkpoint(path, template: ReplicaState) -> Tuple[ReplicaState, int]:
    """Restore a carry saved by :func:`save_stream_checkpoint` (or by the
    reference's) into the structure, dtypes and device of ``template``, an
    :func:`init_carry` of the same configuration: a carry of another
    policy, protocol or ring geometry raises.  Returns ``(state,
    events_done)``."""
    from repro_torch.checkpoint import ckpt

    return ckpt.load_checkpoint(path, template)


def _concat_traces(traces, concat):
    """Concatenate per-chunk :class:`EventTrace` s along the event axis
    (``concat`` is ``np.concatenate`` or ``torch.cat``); absent fields stay
    ``None``."""
    if len(traces) == 1:
        return traces[0]
    return EventTrace(*[
        None if getattr(traces[0], name) is None
        else concat([getattr(t, name) for t in traces], 0)
        for name in EventTrace._fields
    ])


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(a[:0]).dtype


class _Feed:
    """The host stream to the device, a chunk at a time.

    On a CUDA device a chunk is staged into one of two pinned host buffers
    and copied into one of two device buffers on a side stream
    (``non_blocking``), while the host enqueues the previous chunk's
    events.  The compute stream waits on the copy's event before it reads
    the chunk; the side stream waits for the compute stream to be done with
    a device buffer's previous chunk before it overwrites it.  On the CPU a
    chunk is a view of the host stream.
    """

    def __init__(self, host, rows: int, device: torch.device):
        self.host, self.dev = host, device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.side = torch.cuda.Stream(device)
            self.slots = [dict(
                pinned=[torch.empty((rows,) + a.shape[1:], dtype=_torch_dtype(a),
                                    pin_memory=True) for a in host],
                dev=[torch.empty((rows,) + a.shape[1:], dtype=_torch_dtype(a), device=device)
                     for a in host],
                copied=torch.cuda.Event(), consumed=None) for _ in range(2)]

    def put(self, k: int, lo: int, hi: int):
        """Stage chunk ``k`` (events ``lo:hi``): ``(xs, seconds, bytes)``."""
        n = hi - lo
        nbytes = sum(a[lo:hi].nbytes for a in self.host)
        t0 = time.perf_counter()
        if not self.cuda:
            return [torch.from_numpy(a[lo:hi]) for a in self.host], 0.0, nbytes
        slot = self.slots[k % 2]
        slot["copied"].synchronize()  # the pinned buffers' previous copy is done
        for p, a in zip(slot["pinned"], self.host):
            p[:n].numpy()[...] = a[lo:hi]
        with torch.cuda.stream(self.side):
            if slot["consumed"] is not None:
                self.side.wait_event(slot["consumed"])
            for d, p in zip(slot["dev"], slot["pinned"]):
                d[:n].copy_(p[:n], non_blocking=True)
            slot["copied"].record(self.side)
        return [d[:n] for d in slot["dev"]], time.perf_counter() - t0, nbytes

    def ready(self, k: int) -> None:
        """The compute stream waits for chunk ``k``'s copy."""
        if self.cuda:
            torch.cuda.current_stream(self.dev).wait_event(self.slots[k % 2]["copied"])

    def consumed(self, k: int) -> None:
        """Chunk ``k``'s events are enqueued: its device buffers are free
        once the compute stream gets here."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.dev))
            self.slots[k % 2]["consumed"] = ev


class _Drain:
    """The chunks' traces to the host.

    ``stream=True``: the rows end in host arrays.  On a CUDA device each
    chunk writes one of two device trace buffers, a side stream copies it
    into pinned buffers (``non_blocking``) once the chunk's events ran, and
    the host reads the copy, after its event, only once the next chunk is
    enqueued; on the CPU a chunk writes the host arrays directly.
    ``stream=False``: every chunk writes its rows of one device trace.
    """

    def __init__(self, core: EngineCore, total: int, rows: int, device: torch.device,
                 stream: bool, side=None):
        self.dev, self.stream, self.side = device, stream, side
        self.cuda = device.type == "cuda"
        self.pending = []
        if not stream:
            self.full = _empty_trace(core, total, device)
            return
        names = _trace_fields(core.protocol, core.spec)
        self.out = EventTrace(**{
            name: torch.empty((total, core.runs), dtype=_TRACE_DTYPES[name]).numpy()
            for name in names})
        if self.cuda:
            self.slots = [dict(
                dev=_empty_trace(core, rows, device),
                pinned=EventTrace(**{name: torch.empty((rows, core.runs),
                                                       dtype=_TRACE_DTYPES[name],
                                                       pin_memory=True) for name in names}),
                copied=None) for _ in range(2)]

    def trace(self, k: int, lo: int, hi: int) -> EventTrace:
        """Where chunk ``k``'s rows ``lo:hi`` (counted from the run's first
        event) go."""
        if not self.stream:
            return EventTrace(*[None if t is None else t[lo:hi] for t in self.full])
        if not self.cuda:
            return EventTrace(*[None if a is None else torch.from_numpy(a)[lo:hi]
                                for a in self.out])
        slot = self.slots[k % 2]
        if slot["copied"] is not None:  # the buffer's previous copy is done
            torch.cuda.current_stream(self.dev).wait_event(slot["copied"])
        return EventTrace(*[None if t is None else t[:hi - lo] for t in slot["dev"]])

    def ran(self, k: int, lo: int, hi: int) -> None:
        """Chunk ``k``'s events are enqueued: copy its trace out."""
        if not (self.stream and self.cuda):
            return
        slot, n = self.slots[k % 2], hi - lo
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(self.side):
            self.side.wait_event(ev)
            for p, d in zip(slot["pinned"], slot["dev"]):
                if d is not None:
                    p[:n].copy_(d[:n], non_blocking=True)
            slot["copied"] = torch.cuda.Event()
            slot["copied"].record(self.side)
        self.pending.append((k, lo, hi))

    def collect(self, keep: int = 0) -> float:
        """Read every copied chunk but the last ``keep`` into the host
        arrays; returns the seconds spent."""
        t0 = time.perf_counter()
        while len(self.pending) > keep:
            k, lo, hi = self.pending.pop(0)
            slot = self.slots[k % 2]
            slot["copied"].synchronize()
            for a, p in zip(self.out, slot["pinned"]):
                if a is not None:
                    a[lo:hi] = p[:hi - lo].numpy()
        return time.perf_counter() - t0

    def result(self) -> EventTrace:
        return self.out if self.stream else self.full


def simulate_chunked(
    events: EventStream,
    *,
    chunk_size: int,
    policy: PolicyLike,
    metric: str,
    num_gpus: int,
    ring_rows: int,
    ring_cols: int,
    use_kernel: bool = False,
    kernel_spec: Optional[mig.ClusterSpec] = None,
    protocol: Union[str, Protocol] = "steady",
    wait_slots: int = 0,
    wait_patience: int = 0,
    midx: Optional[torch.Tensor] = None,
    tables: Optional[SpecTables] = None,
    stream: bool = True,
    carry: Optional[ReplicaState] = None,
    start: int = 0,
    shard: Optional[bool] = None,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    stats: Optional[dict] = None,
    device=None,
) -> Tuple[ReplicaState, EventTrace]:
    """Drive the event loop over a host stream in chunks of ``chunk_size``
    events.

    Equal to :func:`_simulate` on the same stream for any ``chunk_size``
    (the carry holds every datum that crosses events, and both run the same
    :meth:`EngineCore.step`), but the device holds one carry plus two
    staged chunks of the stream instead of the whole ``(E_max, R)`` stream
    (``(E_max, R, M)`` for the fault lanes):

    * the carry stays on the device and is updated in place;
    * chunk ``k+1`` is copied host-to-device on a side stream while chunk
      ``k``'s events are enqueued (:class:`_Feed`);
    * with ``stream=True`` (default) each chunk's trace is copied back as
      its events finish and the run returns a numpy trace;
      ``stream=False`` keeps the whole trace on the device.

    ``carry``/``start`` resume a run mid-stream (a passed carry is updated
    in place; see :func:`load_stream_checkpoint`), ``checkpoint_path`` with
    ``checkpoint_every`` (in chunks) saves the carry after every that many
    chunks.  ``stats``, when given, receives the reference's chunk and
    transfer keys: ``h2d_overlap_frac`` is the share of host-to-device
    bytes staged while an earlier chunk was in flight (every chunk but the
    first).

    ``shard`` splits the replicas across the visible cards as
    :func:`shard_events` does: each card gets its block of every staged
    chunk through its own :class:`_Feed` and :class:`_Drain` (each with its
    own side stream) and steps its own carry, and one loop over a chunk's
    events steps every block in turn.  The carry is then the blocks'
    carries gathered in order on the first card (a passed carry is copied,
    not updated), so a checkpoint of a split run resumes unsplit and the
    other way round; the traces join along the replica axis, and ``stats``
    sums over the blocks.
    """
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    e_max, runs = events.pid.shape
    if not 0 <= start < e_max:
        raise ValueError(f"start={start} outside the event stream [0, {e_max})")
    dev = resolve_device(device)
    devices = _replica_devices(runs, shard, dev)
    split = devices is not None
    if not split:
        devices = [dev]
    statics = dict(
        policy=policy, metric=metric, num_gpus=num_gpus, use_kernel=use_kernel,
        runs=runs // len(devices), kernel_spec=kernel_spec, protocol=protocol,
        wait_slots=wait_slots, wait_patience=wait_patience, midx=midx, tables=tables,
    )
    cores = [_build_core(**_statics_on(statics, d)) for d in devices]
    if carry is not None and tuple(carry.ring_gpu.shape[-2:]) != (ring_rows, ring_cols):
        raise ValueError(
            f"carry ring geometry {tuple(carry.ring_gpu.shape[-2:])} does not match "
            f"this stream's ({ring_rows}, {ring_cols}); resumed with a carry from a "
            "different presample?"
        )
    if carry is None:
        carries = [None] * len(devices)
    else:
        carries = _split_state(carry, devices) if split else [carry]
    states = [_prepare_state(core, c, ring_rows, ring_cols, wait_slots)
              for core, c in zip(cores, carries)]
    whole = [np.ascontiguousarray(getattr(events, name))
             for name in _stream_fields(cores[0].protocol)]
    hosts = ([[np.ascontiguousarray(a[:, lo:hi]) for a in whole]
              for lo, hi in _blocks(runs, len(devices))] if split else [whole])
    bounds = list(range(start, e_max, chunk_size)) + [e_max]
    n_chunks = len(bounds) - 1
    rows = min(chunk_size, e_max - start)
    feeds = [_Feed(host, rows, d) for host, d in zip(hosts, devices)]
    drains = [_Drain(core, e_max - start, rows, d, stream,
                     side=feed.side if feed.cuda else None)
              for core, d, feed in zip(cores, devices, feeds)]
    h2d_s = h2d_overlap_s = d2h_s = 0.0
    h2d_bytes = h2d_overlap_bytes = 0

    def put(k, lo, hi):
        staged = [feed.put(k, lo, hi) for feed in feeds]
        return ([x for x, _, _ in staged], sum(t for _, t, _ in staged),
                sum(n for _, _, n in staged))

    xss, h2d_s, h2d_bytes = put(0, bounds[0], bounds[1])  # chunk 0: nothing to overlap
    for k in range(n_chunks):
        lo, hi = bounds[k], bounds[k + 1]
        if k + 1 < n_chunks:  # stage chunk k+1 before enqueuing chunk k's events
            nxt, dt, nb = put(k + 1, hi, bounds[k + 2])
            h2d_s += dt
            h2d_overlap_s += dt
            h2d_bytes += nb
            h2d_overlap_bytes += nb
        for feed in feeds:
            feed.ready(k)
        _split_event_loop([(core, state, xs, drain.trace(k, lo - start, hi - start))
                           for core, state, xs, drain in zip(cores, states, xss, drains)])
        for feed, drain in zip(feeds, drains):
            feed.consumed(k)
            drain.ran(k, lo - start, hi - start)
        for drain in drains:
            d2h_s += drain.collect(keep=1)  # chunk k-1's trace, while chunk k runs
        if checkpoint_path and checkpoint_every and (k + 1) % checkpoint_every == 0:
            whole_state = _join_state(states, devices[0]) if split else states[0]
            save_stream_checkpoint(checkpoint_path, whole_state, hi)
        if k + 1 < n_chunks:
            xss = nxt
    for drain in drains:
        d2h_s += drain.collect()
    if stats is not None:
        stats.update(
            chunks=n_chunks,
            chunk_size=chunk_size,
            events=e_max - start,
            h2d_seconds=h2d_s,
            h2d_overlapped_seconds=h2d_overlap_s,
            h2d_bytes=h2d_bytes,
            h2d_overlapped_bytes=h2d_overlap_bytes,
            h2d_overlap_frac=h2d_overlap_bytes / h2d_bytes if h2d_bytes else 0.0,
            d2h_seconds=d2h_s,
        )
    if not split:
        return states[0], drains[0].result()
    return (_join_state(states, devices[0]),
            _join_traces([drain.result() for drain in drains], devices[0]))


def run_batched(
    policy: PolicyLike,
    cfg: SimConfig,
    runs: int = 64,
    use_kernel: Optional[bool] = None,
    device=None,
    shard: Optional[bool] = None,
    chunk_size: Optional[int] = None,
    stream: Optional[bool] = None,
    stats: Optional[dict] = None,
) -> Dict[str, float]:
    """Average ``runs`` replicas of ``cfg.protocol`` on the device.

    The protocol picks the stream and the reduction: ``steady``,
    ``steady-queued`` and ``steady-faulted`` presample with
    :func:`presample_arrivals` (the queued protocols draw tenant and
    priority too and run with ``cfg.wait_capacity`` wait slots and
    ``cfg.wait_patience``; the faulted one also draws the fail/recover
    lanes of ``cfg.fault_model``, which it needs, and takes its retry
    budget and backoff from it), ``cumulative`` with
    :func:`presample_cumulative`.  Returns the reference's ``run_many``
    aggregate keys; the queued protocols add ``wait_p50``, ``wait_p99``,
    ``fairness`` and ``queue_admits``, the faulted one ``goodput``,
    ``evictions``, ``evictions_lost``, ``recovered_fraction``, ``ttr_p50``
    and ``ttr_p99``, and the cumulative one the demand-grid ``traces``
    (each key's mean per grid point) and ``demand_grid``.  ``use_kernel``
    routes the stages through the CUDA kernels (default: on a CUDA device,
    unless the spec opts out via ``kernel_lowering=False``); on the CPU the
    kernel wrappers compute their plain torch versions.

    ``chunk_size`` runs the events through :func:`simulate_chunked` (the
    same results for any chunk size); ``stream`` (default ``True``) and
    ``stats`` are its knobs and need ``chunk_size``.  ``shard`` splits the
    replicas across the visible cards (:func:`shard_events`; default:
    auto): the stream is presampled once for all ``runs`` and split, each
    card steps its block, and the traces join along the replica axis on
    the host before the aggregate, so the results are the unsplit run's.
    """
    dev = resolve_device(device)
    pspec = resolve(policy, engine="batched")
    proto = resolve_protocol(cfg.protocol)
    spec = cfg.spec()
    if use_kernel is None:
        use_kernel = dev.type == "cuda" and bool(pspec.kernel_lowering)
    if chunk_size is not None and chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if chunk_size is None and (stream is not None or stats is not None):
        raise ValueError("stream/stats are chunked-driver knobs; pass chunk_size as well")
    if proto.faulted:
        if cfg.fault_model is None:
            raise ValueError(
                f"protocol {proto.name!r} needs SimConfig.fault_model "
                "(a repro_torch.core.mig.FaultModel describing MTBF/MTTR)"
            )
        proto = dataclasses.replace(proto, fault_retries=cfg.fault_model.max_retries,
                                    fault_backoff=cfg.fault_model.backoff_base)
    if proto.name == "cumulative":
        events, _, ring_rows, ring_cols = presample_cumulative(cfg, runs)
    else:
        events, _, ring_rows, ring_cols = presample_arrivals(
            cfg, runs, queued=proto.queued,
            fault_model=cfg.fault_model if proto.faulted else None)
    common = dict(
        policy=pspec,
        metric=cfg.metric,
        num_gpus=cfg.num_gpus,
        ring_rows=ring_rows,
        ring_cols=ring_cols,
        use_kernel=use_kernel,
        kernel_spec=spec if use_kernel else None,
        protocol=proto,
        wait_slots=cfg.wait_capacity if proto.queued else 0,
        wait_patience=cfg.wait_patience if proto.queued else 0,
        midx=torch.as_tensor(spec.model_index, device=dev),
        tables=spec_tables(spec, dev),
        device=dev,
    )
    if chunk_size is not None:
        _, trace = simulate_chunked(events, chunk_size=chunk_size,
                                    stream=True if stream is None else stream,
                                    shard=shard, stats=stats, **common)
        if stream is False:
            trace = trace_to_numpy(trace)
    else:
        placed = shard_events(events, runs, shard, dev)
        if isinstance(placed, ShardedStream):
            _, trace = _simulate_split(placed, **common)
        else:
            _, trace = _simulate(events, **common)
            trace = trace_to_numpy(trace)
    if proto.name == "cumulative":
        return _aggregate_cumulative(events, trace, spec, runs, cfg)
    if proto.faulted:
        return _aggregate_faulted(events, trace, spec, runs)
    if proto.queued:
        return _aggregate_queued(events, trace, spec, runs)
    return aggregate(events, trace, spec, runs)


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


def _aggregate_queued(
    events: EventStream, trace: EventTrace, spec, runs: int
) -> Dict[str, float]:
    """Reduce queued-protocol traces (numpy): acceptance folds in the
    wait-admits, plus p50/p99 wait, Jain per-tenant fairness and the
    admissions from the wait ring.

    The trace records each wait-admit's original event index
    (``wadm_eidx``): arrival ``e`` was accepted iff it was accepted in
    place or a later event admitted it, and its wait is the slot distance
    between the two events (0 when immediate).  Acceptance and fairness
    count the original arrival's measurement-window membership, as the
    host simulator does.
    """
    if isinstance(spec, int):
        spec = _default_spec(spec)
    cap = float(spec.total_mem_slices)
    ok = np.asarray(trace.ok)
    wadm = np.asarray(trace.wadm_eidx)   # (E, R)
    slot = np.asarray(events.slot)
    tenant = np.asarray(events.tenant)
    meas = events.measuring
    samp = events.sample

    late_ok = np.zeros_like(ok)
    wait = np.zeros(ok.shape, np.float64)
    for r in range(runs):
        adm = np.flatnonzero(wadm[:, r] >= 0)
        orig = wadm[adm, r]
        late_ok[orig, r] = True
        wait[orig, r] = slot[adm, r] - slot[orig, r]
    acc_all = ok | late_ok

    arrived = np.maximum(meas.sum(axis=0), 1)  # (R,)
    accepted = (acc_all & meas).sum(axis=0)
    nsamp = np.maximum(samp.sum(axis=0), 1)
    util = ((cap - trace.free_sum) / cap * samp).sum(axis=0) / nsamp
    active = (trace.active * samp).sum(axis=0) / nsamp
    frag = (trace.frag * samp).sum(axis=0) / nsamp

    p50 = np.zeros(runs)
    p99 = np.zeros(runs)
    fair = np.zeros(runs)
    for r in range(runs):
        w = wait[:, r][acc_all[:, r] & meas[:, r]]
        p50[r] = np.percentile(w, 50) if len(w) else 0.0
        p99[r] = np.percentile(w, 99) if len(w) else 0.0
        tm = meas[:, r]
        rates = [
            (acc_all[:, r] & tm & (tenant[:, r] == tn)).sum()
            / (tm & (tenant[:, r] == tn)).sum()
            for tn in np.unique(tenant[:, r][tm])
        ]
        fair[r] = jain_fairness(rates)

    arrivals_p = np.stack(
        [((events.pid == p) & meas).sum() for p in range(mig.NUM_PROFILES)]
    )
    rejects_p = np.stack(
        [((events.pid == p) & meas & ~acc_all).sum() for p in range(mig.NUM_PROFILES)]
    )
    return {
        "acceptance_rate": float((accepted / arrived).mean()),
        "allocated_workloads": float(accepted.mean()),
        "active_gpus": float(active.mean()),
        "utilization": float(util.mean()),
        "frag_severity": float(frag.mean()),
        "rejects_by_profile": rejects_p / runs,
        "arrivals_by_profile": arrivals_p / runs,
        "wait_p50": float(p50.mean()),
        "wait_p99": float(p99.mean()),
        "fairness": float(fair.mean()),
        "queue_admits": float((late_ok & meas).sum(axis=0).mean()),
    }


def _aggregate_faulted(
    events: EventStream, trace: EventTrace, spec, runs: int
) -> Dict[str, float]:
    """Reduce faulted-protocol traces (numpy): the queued keys plus the
    failure keys, from a host walk of each replica's decision trace against
    the stream's fail lanes (admit, maybe evict, maybe re-admit, complete):

    * ``goodput``: the share of measured arrivals whose lease completed
      (reached its end slot, or still ran at the horizon);
    * ``evictions`` / ``evictions_lost``: evictions per replica and those
      lost outright (wait ring full, or no retry budget);
    * ``recovered_fraction``: evictions later re-admitted over evictions
      (1.0 when nothing was evicted);
    * ``ttr_p50`` / ``ttr_p99``: per-replica percentiles of the slots from
      eviction to re-admission, averaged.

    The walk is the reference's, with the running leases kept in a heap by
    end slot and in per-GPU sets, so that a slot's expiries and a failing
    GPU's evictions cost what they touch.
    """
    if isinstance(spec, int):
        spec = _default_spec(spec)
    out = _aggregate_queued(events, trace, spec, runs)

    slot = np.asarray(events.slot)
    end = np.asarray(events.end)
    fail = np.asarray(events.fail)      # (E, R, M)
    wlive = np.asarray(events.wlive)
    new_slot = np.asarray(events.new_slot)
    meas = np.asarray(events.measuring)
    ok = np.asarray(trace.ok)
    gpu_tr = np.asarray(trace.gpu)
    wadm = np.asarray(trace.wadm_eidx)
    wgpu = np.asarray(trace.wadm_gpu)

    goodput = np.zeros(runs)
    recovered = np.zeros(runs)
    ttr_p50 = np.zeros(runs)
    ttr_p99 = np.zeros(runs)
    fail_e, fail_r, fail_g = np.nonzero(fail)
    downs_of = {}
    for e, r, g in zip(fail_e.tolist(), fail_r.tolist(), fail_g.tolist()):
        downs_of.setdefault((e, r), []).append(g)
    for r in range(runs):
        gpu_of = {}     # running lease (original event index) -> its GPU
        on_gpu = {}     # GPU -> its running leases
        ends = []       # heap of (end slot, lease); entries of gone leases are stale
        done = set()    # leases that ran to completion
        pending = {}    # eviction awaiting re-admission -> eviction slot
        n_evict = n_recovered = 0
        ttrs = []

        def admit(k, g):
            gpu_of[k] = g
            on_gpu.setdefault(g, set()).add(k)
            heapq.heappush(ends, (int(end[k, r]), k))

        for e in np.flatnonzero(wlive[:, r]).tolist():
            t = int(slot[e, r])
            if new_slot[e, r]:
                # expire before faults, the device's order: a lease ending
                # the very slot its GPU dies still completes
                while ends and ends[0][0] <= t:
                    _, k = heapq.heappop(ends)
                    if k in gpu_of:
                        on_gpu[gpu_of.pop(k)].discard(k)
                        done.add(k)
                for g in downs_of.get((e, r), ()):
                    for k in on_gpu.pop(g, ()):
                        del gpu_of[k]
                        pending[k] = t
                        n_evict += 1
            a = int(wadm[e, r])
            if a >= 0:
                admit(a, int(wgpu[e, r]))
                if a in pending:
                    n_recovered += 1
                    ttrs.append(t - pending.pop(a))
            if ok[e, r]:
                admit(e, int(gpu_tr[e, r]))
        done.update(gpu_of)  # still running at the horizon: never disrupted
        m = meas[:, r]
        goodput[r] = sum(1 for k in done if m[k]) / max(1, int(m.sum()))
        recovered[r] = (n_recovered / n_evict) if n_evict else 1.0
        ttr_p50[r] = np.percentile(ttrs, 50) if ttrs else 0.0
        ttr_p99[r] = np.percentile(ttrs, 99) if ttrs else 0.0

    out.update(
        goodput=float(goodput.mean()),
        evictions=float(np.asarray(trace.evicted).sum(axis=0).mean()),
        evictions_lost=float(np.asarray(trace.evict_lost).sum(axis=0).mean()),
        recovered_fraction=float(recovered.mean()),
        ttr_p50=float(ttr_p50.mean()),
        ttr_p99=float(ttr_p99.mean()),
    )
    return out


def _aggregate_cumulative(
    events: EventStream, trace: EventTrace, spec, runs: int, cfg: SimConfig
) -> Dict[str, float]:
    """Reduce per-event cumulative traces (numpy) to ``run_many`` keys plus
    the demand-grid ``traces``, with the host simulator's grid crossings
    and early stop (both follow from the presampled pids alone, so the
    device runs every event and the stop is applied here)."""
    cap = float(spec.total_mem_slices)
    pid = np.asarray(events.pid)           # (E, R)
    ok = np.asarray(trace.ok)
    post_free = np.asarray(trace.post_free)
    post_active = np.asarray(trace.post_active)
    post_frag = np.asarray(trace.post_frag)
    e_max, _ = pid.shape

    frac = np.cumsum(mig.PROFILE_MEM[pid], axis=0) / cap  # (E, R)
    acc_cum = np.cumsum(ok, axis=0)                       # (E, R)
    arr_cum = np.arange(1, e_max + 1)[:, None]            # (E, 1)
    util = (cap - post_free) / cap

    grid = np.asarray(cfg.demand_grid, dtype=np.float64)
    G = len(grid)
    keys = (
        "acceptance_rate", "allocated_workloads", "active_gpus",
        "utilization", "frag_severity",
    )
    per_event = {
        "acceptance_rate": acc_cum / arr_cum,
        "allocated_workloads": acc_cum.astype(np.float64),
        "active_gpus": post_active.astype(np.float64),
        "utilization": util,
        "frag_severity": post_frag.astype(np.float64),
    }
    traces = {k: np.zeros((G, runs)) for k in keys}
    for i in range(G):
        crossed = frac >= grid[i]             # (E, R)
        hit = crossed.any(axis=0)             # (R,)
        idx = np.argmax(crossed, axis=0)      # first crossing event (per replica)
        for k in keys:
            v = per_event[k][idx, np.arange(runs)]
            if i > 0:  # tail-fill: an uncrossed point repeats the last recorded
                v = np.where(hit, v, traces[k][i - 1])
            else:
                v = np.where(hit, v, 0.0)
            traces[k][i] = v

    # early stop: the host loop breaks once demand reached max_demand AND
    # every grid point was recorded — both depend only on the pid stream
    stop_at = max(float(cfg.max_demand), float(grid[-1]) if G else 0.0)
    stopped = frac >= stop_at
    stop = np.where(stopped.any(axis=0), np.argmax(stopped, axis=0), e_max - 1)
    ridx = np.arange(runs)
    processed = np.arange(e_max)[:, None] <= stop[None, :]  # (E, R)

    arrivals_p = np.stack(
        [((pid == p) & processed).sum() for p in range(mig.NUM_PROFILES)]
    )
    rejects_p = np.stack(
        [((pid == p) & processed & ~ok).sum() for p in range(mig.NUM_PROFILES)]
    )
    return {
        "acceptance_rate": float(per_event["acceptance_rate"][stop, ridx].mean()),
        "allocated_workloads": float(acc_cum[stop, ridx].mean()),
        "active_gpus": float(post_active[stop, ridx].mean()),
        "utilization": float(util[stop, ridx].mean()),
        "frag_severity": float(post_frag[stop, ridx].mean()),
        "rejects_by_profile": rejects_p / runs,
        "arrivals_by_profile": arrivals_p / runs,
        "traces": {k: v.mean(axis=1) for k, v in traces.items()},
        "demand_grid": grid,
    }
