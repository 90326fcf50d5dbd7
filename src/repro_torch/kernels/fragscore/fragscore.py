"""Wrappers of the five fragscore CUDA kernels (``csrc/fragscore.cu``).

Each wrapper takes its operands in the engine's layout (see
:mod:`repro_torch.kernels.fragscore.ref`).  For tensors that lie on the CPU
it returns its plain torch version from ``ref.py``; for CUDA tensors it
checks device, dtype, shape and contiguity, launches the hand-written
kernel on the current stream and adds one to its ``launches`` count — or
raises.  There is no fallback from the card to the plain version.

* :func:`fragscore` — F(m) per occupancy row (the commit/drain rescore on
  homogeneous fleets);
* :func:`delta_from_base` — the raw ``(R, M, A)`` ΔF table of each
  replica's request (specs with ``kernel_lowering="delta"``);
* :func:`select_from_base` — each replica's whole decision, ΔF plus the
  masked lexicographic argmin (argmin-fusable specs);
* :func:`migrate_refine` — both refinements of the defrag migrate search
  (argmin-fusable defrag specs);
* :func:`mfi_delta` — the ``(M, A)`` ΔF table of one scheduling decision
  from raw occupancy (:func:`repro_torch.core.cluster.mfi_select` with
  ``use_kernel=True``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wrap import check, launch, on_cpu
from repro_torch.kernels.fragscore import ref

_METRICS = ("blocked", "partial")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("fragscore")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fragscore_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.delta_from_base_launch.argtypes = [p] * 9 + [i] * 8 + [p]
    lib.select_from_base_launch.argtypes = [p] * 14 + [i] * 10 + [p]
    lib.migrate_refine_launch.argtypes = [p] * 27 + [i] * 11 + [p]
    lib.mfi_delta_launch.argtypes = [p] * 6 + [i] * 6 + [p]
    for fn in (lib.fragscore_launch, lib.delta_from_base_launch,
               lib.select_from_base_launch, lib.migrate_refine_launch,
               lib.mfi_delta_launch):
        fn.restype = ctypes.c_int
    return lib


def _metric_flag(metric: str) -> int:
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    return int(metric == "partial")


def fragscore(
    occ: torch.Tensor, w: torch.Tensor, v: torch.Tensor, *, metric: str = "blocked"
) -> torch.Tensor:
    """F(m) of every row of ``occ (Q, S)`` under placement table
    ``w (N, S)``, ``v (N,)``: ``(Q,)`` float32."""
    partial = _metric_flag(metric)
    if on_cpu(occ, w, v):
        return ref.fragscore_ref(occ, w, v, metric)
    q, s = occ.shape
    n = w.shape[0]
    check("occ", occ, torch.int32, (q, s))
    check("w", w, torch.float32, (n, s))
    check("v", v, torch.float32, (n,))
    out = torch.empty((q,), dtype=torch.float32, device=occ.device)
    if q:
        launch(_lib().fragscore_launch, occ.data_ptr(), w.data_ptr(),
               v.data_ptr(), out.data_ptr(), q, n, s, partial,
               device=occ.device)
        fragscore.launches += 1
    return out


fragscore.launches = 0


def mfi_delta(
    occ: torch.Tensor,
    w: torch.Tensor,
    v: torch.Tensor,
    profile_masks: torch.Tensor,
    profile_valid: torch.Tensor,
    *,
    metric: str = "blocked",
) -> torch.Tensor:
    """ΔF ``(M, A)`` of every anchor dry-run of one request on every row of
    ``occ (M, S)`` int32, under placement table ``w (N, S)``/``v (N,)`` and
    the requested class's anchor windows ``profile_masks (A, S)`` with
    ``profile_valid (A,)`` (all float32); exactly ``1e30`` where infeasible."""
    partial = _metric_flag(metric)
    if on_cpu(occ, w, v, profile_masks, profile_valid):
        return ref.mfi_delta_ref(occ, w, v, profile_masks, profile_valid, metric)
    m, s = occ.shape
    n, a = w.shape[0], profile_masks.shape[0]
    check("occ", occ, torch.int32, (m, s))
    check("w", w, torch.float32, (n, s))
    check("v", v, torch.float32, (n,))
    check("profile_masks", profile_masks, torch.float32, (a, s))
    check("profile_valid", profile_valid, torch.float32, (a,))
    out = torch.empty((m, a), dtype=torch.float32, device=occ.device)
    if m and a:
        launch(_lib().mfi_delta_launch, occ.data_ptr(), w.data_ptr(), v.data_ptr(),
               profile_masks.data_ptr(), profile_valid.data_ptr(), out.data_ptr(),
               m, n, s, a, partial, device=occ.device)
        mfi_delta.launches += 1
    return out


mfi_delta.launches = 0


def _table_args(base, free, f, midx, V, maskwin, profile_mem):
    """Shape/dtype checks shared by the ΔF kernels; returns (R, M, N, A, K, P)."""
    r, m, n = base.shape
    k, p, a, _ = maskwin.shape
    check("base", base, torch.float32, (r, m, n))
    check("free", free, torch.int32, (r, m))
    check("f", f, torch.float32, (r, m))
    check("midx", midx, torch.int32, (m,))
    check("V", V, torch.float32, (k, n))
    check("maskwin", maskwin, torch.float32, (k, p, a, n))
    check("profile_mem", profile_mem, torch.float32, (k, p))
    return r, m, n, a, k, p


def delta_from_base(
    base, free, f, pid, midx, V, maskwin, profile_mem, *, metric: str = "blocked"
) -> torch.Tensor:
    """Raw ΔF ``(R, M, A)`` of every anchor dry-run of each replica's
    request ``pid`` (no feasibility mask)."""
    partial = _metric_flag(metric)
    if on_cpu(base, free, f, pid, midx, V, maskwin, profile_mem):
        return ref.delta_from_base_ref(
            base, free, f, pid, midx, V, maskwin, profile_mem, metric
        )
    r, m, n, a, k, p = _table_args(base, free, f, midx, V, maskwin, profile_mem)
    check("pid", pid, torch.int32, (r,))
    out = torch.empty((r, m, a), dtype=torch.float32, device=base.device)
    if r and m:
        launch(_lib().delta_from_base_launch, base.data_ptr(), free.data_ptr(),
               f.data_ptr(), pid.data_ptr(), midx.data_ptr(), V.data_ptr(),
               maskwin.data_ptr(), profile_mem.data_ptr(), out.data_ptr(),
               r, m, n, a, p, k, partial, device=base.device)
        delta_from_base.launches += 1
    return out


delta_from_base.launches = 0

#: most effective keys the select kernel compares (its ``kMaxKeys``)
MAX_KEYS = 8


@functools.lru_cache(maxsize=None)
def pack_keys(keys) -> int:
    """The select kernel's key code: 3 bits per effective key, the base's
    index in :data:`ref.FUSED_KEY_CODES` plus 4 for the ``-`` direction.
    ``keys`` is a tuple of ``(base, sign)`` pairs; each code is computed
    once per process."""
    if len(keys) > MAX_KEYS:
        raise ValueError(f"at most {MAX_KEYS} fused keys, got {len(keys)}")
    code = 0
    for i, (base_key, sign) in enumerate(keys):
        if base_key not in ref.FUSED_KEY_CODES:
            raise ValueError(f"key {base_key!r} is not argmin-fusable")
        code |= (ref.FUSED_KEY_CODES.index(base_key) | (4 if sign < 0 else 0)) << (3 * i)
    return code


def select_from_base(
    base, free, f, pid, midx, V, maskwin, profile_rows, profile_valid,
    profile_anchors, profile_mem, *, keys, metric: str = "blocked",
):
    """Each replica's decision ``(gpu, col, ok)``, each ``(R,)``: the
    lexicographic minimum of ``(keys…, gpu, col)`` over the feasible
    anchors of request ``pid``; ``keys`` is the static effective-key tuple
    ``((base, sign), …)``.

    The kernel takes N <= 32 windows, and every window size in ``V`` must
    be a whole number of slices in [0, 32]: it sums windows as bit sets of
    those sizes (``spec_tables`` builds no other)."""
    partial = _metric_flag(metric)
    operands = (base, free, f, pid, midx, V, maskwin, profile_rows,
                profile_valid, profile_anchors, profile_mem)
    if on_cpu(*operands):
        return ref.select_from_base_ref(*operands, keys, metric)
    code = pack_keys(keys)
    r, m, n, a, k, p = _table_args(base, free, f, midx, V, maskwin, profile_mem)
    check("pid", pid, torch.int32, (r,))
    check("profile_rows", profile_rows, torch.int32, (k, p, a))
    check("profile_valid", profile_valid, torch.bool, (k, p, a))
    check("profile_anchors", profile_anchors, torch.int32, (k, p, a))
    if n > 32:
        raise ValueError(f"select_from_base: N = {n} windows must be <= 32")
    # the three outputs in one allocation: int32 gpu, int32 col, bool ok
    gpu, col, ok = torch.empty((9 * r,), dtype=torch.uint8, device=base.device).split(
        (4 * r, 4 * r, r))
    gpu, col, ok = gpu.view(torch.int32), col.view(torch.int32), ok.view(torch.bool)
    if r:
        launch(_lib().select_from_base_launch,
               *[t.data_ptr() for t in operands],
               gpu.data_ptr(), col.data_ptr(), ok.data_ptr(),
               r, m, n, a, p, k, len(keys), code, partial, device=base.device)
        select_from_base.launches += 1
    return gpu, col, ok


select_from_base.launches = 0


def migrate_refine(
    base, free, f, base2, free2, f2, rg, rp, kc, midx, V, maskwin, profile_rows,
    profile_valid, profile_anchors, profile_mem, *, keys, metric: str = "blocked",
):
    """Both refinements of the migrate search in one launch: per replica
    and demand class the best and runner-up untouched GPU rows, per victim
    its patched row (see :func:`ref.migrate_refine_ref` for the operands and
    the ``(g1, ok1, a1, k1, g2, ok2, a2, k2, ap, okp, kp)`` outputs).

    The kernel takes N <= 32 windows and P <= 8 classes, and every window
    size in ``V`` must be a whole number of slices in [0, 32]: it sums
    windows as bit sets of those sizes (``spec_tables`` builds no other).
    The launcher refuses tables that do not fit the card's shared memory."""
    partial = _metric_flag(metric)
    operands = (base, free, f, base2, free2, f2, rg, rp, kc, midx, V, maskwin,
                profile_rows, profile_valid, profile_anchors, profile_mem)
    if on_cpu(*operands):
        return ref.migrate_refine_ref(*operands, keys, metric)
    code = pack_keys(keys)
    r, m, n, a, k, p = _table_args(base, free, f, midx, V, maskwin, profile_mem)
    c = base2.shape[1]
    check("base2", base2, torch.float32, (r, c, n))
    check("free2", free2, torch.int32, (r, c))
    check("f2", f2, torch.float32, (r, c))
    for name, t in (("rg", rg), ("rp", rp), ("kc", kc)):
        check(name, t, torch.int32, (r, c))
    check("profile_rows", profile_rows, torch.int32, (k, p, a))
    check("profile_valid", profile_valid, torch.bool, (k, p, a))
    check("profile_anchors", profile_anchors, torch.int32, (k, p, a))
    if n > 32 or p > 8:
        raise ValueError(f"migrate_refine: N = {n} must be <= 32 and P = {p} <= 8")
    dev = base.device
    l = len(keys)
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    g1, a1, g2, a2 = (torch.empty((r, p), **i32) for _ in range(4))
    ok1, ok2 = torch.empty((r, p), **b8), torch.empty((r, p), **b8)
    k1, k2 = torch.empty((r, p, l), **f32), torch.empty((r, p, l), **f32)
    ap, okp, kp = torch.empty((r, c), **i32), torch.empty((r, c), **b8), torch.empty((r, c, l), **f32)
    outs = (g1, ok1, a1, k1, g2, ok2, a2, k2, ap, okp, kp)
    if r:
        launch(_lib().migrate_refine_launch,
               *(t.data_ptr() for t in operands + outs),
               r, m, c, n, a, p, k, l, code, partial, device=dev)
        migrate_refine.launches += 1
    return outs


migrate_refine.launches = 0
