"""Declarative policy layer: one frozen :class:`PolicySpec` per policy.

A policy is a **feasibility filter** (today always "window-free": an
anchor is a candidate iff its placement window is fully free and the
demand class has a realization on the GPU's device model), an optional
**ΔF requirement** (``"frag-delta"`` among the keys) and an ordered list of
**lexicographic scoring keys** from :data:`KEY_VOCABULARY`, each optionally
prefixed with ``-`` to flip the direction.  The candidate minimizing the
key tuple wins; any remaining tie is broken by ascending ``(gpu, anchor)``.

This registry is the port's own copy of the JAX package's registry, with
the same built-in specs (a test holds the two equal).  The batched engine
(:mod:`repro_torch.sim.batched`) lowers a spec to a masked-refinement
argmin over the ``(R, M, A)`` candidate tensor, or — for argmin-fusable
specs under ``use_kernel`` — to the hand-written ``select_from_base``
CUDA kernel.  The ``engines`` vocabulary keeps the reference's names
(``"python"`` = host scheduler, ``"batched"`` = the batched engine).

Key vocabulary
    ==============  =========================================================
    ``frag-delta``  ΔF of the dry-run placement (fragmentation increment,
                    paper Alg. 2); requests the ΔF table from the engine
    ``free-slices`` post-allocation free memory slices of the GPU
                    (ascending = best-fit packing, ``-free-slices`` =
                    worst-fit load balancing); per-model slice demand on
                    mixed fleets
    ``gpu``         GPU index (ascending = first-fit scan order)
    ``anchor``      placement-anchor index (ascending = first available
                    index; ``-anchor`` = the MIG-aware "Best Index" rule)
    ``rr-distance`` rotation distance ``(gpu - cursor) mod M`` from the
                    round-robin cursor; marks the policy *stateful* (the
                    cursor advances past each accepted GPU)
    ``model-group`` index of the GPU's device model in the spec's model
                    list (mixed fleets: steer demand across generations)
    ``tenant``      request-scoped: id of the submitting tenant (constant
                    across candidates — orders competing *requests*, not
                    placements; see :data:`REQUEST_KEYS`)
    ``priority``    request-scoped: the request's declared priority class
                    (ascending: 0 admits first)
    ``wait-age``    request-scoped: slots the request has waited since
                    arrival (``-wait-age`` = oldest first)
    ==============  =========================================================
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

#: engines a policy may be compiled to
ENGINES: Tuple[str, ...] = ("python", "batched")

#: legal scoring-key bases (each may be prefixed with ``-`` to flip order)
KEY_VOCABULARY: Tuple[str, ...] = (
    "frag-delta",
    "free-slices",
    "gpu",
    "anchor",
    "rr-distance",
    "model-group",
    "tenant",
    "priority",
    "wait-age",
)

#: request-scoped scoring keys: their value is a property of the REQUEST
#: being placed (the submitting tenant, its declared priority, how long the
#: request has waited), not of the candidate ``(gpu, anchor)``.  Within one
#: request's placement argmin they are constant across every candidate, so
#: every engine compiles them to constant columns — adding them to a spec
#: never changes which placement wins.  Their effect is *cross-request*:
#: wherever several requests compete for the next admission slot (the
#: serving front-end's wait queue, the batched engine's wait ring under the
#: ``steady-queued`` protocol), the request-scoped keys of the spec order
#: the competitors (see :func:`queue_order`).
REQUEST_KEYS: Tuple[str, ...] = ("tenant", "priority", "wait-age")

#: queue ordering used when a spec names no request-scoped keys: lowest
#: priority value first (0 = most urgent), then oldest wait first
#: (descending wait-age), then arrival order.
DEFAULT_QUEUE_ORDER: Tuple[str, ...] = ("priority", "-wait-age")

#: feasibility filters (currently the single built-in rule)
FEASIBILITY_FILTERS: Tuple[str, ...] = ("window-free",)

#: legal ``PolicySpec.kernel_lowering`` declarations (see the field docs):
#: ``True`` = everything available, ``"fused"`` = require the fused
#: argmin kernels, ``"delta"`` = ΔF table only, ``False`` = no kernels.
KERNEL_LOWERINGS: Tuple[object, ...] = (True, False, "delta", "fused")

#: key bases the fused select kernel can fold into its in-kernel
#: lexicographic comparison.  ``rr-distance`` (stateful cursor) and
#: ``model-group`` stay on the plain torch lowering; request-scoped keys are constant within
#: one request's candidates, so the kernels simply drop them.
FUSABLE_KEYS: Tuple[str, ...] = (
    "frag-delta", "free-slices", "gpu", "anchor",
) + REQUEST_KEYS


def key_base(key: str) -> str:
    """Strip the optional ``-`` direction prefix off a scoring key."""
    return key[1:] if key.startswith("-") else key


def queue_order(spec: "PolicySpec") -> Tuple[str, ...]:
    """The cross-request admission ordering a spec implies.

    Returns the spec's request-scoped keys (:data:`REQUEST_KEYS` bases, in
    spec order, direction prefixes preserved), or
    :data:`DEFAULT_QUEUE_ORDER` when the spec names none.  Queued admission
    paths — the serving front-end's wait queue and the batched engine's
    ``steady-queued`` wait ring — admit the waiting request minimizing this
    key tuple (ties broken by arrival order).
    """
    keys = tuple(k for k in spec.keys if key_base(k) in REQUEST_KEYS)
    return keys if keys else DEFAULT_QUEUE_ORDER


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """A frozen, registrable description of a placement policy.

    A policy is: filter the feasible ``(gpu, anchor)`` dry-runs of the
    request, score each with the ordered ``keys``, and commit the candidate
    with the lexicographically smallest key tuple (remaining ties broken by
    ascending ``(gpu, anchor)``).  Instances are hashable, so a spec doubles
    as a static cache key in the batched engine.

    Attributes:
      name: registry name (also the CLI / ``SimConfig`` policy string).
      keys: ordered lexicographic scoring keys; bases must come from
        :data:`KEY_VOCABULARY`, a ``-`` prefix flips the direction.
      feasibility: candidate filter; ``"window-free"`` keeps anchors whose
        placement window has zero occupied slices (and drops demand classes
        with no realization on the GPU's model).
      defrag: on reject, search for ONE running workload whose migration
        makes the request feasible (the beyond-paper ``mfi-defrag``
        behaviour).  Both engines implement it: the host scheduler as the
        canonical ``(total F, victim gpu, victim anchor)`` candidate search,
        the batched engine as a migrate stage compiled into its scan body
        (the expiry ring doubles as the allocation table).  Incompatible
        with the ``rr-distance`` key (the inner dry-run selections of the
        search would advance the rotation cursor ambiguously).
      engines: engines this spec may be compiled to (default: all).  A
        spec can opt out of an engine, e.g. a host-side-only experiment;
        :func:`resolve` raises through the same message everywhere.
      kernel_lowering: how far the batched engine may lower this spec's
        scoring into the CUDA kernels (``use_kernel=True``).  One of
        :data:`KERNEL_LOWERINGS`:

        * ``True`` (default) — everything available: the fused per-model
          select/migrate kernels with in-kernel lexicographic argmin when
          the spec's keys are fusable (:attr:`argmin_fusable`), the
          ``delta_from_base`` ΔF dispatch otherwise, plus the
          occupancy-based ``fragscore`` rescore on homogeneous fleets;
        * ``"fused"`` — like ``True`` but *declares* argmin-fusability:
          constructing the spec raises unless every key is packable
          (:data:`FUSABLE_KEYS`), so a defrag spec that says ``"fused"``
          is guaranteed to compose with the fused migrate-search kernel;
        * ``"delta"`` — ΔF-table lowering only; the argmin (select and the
          migrate stage's refinements) stays plain torch.  For specs whose
          custom key semantics must not enter the packed-key reduction;
        * ``False`` — no kernels at all; ``run_batched(use_kernel=True)``
          raises.

        All lowerings are bit-for-bit with the plain torch lowering
        (integer-valued scores, exact in float32).
      description: one-line human summary (shown by ``list_policies``
        consumers and docs).
    """

    name: str
    keys: Tuple[str, ...]
    feasibility: str = "window-free"
    defrag: bool = False
    engines: Tuple[str, ...] = ENGINES
    kernel_lowering: Union[bool, str] = True
    description: str = ""

    def __post_init__(self):
        if not self.name:
            raise ValueError("PolicySpec needs a non-empty name")
        if not isinstance(self.keys, tuple):
            object.__setattr__(self, "keys", tuple(self.keys))
        if not self.keys:
            raise ValueError(f"policy {self.name!r}: needs at least one scoring key")
        for key in self.keys:
            if key_base(key) not in KEY_VOCABULARY:
                raise ValueError(
                    f"policy {self.name!r}: unknown scoring key {key!r}; "
                    f"vocabulary: {KEY_VOCABULARY} (optionally '-'-prefixed)"
                )
        if self.feasibility not in FEASIBILITY_FILTERS:
            raise ValueError(
                f"policy {self.name!r}: unknown feasibility filter "
                f"{self.feasibility!r}; options: {FEASIBILITY_FILTERS}"
            )
        if not isinstance(self.engines, tuple):
            object.__setattr__(self, "engines", tuple(self.engines))
        if not self.engines:
            raise ValueError(f"policy {self.name!r}: needs at least one engine")
        for engine in self.engines:
            if engine not in ENGINES:
                raise ValueError(
                    f"policy {self.name!r}: unknown engine {engine!r}; "
                    f"options: {ENGINES}"
                )
        if self.defrag and self.stateful_cursor:
            raise ValueError(
                f"policy {self.name!r}: defrag is incompatible with the "
                "'rr-distance' key (the migration search's inner dry-run "
                "selections would advance the rotation cursor ambiguously)"
            )
        if self.kernel_lowering not in KERNEL_LOWERINGS:
            raise ValueError(
                f"policy {self.name!r}: unknown kernel_lowering "
                f"{self.kernel_lowering!r}; options: {KERNEL_LOWERINGS}"
            )
        if self.kernel_lowering == "fused" and not self.argmin_fusable:
            bad = tuple(k for k in self.keys if key_base(k) not in FUSABLE_KEYS)
            raise ValueError(
                f"policy {self.name!r}: kernel_lowering='fused' declares "
                "argmin-fusability, but the spec is not fusable "
                f"({'keys ' + repr(bad) + ' cannot be packed' if bad else 'no frag-delta key — nothing to fuse'}; "
                f"fusable bases: {FUSABLE_KEYS})"
            )

    # -- derived structure ---------------------------------------------------
    @property
    def requires_delta_f(self) -> bool:
        """Whether any key consumes the ΔF (fragmentation-increment) table."""
        return any(key_base(k) == "frag-delta" for k in self.keys)

    @property
    def stateful_cursor(self) -> bool:
        """Whether the policy carries a round-robin rotation cursor."""
        return any(key_base(k) == "rr-distance" for k in self.keys)

    @property
    def argmin_fusable(self) -> bool:
        """Whether the spec's key list can be packed into the fused
        select kernel's in-kernel lexicographic argmin:
        every key base must be in :data:`FUSABLE_KEYS`.  ΔF-free specs
        (bf-bi/wf-bi/ff) qualify too — the kernel simply skips the ΔF
        tile and reduces the remaining keys in-register."""
        return all(key_base(k) in FUSABLE_KEYS for k in self.keys)

    @property
    def fused_argmin(self) -> bool:
        """Whether ``use_kernel=True`` routes this spec through the fused
        select/migrate kernels (declared via :attr:`kernel_lowering` and
        structurally :attr:`argmin_fusable`)."""
        return self.kernel_lowering in (True, "fused") and self.argmin_fusable

    def supports(self, engine: str) -> bool:
        return engine in self.engines


#: anything the public entry points accept where a policy is expected
PolicyLike = Union[str, PolicySpec]


# ---------------------------------------------------------------------------
# Registry — the single source of truth for both engines
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, PolicySpec] = {}


def register_policy(spec: PolicySpec, overwrite: bool = False) -> PolicySpec:
    """Register ``spec`` under ``spec.name``; returns the spec.

    Registered policies are immediately usable by both engines and every
    entry point (``make_scheduler``, ``run_many``, ``run_batched``,
    ``simulate``) and picked up by the registry-parametrized parity tests.
    """
    if not isinstance(spec, PolicySpec):
        raise TypeError(f"register_policy expects a PolicySpec, got {type(spec)}")
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"policy {spec.name!r} is already registered; "
            "pass overwrite=True to replace it"
        )
    _REGISTRY[spec.name] = spec
    return spec


def unregister_policy(name: str) -> None:
    """Remove a registered policy (built-ins included — use with care)."""
    _REGISTRY.pop(name, None)


def get_policy(name: str) -> PolicySpec:
    """Look up a registered spec by name (the validating path is
    :func:`resolve`)."""
    return resolve(name)


def list_policies(engine: Optional[str] = None) -> Tuple[str, ...]:
    """Sorted names of registered policies, optionally engine-filtered."""
    if engine is not None and engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; options: {ENGINES}")
    return tuple(
        sorted(
            name
            for name, spec in _REGISTRY.items()
            if engine is None or spec.supports(engine)
        )
    )


def policy_engines(name: str) -> Tuple[str, ...]:
    """Engines supporting a registered policy."""
    return resolve(name).engines


def _catalog() -> str:
    return ", ".join(
        f"{name} ({'+'.join(_REGISTRY[name].engines)})"
        for name in sorted(_REGISTRY)
    )


def resolve(policy: PolicyLike, engine: Optional[str] = None) -> PolicySpec:
    """The one validation path: name-or-spec -> :class:`PolicySpec`.

    Raises ``ValueError`` with a message naming every registered policy and
    which engines support each — both on an unknown name and on a policy /
    engine mismatch.  All entry points (``make_scheduler``, ``run_many``,
    ``run_batched``, ``policy_select``, ``simulate``) route through here, so
    the errors are consistent everywhere.
    """
    if engine is not None and engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; options: {ENGINES}")
    if isinstance(policy, PolicySpec):
        spec = policy  # ad-hoc (possibly unregistered) specs are welcome
    else:
        spec = _REGISTRY.get(policy)
        if spec is None:
            raise ValueError(
                f"unknown policy {policy!r}; registered policies: {_catalog()}"
            )
    if engine is not None and not spec.supports(engine):
        raise ValueError(
            f"policy {spec.name!r} is not supported by the {engine!r} engine "
            f"(supports: {'+'.join(spec.engines)}); policies supporting "
            f"{engine!r}: {', '.join(list_policies(engine))}"
        )
    return spec


# ---------------------------------------------------------------------------
# Built-in policies — the paper's MFI, its four baselines, and the
# beyond-paper defrag variant, each as one declarative spec.
# ---------------------------------------------------------------------------

MFI_SPEC = register_policy(
    PolicySpec(
        name="mfi",
        keys=("frag-delta", "gpu", "anchor"),
        description=(
            "Minimum Fragmentation Increment (paper Alg. 2): argmin ΔF over "
            "all feasible dry-runs, ties by (gpu, anchor)"
        ),
    )
)

FF_SPEC = register_policy(
    PolicySpec(
        name="ff",
        keys=("gpu", "anchor"),
        description="First-Fit: first GPU with room, first available index",
    )
)

RR_SPEC = register_policy(
    PolicySpec(
        name="rr",
        keys=("rr-distance", "anchor"),
        description=(
            "Round-Robin: first feasible GPU in cursor rotation, first "
            "available index; the cursor advances past each accepted GPU"
        ),
    )
)

BF_BI_SPEC = register_policy(
    PolicySpec(
        name="bf-bi",
        keys=("free-slices", "gpu", "-anchor"),
        description=(
            "Best-Fit Best-Index: fewest post-allocation free slices, ties "
            "by GPU id; highest feasible anchor (Best Index)"
        ),
    )
)

WF_BI_SPEC = register_policy(
    PolicySpec(
        name="wf-bi",
        keys=("-free-slices", "gpu", "-anchor"),
        description=(
            "Worst-Fit Best-Index: most post-allocation free slices, ties "
            "by GPU id; highest feasible anchor (Best Index)"
        ),
    )
)

MFI_DEFRAG_SPEC = register_policy(
    PolicySpec(
        name="mfi-defrag",
        keys=("frag-delta", "gpu", "anchor"),
        defrag=True,
        description=(
            "BEYOND-PAPER: MFI plus an opportunistic single-migration "
            "defrag search on reject (both engines)"
        ),
    )
)

MFI_QUEUED_SPEC = register_policy(
    PolicySpec(
        name="mfi-queued",
        keys=("priority", "-wait-age", "frag-delta", "gpu", "anchor"),
        description=(
            "BEYOND-PAPER: MFI placement with an explicit queue order — "
            "priority class first, then oldest wait (placement-identical "
            "to mfi; the request-scoped keys order waiting requests under "
            "queued admission)"
        ),
    )
)
