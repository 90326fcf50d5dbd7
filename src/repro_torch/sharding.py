"""Logical-axis sharding rules, resolved against a mesh: the port's
counterpart of the JAX package's ``sharding.py``.

Models annotate parameters and activations with *logical* axis names
("batch", "ff", "heads", ...; :class:`repro_torch.models.common.ParamDef`).
A launcher installs a rule set mapping logical names to mesh axes
(:func:`use_rules`) and a mesh (:func:`use_mesh`, as ``jax.set_mesh``);
:func:`resolve` turns logical axes into a :class:`PartitionSpec` under the
active rules, and :func:`placements` a spec into DTensor placements on the
mesh's ``DeviceMesh``.

:func:`constraint` is the reference's ``with_sharding_constraint``: on a
mesh of more than one device it redistributes a DTensor to the spec's
placements (gathering, reducing or slicing as needed).  Outside a rule
set, with no mesh, and on a mesh of one device it is the identity, so the
same model code runs on one device.  Where a hand-written kernel, a custom
autograd function or an op with no DTensor sharding rule must see plain
tensors, :func:`local` runs it on each rank's shards (``local_map``).
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

_state = threading.local()


class PartitionSpec(tuple):
    """A tensor's placement by mesh axes, one entry per tensor axis: ``None``
    (replicated), a mesh-axis name, or a tuple of names (a tuple of one
    name is that name, as ``jax.sharding.PartitionSpec`` keeps it).  A
    tuple, so that it compares with the reference's spec entry by entry."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):  # pickles entry by entry (``__new__`` takes them spread)
        return (type(self), tuple(self))


def _rules() -> Optional[Dict[str, MeshAxes]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Dict[str, MeshAxes]):
    prev = _rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def _mesh():
    return getattr(_state, "mesh", None)


def active_mesh():
    """The mesh of the enclosing :func:`use_mesh` (None outside one)."""
    return _mesh()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) the one that
    :func:`constraint` places onto, as ``jax.set_mesh`` does."""
    prev = _mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def active_rule(name: str):
    """Value of a rule in the active rule set (None outside a context)."""
    rules = _rules()
    return rules.get(name) if rules else None


def resolve(logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
    """Logical axes -> PartitionSpec under the active rules."""
    rules = _rules() or {}
    return PartitionSpec(*[rules.get(a) if a is not None else None for a in logical_axes])


def _mesh_axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence[MeshAxes], mesh) -> tuple:
    """A resolved spec as DTensor placements, one per mesh dim: a mesh dim
    that the entry of tensor dim ``i`` names gets ``Shard(i)``, every other
    one ``Replicate()``.

    An entry naming two mesh axes, ``("pod", "data")``, gives ``Shard(i)``
    on both mesh dims; DTensor splits a dim over its mesh dims from the
    left, so the first-named (``pod``, the outer mesh dim) is the major
    factor and the second the minor, JAX's order for ``P(("pod",
    "data"))``.  A spec naming a mesh dim twice, or a mesh axis out of
    order within one entry, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _mesh_axes(entry)
        if any(a not in names for a in axes):
            raise ValueError(f"spec {tuple(spec)} names an axis not in mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry!r} orders mesh axes {names} otherwise than the mesh: "
                             f"DTensor's split order is the mesh's")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(spec)} names mesh axis {names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


def device_mesh_of(mesh):
    """The ``DeviceMesh`` of ``mesh`` when it spans more than one rank,
    else None (the host mesh, a description, or no mesh)."""
    if mesh is None or math.prod(mesh.shape) == 1:
        return None
    return mesh.device_mesh


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _caller() -> str:
    frame = sys._getframe(2)
    return f"{frame.f_code.co_filename}:{frame.f_lineno} ({frame.f_code.co_name})"


def constraint(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x`` placed by the resolved spec of ``logical_axes``.

    The identity outside a rule set, with no mesh, and on a mesh of one
    device.  On a mesh of more than one rank, ``x`` must be a DTensor: it
    is redistributed to :func:`placements` of the spec (``Partial``
    resolves by the spec: a ``None`` entry means ``Replicate``, an
    all-reduce).  A plain tensor there raises ``TypeError`` naming the
    call site: nothing is replicated silently.  A mesh that is only a
    description (``launch.mesh.make_production_mesh`` with no process
    group up) takes a spec that names no axis larger than 1, and raises
    ``RuntimeError`` on one that does.
    """
    mesh = _mesh()
    if _rules() is None or mesh is None or math.prod(mesh.shape) == 1:
        return x
    spec = resolve(logical_axes)
    if mesh.device_mesh is None:
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        big = [a for e in spec for a in _mesh_axes(e) if sizes.get(a, 1) > 1]
        if big:
            raise RuntimeError(
                f"constraint over mesh axes {big} of a described mesh {mesh.shape}: no process "
                f"group of {math.prod(mesh.shape)} ranks is up (launch.mesh.make_mesh)")
        return x
    if not is_dtensor(x):
        raise TypeError(
            f"constraint{tuple(logical_axes)} at {_caller()} got a plain "
            f"{type(x).__name__} on a {mesh.shape} mesh: place it first (steps.place)")
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh.device_mesh, want)


def replicated(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A tensor built inside a model (positions, masks, spans, zeros) as a
    ``Replicate`` DTensor on the mesh of ``like`` when ``like`` is a
    DTensor; unchanged otherwise.  Every rank builds the same value."""
    if not is_dtensor(like) or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    dm = like.device_mesh
    return DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)


def local(fn: Callable, out_placements, in_placements, *args):
    """``fn(*args)`` on each rank's shards (``local_map``): the DTensor
    ``args`` are redistributed to ``in_placements`` (one entry per
    argument, None for a non-tensor), ``fn`` sees their local tensors, and
    its outputs come back as DTensors of ``out_placements``.  With no
    DTensor among ``args`` it is ``fn(*args)``.  The placements must make
    the work local (split over batch or heads): that is the caller's
    contract, as ``local_map``'s.

    An argument replicated over a mesh dim along which an output is split
    gets, on each rank, only the gradient of that rank's part, so its
    gradient is declared ``Partial()`` on that dim and summed
    (``local_map``'s ``in_grad_placements``)."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Partial, Placement, Replicate

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    if out_placements and isinstance(out_placements[0], Placement):
        out_placements = list(out_placements)  # one output: local_map's form
        outs = [out_placements]
    else:
        outs = list(out_placements)
    split = [any(o[m].is_shard() for o in outs) for m in range(mesh.ndim)]
    grads = tuple(None if pl is None else
                  [Partial() if p == Replicate() and split[m] else p for m, p in enumerate(pl)]
                  for pl in in_placements)
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# Default rule sets
# ---------------------------------------------------------------------------


def default_rules(
    *,
    multi_pod: bool = False,
    n_heads: int = 0,
    n_kv_heads: int = 0,
    model_axis: int = 16,
    batch_shardable: bool = True,
    shard_kv_seq: bool = False,
    fsdp: bool = True,
) -> Dict[str, MeshAxes]:
    """Standard rules: batch->data(+pod), ff/vocab->model, FSDP d_model->data.

    Head axes go to "model" only when divisible; otherwise head_dim (always a
    multiple of 64 here) takes the model axis.
    """
    batch = (("pod", "data") if multi_pod else ("data",)) if batch_shardable else None
    heads_div = n_heads > 0 and n_heads % model_axis == 0
    kv_div = n_kv_heads > 0 and n_kv_heads % model_axis == 0
    return {
        "batch": batch,
        "seq": None,
        "kv_seq": "data" if shard_kv_seq else None,
        "vocab": "model",
        "ff": "model",
        "dmodel": "data" if fsdp else None,  # FSDP weight shard (gathered per layer)
        "dmodel_act": None,                  # activations keep d_model replicated
        "heads": "model" if heads_div else None,
        "head_dim": None if heads_div else "model",
        "kv_heads": "model" if kv_div else None,
        "kv_head_dim": None if kv_div else "model",
        "experts": None,       # experts replicated; TP inside experts via "ff"
        "ssm_inner": "model",  # SSD inner channels (head-aligned column shard)
        "ssm_heads": "model",
        "ssm_state": None,
        "conv": None,
    }
