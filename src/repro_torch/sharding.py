"""Logical-axis sharding rules, resolved against a mesh: the port's
counterpart of the JAX package's ``sharding.py``.

Models annotate parameters with *logical* axis names ("batch", "ff",
"heads", ...; :class:`repro_torch.models.common.ParamDef`).  A launcher
installs a rule set mapping logical names to mesh axes
(:func:`use_rules`); :func:`resolve` turns logical axes into a
:class:`PartitionSpec` under the active rules.  Outside a rule set, and on
a mesh whose every axis has size 1, :func:`constraint` is the identity, so
the same model code runs on one device.  Placing a tensor across a mesh of
more than one device (``DeviceMesh`` and DTensor placements) is ROADMAP.md
§1 item 15: :func:`constraint` refuses it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

#: where multi-device placement stands in ROADMAP.md
_NOT_PORTED_MESH = "ROADMAP.md §1 item 15, multi-device placement of the rules"

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


def constraint(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The identity outside a rule set, with no mesh, and where every mesh
    axis that the resolved spec names has size 1; a spec that splits ``x``
    over a larger mesh axis raises ``NotImplementedError``."""
    mesh = _mesh()
    if _rules() is None or mesh is None:
        return x
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    for entry in resolve(logical_axes):
        for name in _mesh_axes(entry):
            if sizes.get(name, 1) > 1:
                raise NotImplementedError(
                    f"constraint over mesh axis {name!r} of size {sizes[name]}: placing "
                    f"a tensor across devices is not ported yet ({_NOT_PORTED_MESH})"
                )
    return x


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
