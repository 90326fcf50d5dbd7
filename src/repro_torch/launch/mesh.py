"""Device meshes: the port's counterpart of the JAX package's
``launch/mesh.py``.

A :class:`Mesh` names its axes and their sizes; :func:`make_host_mesh` is
the degenerate 1×1 mesh over one device, on which every
``sharding.constraint`` is the identity.  :func:`make_production_mesh`
describes the reference's TPU pod meshes by shape and axis names only: it
holds no devices and starts no process group (a ``DeviceMesh`` over real
devices is ROADMAP.md §1 item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Optional[Tuple[torch.device, ...]] = None  # None: described only


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 chips.  Multi-pod adds pod=2."""
    if multi_pod:
        return Mesh((POD_AXIS_SIZE, DATA_AXIS_SIZE, MODEL_AXIS_SIZE), ("pod", "data", "model"))
    return Mesh((DATA_AXIS_SIZE, MODEL_AXIS_SIZE), ("data", "model"))


def make_host_mesh(device=None) -> Mesh:
    """Degenerate 1×1 ``("data", "model")`` mesh over one device
    (``device=None`` means the card)."""
    return Mesh((1, 1), ("data", "model"), (resolve_device(device),))


MODEL_AXIS_SIZE = 16
DATA_AXIS_SIZE = 16
POD_AXIS_SIZE = 2
