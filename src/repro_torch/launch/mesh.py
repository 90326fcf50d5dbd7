"""Device meshes: the port's counterpart of the JAX package's
``launch/mesh.py``.

A :class:`Mesh` names its axes and their sizes and, when a process group
of that many ranks is up, holds the ``torch.distributed``
``DeviceMesh`` it stands for (:func:`make_mesh`), on which
``sharding.constraint`` and ``steps.place`` place DTensors.
:func:`make_host_mesh` is the degenerate 1×1 mesh over one device, with
no process group, on which every ``sharding.constraint`` is the identity.
:func:`make_production_mesh` builds the reference's pod meshes over a
running group of 256 or 512 ranks (the dry run's ``fake`` group), and is a
description by shape and axis names only when no such group is up.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional, Tuple

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Optional[Tuple[torch.device, ...]] = None  # None: described only
    device_mesh: Any = None  # torch.distributed DeviceMesh; None: no group


def _group_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """This rank's device under a running process group: ``cuda:<local
    rank>`` when the machine has a card for every local rank, else
    ``cuda:0`` (several ranks on one card: the one-card check of the
    placement code and nothing else, since such ranks share the card's
    memory and compute); ``device="cpu"`` (or ``"meta"``) as asked.
    ``device=None`` means the card, and raises with none."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    return torch.device("cuda", local if torch.cuda.device_count() >= local_world else 0)


def make_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...], device=None) -> Mesh:
    """A mesh of ``shape`` over the running process group's ranks (real,
    ``gloo`` or ``nccl``, or ``fake``), which must hold ``prod(shape)``
    ranks; the ``DeviceMesh`` is built with ``init_device_mesh``.  Each
    rank's device is :func:`rank_device` (``cuda:<local rank>``, or
    ``cuda:0`` for every rank on a one-card machine: that is the one-card
    check and nothing else); ``device="cpu"`` for the CPU.  With no card
    and no ``device="cpu"`` it raises."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axis_names = tuple(shape), tuple(axis_names)
    n = _group_size()
    if n != math.prod(shape):
        raise RuntimeError(f"a {shape} mesh needs a process group of {math.prod(shape)} "
                           f"ranks; {n or 'none'} running")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dm = init_device_mesh("cpu" if dev.type == "meta" else dev.type, shape,
                          mesh_dim_names=axis_names)
    return Mesh(shape, axis_names, (dev,), dm)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: (data=16, model=16) = 256 chips.  Multi-pod adds pod=2.
    Over a running group of that many ranks it is :func:`make_mesh`
    (``device`` as there); otherwise a description."""
    if multi_pod:
        shape, names = (POD_AXIS_SIZE, DATA_AXIS_SIZE, MODEL_AXIS_SIZE), ("pod", "data", "model")
    else:
        shape, names = (DATA_AXIS_SIZE, MODEL_AXIS_SIZE), ("data", "model")
    if _group_size() == math.prod(shape):
        return make_mesh(shape, names, device)
    return Mesh(shape, names)


def make_host_mesh(device=None) -> Mesh:
    """Degenerate 1×1 ``("data", "model")`` mesh over one device
    (``device=None`` means the card), with no process group."""
    return Mesh((1, 1), ("data", "model"), (resolve_device(device),))


MODEL_AXIS_SIZE = 16
DATA_AXIS_SIZE = 16
POD_AXIS_SIZE = 2
