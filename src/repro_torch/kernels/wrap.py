"""Checks and the launch call shared by the port's kernel wrappers.

A wrapper takes its plain torch version when every operand lies on the CPU
(:func:`on_cpu`); for CUDA operands it validates each with :func:`check`
and launches through :func:`launch`, which raises on a refused launch.
"""

from __future__ import annotations

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU; raises on a device mix or
    on a device that is neither the CPU nor CUDA."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(fn, *args, device: torch.device) -> None:
    """Call a C launcher with ``(*args, device index, current stream)`` and
    raise unless it returns ``cudaSuccess``.  The stream is read as a raw
    pointer (what ``torch.cuda.current_stream(i).cuda_stream`` returns,
    without building a ``Stream`` object on every launch)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    rc = fn(*args, index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")
