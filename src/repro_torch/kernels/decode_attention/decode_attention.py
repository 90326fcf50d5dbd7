"""Wrapper of the ``decode_attention`` CUDA kernel (``csrc/decode_attention.cu``).

For tensors that lie on the CPU it returns the plain torch version
(:func:`repro_torch.kernels.decode_attention.ref.decode_attention_ref`); for
CUDA tensors it checks device, dtype, shape and contiguity, plans the
split-KV grid (:func:`repro_torch.kernels.decode_attention.split.plan_splits`,
from the shapes and the card's SM count, never from the lengths), allocates
the f32 scratch of the splits' partials, launches the hand-written kernel
on the current stream and adds one to ``decode_attention.launches`` — or
raises.  There is no fallback from the card to the plain version.

With more than one split, the last block of each output row to finish
merges the row's partials; it finds out by an int32 arrival counter, which
it resets to 0.  The counters live in one zeroed buffer per (device,
stream), kept between calls, so that a call pays no memset: calls on one
stream run in order, and calls on two streams never share counters.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wrap import check, launch, on_cpu
from repro_torch.kernels.decode_attention import ref, split

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 256


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float] + [i] * 3 + [p]
    lib.decode_attention_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: the arrival counters, one zeroed buffer per (device, stream)
_COUNTERS: dict = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,  # (B, S, K, D)
    length: torch.Tensor,  # (B,) int32 valid KV length
    *,
    scale: Optional[float] = None,
    start: Optional[torch.Tensor] = None,  # (B,) int32 first valid key
) -> torch.Tensor:
    """One query token per row against a GQA KV cache: ``(B, H, D)`` in
    q's dtype.  Keys ``start[b] <= t < length[b]`` are valid (lengths are
    clamped to ``[0, S]``, starts to ``[0, length]``; ``start=None`` means
    0); the default scale is ``D ** -0.5``."""
    extra = () if start is None else (start,)
    if on_cpu(q, k, v, length, *extra):
        return ref.decode_attention_ref(q, k, v, length, scale=scale, start=start)
    b, h, d = q.shape
    s, kheads = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: expected one of {_DTYPES}, got {q.dtype}")
    if kheads == 0 or h % kheads:
        raise ValueError(f"query heads {h} not divisible by KV heads {kheads}")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} exceeds the kernel's {_MAX_HEAD_DIM}")
    check("q", q, q.dtype, (b, h, d))
    check("k", k, q.dtype, (b, s, kheads, d))
    check("v", v, q.dtype, (b, s, kheads, d))
    check("length", length, torch.int32, (b,))
    if start is not None:
        check("start", start, torch.int32, (b,))
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if b:
        dev = torch.device("cuda", q.device.index if q.device.index is not None
                           else torch.cuda.current_device())
        split_len, n_splits = split.plan_splits(b, kheads, s, _sm_count(dev.index))
        scratch = counters = None
        if n_splits > 1:
            scratch = torch.empty((b * h * n_splits * (d + 2),), dtype=torch.float32, device=dev)
            counters = _counters(dev, b * kheads * -(-(h // kheads) // 8))
        launch(_lib().decode_attention_launch, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), length.data_ptr(),
               start.data_ptr() if start is not None else None, out.data_ptr(),
               scratch.data_ptr() if scratch is not None else None,
               counters.data_ptr() if counters is not None else None,
               b, h, kheads, s, d, int(q.dtype == torch.bfloat16), float(scale),
               split_len, n_splits, device=dev)
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
