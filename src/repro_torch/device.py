"""The port's device rule: ``device=None`` means the card, never the CPU."""

from __future__ import annotations

import torch


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
