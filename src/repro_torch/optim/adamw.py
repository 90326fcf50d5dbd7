"""AdamW in plain torch, the reference's arithmetic (no ``torch.optim``).

``torch.optim.AdamW`` decays a weight multiplicatively and works in the
parameter's dtype; the reference adds ``weight_decay · p`` to the update
and computes in float32 before casting back, so it is reproduced here.

Parameters, gradients and moments are flat ``{name: tensor}`` mappings
(an ``nn.Module`` stands for its ``named_parameters()``).  Moments are
stored in ``moment_dtype``: float32 normally, bfloat16 for very large
models where optimizer state dominates memory.  The update runs one leaf
at a time, so its float32 transients never exceed one leaf's size.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def adamw_init(params: Params, moment_dtype: str = "float32") -> Dict[str, object]:
    """Zero moments ``m`` and ``v`` per parameter, and ``step`` 0 (int32)."""
    named = _named(params)
    dt = getattr(torch, moment_dtype)
    step_device = next(iter(named.values())).device if named else None

    def zeros():
        return {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in named.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


@torch.no_grad()
def adamw_update(
    params: Params,
    grads: Mapping[str, torch.Tensor],
    state: Dict[str, object],
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Tuple[Params, Dict[str, object]]:
    """One AdamW step with global-norm clipping, in place.

    ``lr`` is a float or a float32 tensor.  Every parameter and moment is
    overwritten with its new value; returns ``(params, state)`` with
    ``state["step"]`` incremented (a new tensor).
    """
    named = _named(params)
    step = state["step"] + 1

    sq = [torch.sum(torch.square(grads[k].float())) for k in named]
    gnorm = torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    m_all, v_all = state["m"], state["v"]
    for k, p in named.items():
        m, v = m_all[k], v_all[k]
        gf = grads[k].float() * scale
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        update = update + weight_decay * p.float()
        p.copy_(p.float() - lr * update)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, {"m": m_all, "v": v_all, "step": step}
