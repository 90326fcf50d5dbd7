"""Roofline terms of one step, read from the ops it runs: the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``.

The reference parses the compiled per-device HLO text and weights each
op by the trip counts of its enclosing loops.  Nothing here parses HLO:
:class:`OpAnalysis` is a ``TorchDispatchMode`` held around one eager call
of the step, on a mesh of DTensors (the dry run runs it on meta tensors
over a ``fake`` process group), and it sees every op that a rank runs,
each loop iteration included, so no trip count is needed.

The mode returns ``NotImplemented`` for an op with a DTensor argument, so
DTensor dispatches it first (sharding propagation, then the
redistributions and the local op) and the mode sees what one rank runs,
at **local** shapes:

* collective bytes and counts by kind, the result size of each
  ``_c10d_functional`` collective (an all-gather's gathered tensor, an
  all-reduce's tensor, a reduce-scatter's shard), the reference's
  per-device traffic proxy (``hlo_analysis.py``: ring algorithms move
  about a result's size through each device);
* dot FLOPs per device, ``torch.utils.flop_counter``'s count of each
  local ``mm``/``bmm``/``addmm``/``baddbmm`` (2 × the local result × the
  local contraction length); a DTensor's global product is never counted,
  and the ops of DTensor's sharding propagation, which run on fake tensors
  at global shapes, are skipped;
* dot bytes, operands plus result of each such product, as the
  reference's HBM proxy;
* argument bytes, the local bytes of the step's placed arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: the reference's collective kinds, by ``_c10d_functional`` op
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
_DOTS = ("mm", "bmm", "addmm", "baddbmm")


@dataclasses.dataclass
class Analysis:
    """The reference's ``HLOAnalysis`` record, per device."""

    flops: float = 0.0                 # local dot FLOPs
    collective_bytes: float = 0.0      # collective result bytes
    dot_bytes: float = 0.0             # dot operand + result bytes
    argument_bytes: float = 0.0        # the placed arguments' local bytes
    collective_breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_count: int = 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (a DTensor's
    ``to_local()``, a plain tensor whole; a module's parameters)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.nn.Module)):
        tensors = leaf.parameters() if isinstance(leaf, torch.nn.Module) else [leaf]
        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            total += _nbytes(t)
    return total


class OpAnalysis(TorchDispatchMode):
    """Counts one rank's collectives and dot products while active;
    :attr:`result` holds the :class:`Analysis`."""

    def __init__(self):
        super().__init__()
        self.result = Analysis()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar it into local ops first
        out = func(*args, **kwargs)
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(a, FakeTensor) for a in leaves):
            return out  # DTensor's sharding propagation at global shapes
        r = self.result
        packet = func.overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            b = sum(_nbytes(t) for t in tree_leaves(out))
            r.collective_bytes += b
            r.collective_breakdown[kind] = r.collective_breakdown.get(kind, 0.0) + b
            r.collective_count += 1
        elif func.namespace == "aten" and name in _DOTS:
            r.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            r.dot_bytes += _nbytes(out) + sum(_nbytes(a) for a in args)
        return out
