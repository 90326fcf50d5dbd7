"""The split-KV plan of the ``decode_attention`` kernel.

The kernel (``csrc/decode_attention.cu``) cuts each row's KV cache into
``n_splits`` consecutive splits of ``split_len`` keys; one block per
(batch row, KV head, split) runs an f32 online softmax over its split and
writes a partial ``(m, l, acc)``; the partials of each output row are
merged in split order.  :func:`plan_splits` is the host's choice of the
split: it never reads the lengths, which stay on the device.
"""

from __future__ import annotations

#: split lengths are multiples of this many keys (the bf16 kernel's tile)
SPLIT_ALIGN = 128
#: no split is planned shorter than this: below it, the partials' round
#: trip through device memory costs more than the split saves
MIN_SPLIT = 2 * SPLIT_ALIGN
#: blocks the plan aims for, per SM of the card (two are resident at once)
BLOCKS_PER_SM = 2
#: CUDA's limit on gridDim.y, which counts the splits
MAX_SPLITS = 65535


def plan_splits(b: int, kheads: int, s: int, sm_count: int) -> tuple[int, int]:
    """``(split_len, n_splits)`` for a ``(B, S, K, D)`` cache on a card of
    ``sm_count`` SMs: enough splits that the ``B·K·n_splits`` blocks fill
    the card about ``BLOCKS_PER_SM`` times over, none planned shorter than
    :data:`MIN_SPLIT` keys, each a multiple of :data:`SPLIT_ALIGN`.  Every
    key index in ``[0, S)`` falls in exactly one split; ``S = 0`` gives one
    split."""
    rows = max(1, b * kheads)
    want = -(-BLOCKS_PER_SM * max(1, sm_count) // rows)
    n = max(1, min(want, -(-s // MIN_SPLIT), MAX_SPLITS))
    per_split = -(-s // n)
    split_len = max(1, -(-per_split // SPLIT_ALIGN)) * SPLIT_ALIGN
    return split_len, max(1, -(-s // split_len))
