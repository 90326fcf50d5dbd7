"""The plain torch version of the ``decode_attention`` kernel equals the
reference package's Pallas kernel (interpret mode) and its ``ref.py``
oracle on the same seeded inputs.

Tolerances: float32 atol = rtol = 1e-5 (the same float32 arithmetic in
another summation order); bfloat16 atol = rtol = 8e-3, one bfloat16
rounding step (2^-7 relative) of outputs that both sides compute in
float32 and round once.  A row of length 0 gives 0 in the TPU kernel and
in the port; the reference's ``ref.py`` gives NaN there, so that case is
held against the kernel only.

The kernel's split-KV plan (``split.py``) is held here too: every key in
exactly one split, and the grid within CUDA's limits.  So is the per-row
``start`` of the sliding-window layers' caches: the plain version with
``start`` against the reference's windowed ``decode_gqa_attention`` over
ring and padded caches (float32, atol = rtol = 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_jit

from repro.kernels.decode_attention.decode_attention import decode_attention as j_kernel
from repro.kernels.decode_attention.ref import decode_attention_ref as j_ref
from repro.models import common as jcommon

from repro_torch.kernels.decode_attention import decode_attention as T
from repro_torch.kernels.decode_attention import ops as tops
from repro_torch.kernels.decode_attention import split as tsplit
from repro_torch.kernels.decode_attention.ref import decode_attention_ref as t_ref
from repro_torch.models import common as tcommon
from repro_torch.models.transformer import DecodeSpan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=8e-3, rtol=8e-3)}

#: (B, S, K, G, D): ragged S, G in {1, 4}, several head dims
SHAPES = [
    (3, 37, 2, 4, 64),
    (3, 16, 4, 1, 32),
    (3, 130, 1, 4, 128),
    (4, 161, 8, 4, 64),
]


def inputs(shape, dtype, seed=0, lengths=None):
    """Seeded numpy inputs; lengths default to 1, a partial and the full S."""
    b, s, k, g, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, k * g, d)).astype(np.float32)
    kk = rng.standard_normal((b, s, k, d)).astype(np.float32)
    vv = rng.standard_normal((b, s, k, d)).astype(np.float32)
    if lengths is None:
        lengths = [1, max(1, s // 2 + 3), s] + [int(rng.integers(1, s + 1)) for _ in range(b - 3)]
    length = np.asarray(lengths[:b], dtype=np.int32)
    if dtype == "bfloat16":  # round once, then feed both packages the same values
        q, kk, vv = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                     for x in (q, kk, vv))
    return q, kk, vv, length


def to_torch(x, dtype):
    return torch.as_tensor(x).to(getattr(torch, dtype))


def to_jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def run_both(shape, dtype, scale=None, lengths=None, blk_s=16):
    q, k, v, length = inputs(shape, dtype, lengths=lengths)
    got = t_ref(to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype),
                torch.as_tensor(length), scale=scale)
    jargs = (to_jax(q, dtype), to_jax(k, dtype), to_jax(v, dtype))
    kern = j_kernel(*jargs, jnp.asarray(length), scale=scale, blk_s=blk_s, interpret=True)
    oracle = j_ref(*jargs, scale=scale, length=jnp.asarray(length))
    return (got.float().numpy(), np.asarray(kern.astype(jnp.float32)),
            np.asarray(oracle.astype(jnp.float32)), got.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_kernel_and_oracle(shape, dtype):
    got, kern, oracle, out_dtype = run_both(shape, dtype)
    assert out_dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    np.testing.assert_allclose(got, oracle, **TOL[dtype])


@pytest.mark.parametrize("scale", [0.05, 0.3, 1.0])
def test_scale_override(scale):
    got, kern, oracle, _ = run_both(SHAPES[0], "float32", scale=scale)
    np.testing.assert_allclose(got, kern, **TOL["float32"])
    np.testing.assert_allclose(got, oracle, **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_rows_give_zero_like_the_kernel(dtype):
    shape = (3, 37, 2, 4, 64)
    got, kern, oracle, _ = run_both(shape, dtype, lengths=[0, 5, 0])
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    assert np.all(got[0] == 0) and np.all(got[2] == 0)
    assert np.isnan(oracle[0]).all()  # the reference's oracle: softmax of all -inf
    np.testing.assert_allclose(got[1], oracle[1], **TOL[dtype])


@pytest.mark.parametrize("blk_s", [8, 16, 512])
def test_pallas_tiling_does_not_matter(blk_s):
    """Held against several of the TPU kernel's sequence tilings (padded
    ragged last block included)."""
    got, kern, _, _ = run_both((2, 45, 2, 2, 64), "float32", blk_s=blk_s)
    np.testing.assert_allclose(got, kern, **TOL["float32"])


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, k, v, length = (torch.as_tensor(x) for x in inputs(SHAPES[0], "float32"))
    before = T.decode_attention.launches
    got = T.decode_attention(q, k, v, length, scale=0.2)
    assert torch.equal(got, t_ref(q, k, v, length, scale=0.2))
    assert T.decode_attention.launches == before


def test_ops_defaults_and_plain_switch():
    q, k, v, _ = (torch.as_tensor(x) for x in inputs(SHAPES[1], "float32"))
    full = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32)
    want = t_ref(q, k, v, full)
    assert torch.equal(tops.gqa_decode_attention(q, k, v), want)
    assert torch.equal(tops.gqa_decode_attention(q, k, v, use_kernel=False), want)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    from repro.kernels.decode_attention.ops import gqa_decode_attention as j_ops

    np.testing.assert_allclose(want.numpy(), np.asarray(j_ops(jq, jk, jv, use_kernel=False)),
                               **TOL["float32"])


def test_wrapper_never_falls_back_off_the_cpu():
    """Tensors on a device that is neither the CPU nor CUDA raise instead
    of quietly taking the plain version; so does a device mix."""
    q, k, v, length = (torch.as_tensor(x) for x in inputs(SHAPES[1], "float32"))
    with pytest.raises(ValueError, match="unsupported device"):
        T.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), length.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        T.decode_attention(q, k.to("meta"), v, length)


@pytest.mark.parametrize("pos", [0, 7, 36])
def test_linear_cache_decode_is_the_kernel_with_length_pos_plus_one(pos):
    """The reference's decode attention on a linear cache (kv_pos = slot,
    valid when kv_pos <= pos) equals the kernel's function at
    length = pos + 1 — the identity the port's serving path rests on."""
    q, k, v, _ = inputs((3, 37, 2, 4, 64), "float32", seed=pos)
    b, c = k.shape[:2]
    kv_pos = jnp.broadcast_to(jnp.arange(c)[None, :], (b, c))
    want = jcommon.decode_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        kv_pos, jnp.int32(pos))
    length = torch.full((b,), pos + 1, dtype=torch.int32)
    got = tcommon.decode_gqa_attention(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


#: the reference's oracle and windowed decode attention, each shape compiled
#: once (op by op, each call would compile every operation anew)
J_REF = reference_jit.jit(j_ref)
J_DECODE = reference_jit.jit(jcommon.decode_gqa_attention, static_argnames=("window",))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lengths_past_the_cache_match_the_oracle(dtype):
    """Lengths past S are clamped to S, as the reference's ``ref.py``
    masks ``arange(S) < length`` (its Pallas kernel pads K and V with zero
    keys there instead; ROADMAP.md §3).  The row of length 0 gives 0 (the
    oracle NaN)."""
    q, k, v, length = inputs((4, 40, 2, 4, 64), dtype, seed=3, lengths=[0, 40, 41, 1000])
    got = t_ref(to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype),
                torch.as_tensor(length)).float().numpy()
    oracle = np.asarray(J_REF(to_jax(q, dtype), to_jax(k, dtype), to_jax(v, dtype),
                              length=jnp.asarray(length)).astype(jnp.float32))
    assert np.all(got[0] == 0) and np.isnan(oracle[0]).all()
    np.testing.assert_allclose(got[1:], oracle[1:], **TOL[dtype])


#: (cache slots C, window, decode position): rings of C = min(window,
#: seq_len) slots (filling, full, wrapped, narrower than the window) and
#: caches grown past the window by pad_cache (the window inside, at its
#: end, and before it reaches the window)
RINGS = [(16, 16, 5), (16, 16, 15), (16, 16, 37), (12, 16, 30), (48, 16, 20), (48, 16, 47),
         (48, 16, 10), (48, 48, 30)]


@pytest.mark.parametrize("c,window,pos", RINGS, ids=lambda x: str(x))
def test_ring_cache_decode_is_the_kernel_with_a_start(c, window, pos):
    """The reference's decode attention over a local layer's cache (slot i
    holds position ``pos - ((pos - i) % C)`` in a ring, ``i`` in a padded
    cache; valid when ``0 <= kv_pos <= pos`` and ``kv_pos > pos - window``)
    equals the kernel's function on the slot range ``[start, length)`` that
    ``DecodeSpan`` gives — the identity the port's windowed decode rests
    on."""
    q, k, v, _ = inputs((3, c, 2, 4, 64), "float32", seed=pos)
    b = k.shape[0]
    idx = np.arange(c, dtype=np.int32)
    kv_pos = idx if c > window else pos - ((pos - idx) % c)
    kv_pos = np.broadcast_to(kv_pos[None, :], (b, c))
    want = J_DECODE(q, k, v, kv_pos, np.int32(pos), window=window)
    span = DecodeSpan(c, pos, window, b, torch.device("cpu"))
    assert span.slot == pos % c
    assert (span.start is not None) == (c > window and pos >= window)
    got = t_ref(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), span.length,
                start=span.start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    assert torch.equal(tops.gqa_decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                                 torch.as_tensor(v), span.length,
                                                 start=span.start), got)


def test_a_padded_cache_past_its_slots_raises():
    """Past C a padded cache's window would wrap into two slot ranges; the
    serving engine stops at ``max_len - 1``."""
    with pytest.raises(ValueError, match="wider than the window"):
        DecodeSpan(48, 48, 16, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="past a 8-slot cache"):
        DecodeSpan(8, 8, None, 2, torch.device("cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_start_masks_the_keys_before_it(dtype):
    """Per-row ``start``: inside a row, at 0, equal to the length (the row
    gives 0) and past it; against the oracle on the same keys, each row
    cut to its ``[start, length)``."""
    q, k, v, length = inputs((4, 300, 2, 4, 64), dtype, seed=9, lengths=[300, 200, 130, 50])
    start = np.asarray([130, 0, 130, 60], np.int32)
    got = t_ref(to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype),
                torch.as_tensor(length), start=torch.as_tensor(start)).float().numpy()
    assert np.all(got[2] == 0) and np.all(got[3] == 0)
    for row in (0, 1):
        lo, hi = start[row], length[row]
        want = J_REF(to_jax(q[row:row + 1], dtype), to_jax(k[row:row + 1, lo:hi], dtype),
                     to_jax(v[row:row + 1, lo:hi], dtype))
        np.testing.assert_allclose(got[row:row + 1], np.asarray(want.astype(jnp.float32)),
                                   **TOL[dtype])
    zero = t_ref(to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype),
                 torch.as_tensor(length), start=torch.zeros(4, dtype=torch.int32))
    assert torch.equal(zero, t_ref(to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype),
                                   torch.as_tensor(length)))


#: (B, K, S, SM count): the serving and long shapes, B = 1 at S = 32,768,
#: an empty cache, one SM, and batches far past the card's width
PLANS = [(4, 8, 161, 132), (8, 8, 8192, 132), (1, 8, 32768, 132), (2, 2, 0, 132),
         (1, 1, 1, 132), (3, 4, 1000, 1), (4096, 8, 4096, 132), (1, 1, 10**7, 132),
         (5, 3, 65, 16), (1, 1, 64, 132)]


@pytest.mark.parametrize("b,kheads,s,sms", PLANS, ids=lambda x: str(x))
def test_plan_splits_covers_every_key_once(b, kheads, s, sms):
    split_len, n = tsplit.plan_splits(b, kheads, s, sms)
    assert n >= 1 and split_len >= 1 and split_len % tsplit.SPLIT_ALIGN == 0
    # splits [j·L, (j+1)·L) for j < n: they tile [0, S) with none empty
    assert split_len * n >= s and (n - 1) * split_len < max(s, 1)
    assert n <= tsplit.MAX_SPLITS  # gridDim.y
    assert b * kheads <= 2**31 - 1  # gridDim.x (one block per (b, kh) and group chunk)
    if s >= 2 * tsplit.MIN_SPLIT and b * kheads < sms:
        assert n >= 2  # a narrow batch is spread over more blocks than rows
