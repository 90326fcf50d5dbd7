"""The port's ``mfi_delta`` plain version equals the reference's Pallas
``mfi_delta`` kernel in interpret mode exactly, ``1e30`` sentinel included.

Occupancy bitmaps are made from a seed with numpy and handed to both
packages; every device model's own placement tables (A100-80GB, A100-40GB
with its padded anchors and an unplaceable class, H200-141GB with 12
slices) drive both.  M = 600 crosses the reference's 512-row block.  On
CPU tensors the wrapper is the plain version; the CUDA kernel is held to
it on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_jit

from repro.core import schedulers as jschedulers
from repro.kernels.fragscore import fragscore as jk

from repro_torch.core import cluster as tcluster
from repro_torch.core import mig as tmig
from repro_torch.core import schedulers as tschedulers
from repro_torch.kernels.fragscore import fragscore as tk
from repro_torch.kernels.fragscore import ref


#: the reference's Pallas kernel in interpret mode, compiled once per shape
J_MFI_DELTA = reference_jit.jit(jk.mfi_delta, static_argnames=("metric", "interpret"))

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODELS = ("a100-80gb", "a100-40gb", "h200-141gb")


def operands(model, pid):
    t = tcluster.tables_for(model, device="cpu")
    return (t.placement_masks, t.placement_mem,
            t.profile_masks[pid].to(torch.float32), t.profile_valid[pid].to(torch.float32))


def pallas(occ, w, v, pm, pv, metric):
    return np.asarray(J_MFI_DELTA(
        jnp.asarray(occ), *(jnp.asarray(x.numpy()) for x in (w, v, pm, pv)),
        metric=metric, interpret=True))


@pytest.mark.parametrize("m", [1, 257, 600])
@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("name", MODELS)
def test_plain_version_equals_pallas_kernel(name, metric, m):
    model = tmig.DEVICE_MODELS[name]
    rng = np.random.default_rng([m, len(name), len(metric)])
    occ = (rng.random((m, model.num_mem_slices)) < 0.45).astype(np.int32)
    for pid in range(tmig.NUM_PROFILES):
        w, v, pm, pv = operands(model, pid)
        got = ref.mfi_delta_ref(torch.as_tensor(occ), w, v, pm, pv, metric)
        want = pallas(occ, w, v, pm, pv, metric)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), (name, metric, m, pid)
        # padded anchors and overlapping windows read exactly the sentinel
        assert np.array_equal(got.numpy() == np.float32(1e30), want == np.float32(1e30))
        assert bool((got[:, pv == 0] == ref.MFI_BIG).all())


@pytest.mark.parametrize("name", MODELS)
def test_non_binary_occupancy_keeps_the_reference_arithmetic(name):
    """Occupancy counts above 1 are clipped in the dry run only, as the
    reference's ``min(occ + mask, 1)`` does: the answer is still its."""
    model = tmig.DEVICE_MODELS[name]
    rng = np.random.default_rng(11)
    occ = rng.integers(0, 3, (64, model.num_mem_slices)).astype(np.int32)
    occ[rng.random(occ.shape) < 0.5] = 0
    for metric in ("blocked", "partial"):
        for pid in range(tmig.NUM_PROFILES):
            w, v, pm, pv = operands(model, pid)
            got = ref.mfi_delta_ref(torch.as_tensor(occ), w, v, pm, pv, metric)
            assert np.array_equal(got.numpy(), pallas(occ, w, v, pm, pv, metric))


@pytest.mark.parametrize("name", MODELS)
def test_cpu_wrapper_is_the_plain_version(name):
    model = tmig.DEVICE_MODELS[name]
    rng = np.random.default_rng(5)
    occ = torch.as_tensor((rng.random((33, model.num_mem_slices)) < 0.45).astype(np.int32))
    before = tk.mfi_delta.launches
    for metric in ("blocked", "partial"):
        for pid in range(tmig.NUM_PROFILES):
            args = (occ,) + operands(model, pid)
            assert torch.equal(tk.mfi_delta(*args, metric=metric),
                               ref.mfi_delta_ref(*args, metric))
    assert tk.mfi_delta.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="unknown metric"):
        tk.mfi_delta(*args, metric="bogus")


@pytest.mark.parametrize("pid", range(tmig.NUM_PROFILES))
def test_feasible_entries_equal_mfi_candidates(pid):
    """Both packages' numpy ``mfi_candidates`` list exactly the entries
    below the sentinel, with the same ΔF (the reference's own check)."""
    rng = np.random.default_rng(pid)
    occ = (rng.random((257, 8)) < 0.35).astype(np.int32)
    delta = ref.mfi_delta_ref(torch.as_tensor(occ), *operands(tmig.A100_80GB, pid)).numpy()
    anchors = list(tcluster.tables_for(tmig.A100_80GB, device="cpu").profile_anchors[pid].numpy())
    for sched in (tschedulers, jschedulers):
        gpus, anc, deltas = sched.mfi_candidates(occ, pid)
        for g, a, d in zip(gpus, anc, deltas):
            np.testing.assert_allclose(delta[g, anchors.index(a)], d, rtol=1e-6)
        assert (delta < 1e29).sum() == len(gpus)


def test_operands_on_other_devices_never_fall_back():
    """No fallback: operands that are not all on the CPU either launch the
    kernel or raise; here a device mix and the meta device raise."""
    args = operands(tmig.A100_80GB, 0)
    occ = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.mfi_delta(occ.to("meta"), *(x.to("meta") for x in args))
    with pytest.raises(ValueError, match="several devices"):
        tk.mfi_delta(occ.to("meta"), *args)
