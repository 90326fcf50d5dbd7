"""The port's single-decision scheduler API equals the reference's exactly.

``repro_torch.core.cluster`` (``mfi_select`` in both lowerings,
``placement_feasibility``, ``placement_delta_f``, ``mfi_allocate``,
``release``) and ``repro_torch.kernels.fragscore.ops`` against
``repro.core.cluster`` and ``repro.kernels.fragscore.ops``, on CPU
tensors: the kernel lowering takes ``mfi_delta``'s plain version, the
reference's takes its Pallas kernel in interpret mode.  States are valid
cluster states built through ``ClusterState`` and random bitmaps, both
made from a seed with numpy.  Every key is an integer held in float32, so
every comparison is equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster as jcluster
from repro.core import mig as jmig
from repro.kernels.fragscore import ops as jops

from repro_torch.core import cluster as tcluster
from repro_torch.core import mig as tmig
from repro_torch.core import schedulers as tschedulers
from repro_torch.kernels.fragscore import fragscore as tk
from repro_torch.kernels.fragscore import ops as tops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODELS = ("a100-80gb", "a100-40gb", "h200-141gb")


def both_tables(name):
    return (jcluster.tables_for(jmig.DEVICE_MODELS[name]),
            tcluster.tables_for(tmig.DEVICE_MODELS[name], device="cpu"))


def cluster_states(model, rng, count, m=6):
    """Valid occupancies of ``m`` GPUs of ``model``, built by allocation."""
    out = []
    for _ in range(count):
        cl = tmig.ClusterState(spec=tmig.ClusterSpec.homogeneous(model, m))
        for wid in range(int(rng.integers(0, 4 * m))):
            pid, gpu = int(rng.integers(0, tmig.NUM_PROFILES)), int(rng.integers(0, m))
            anchors = cl.gpus[gpu].feasible_anchors(pid)
            if anchors:
                cl.allocate(wid, pid, gpu, anchors[0])
        out.append(cl.occupancy_matrix())
    return out


def bitmaps(model, rng, count, m=40):
    return [(rng.random((m, model.num_mem_slices)) < fill).astype(np.int32)
            for fill in np.linspace(0.0, 1.0, count)]


def assert_decision_equal(got, want):
    for field, a, b in zip(tcluster.MFIDecision._fields, got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), (field, a, b)


@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_mfi_select_equals_reference(name, use_kernel, metric):
    model = tmig.DEVICE_MODELS[name]
    jt, tt = both_tables(name)
    rng = np.random.default_rng([len(name), use_kernel, len(metric)])
    states = cluster_states(model, rng, 12) + bitmaps(model, rng, 5)
    for occ in states:
        for pid in range(tmig.NUM_PROFILES):
            # the reference's decision in either lowering
            wants = [jcluster.mfi_select(jnp.asarray(occ), jnp.int32(pid), metric, jt,
                                         use_kernel=k) for k in (use_kernel, not use_kernel)]
            for p in (pid, torch.tensor(pid, dtype=torch.int32)):
                got = tcluster.mfi_select(torch.as_tensor(occ), p, metric, tt,
                                          use_kernel=use_kernel)
                for want in wants:
                    assert_decision_equal(got, want)
            # the host scheduler's numpy candidates: same argmin, same ΔF
            gpus, anchors, deltas = tschedulers.mfi_candidates(occ, pid, metric, model)
            if len(gpus) == 0:
                assert not bool(got.accepted)
            else:
                k = np.lexsort((anchors, gpus, deltas))[0]
                assert (int(got.gpu), int(got.anchor)) == (int(gpus[k]), int(anchors[k]))
                np.testing.assert_allclose(float(got.delta_f), deltas[k], rtol=1e-6)


def test_both_lowerings_agree_on_the_default_tables():
    """``tables=None`` is the A100-80GB tables on ``occ``'s device; the
    kernel lowering decides as the dense one (the reference's single seam)."""
    rng = np.random.default_rng(7)
    for occ in bitmaps(tmig.A100_80GB, rng, 6, m=64):
        for pid in range(tmig.NUM_PROFILES):
            o = torch.as_tensor(occ)
            dense = tcluster.mfi_select(o, pid)
            assert_decision_equal(tcluster.mfi_select(o, pid, use_kernel=True), dense)
            assert_decision_equal(dense, jcluster.mfi_select(jnp.asarray(occ), jnp.int32(pid)))


@pytest.mark.parametrize("name", MODELS)
def test_placement_feasibility_and_delta_f_equal_reference(name):
    model = tmig.DEVICE_MODELS[name]
    jt, tt = both_tables(name)
    rng = np.random.default_rng(len(name))
    gpu_ok = rng.random(40) < 0.7
    for occ in bitmaps(model, rng, 4):
        jo, to = jnp.asarray(occ), torch.as_tensor(occ)
        for pid in range(tmig.NUM_PROFILES):
            for ok in (None, gpu_ok):
                want = jcluster.placement_feasibility(
                    jo, jnp.int32(pid), jt, None if ok is None else jnp.asarray(ok))
                got = tcluster.placement_feasibility(
                    to, pid, tt, None if ok is None else torch.as_tensor(ok))
                assert got.dtype == torch.bool and np.array_equal(got.numpy(), np.asarray(want))
            for metric in ("blocked", "partial"):
                want = jcluster.placement_delta_f(jo, jnp.int32(pid), metric, tables=jt)
                got = tcluster.placement_delta_f(to, pid, metric, tables=tt)
                assert got.dtype == torch.float32
                assert np.array_equal(got.numpy(), np.asarray(want))


def test_placement_delta_f_with_the_kernel_backed_frag_fn():
    rng = np.random.default_rng(3)
    for occ in bitmaps(tmig.A100_80GB, rng, 4):
        for pid in range(tmig.NUM_PROFILES):
            for metric in ("blocked", "partial"):
                want = jcluster.placement_delta_f(
                    jnp.asarray(occ), jnp.int32(pid), metric,
                    frag_fn=lambda o: jops.fragmentation_scores(o, metric))
                got = tcluster.placement_delta_f(
                    torch.as_tensor(occ), pid, metric,
                    frag_fn=lambda o: tops.fragmentation_scores(o, metric))
                assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tensor_ids", [False, True])
@pytest.mark.parametrize("metric", ["blocked", "partial"])
def test_allocate_release_stream_equals_reference(metric, tensor_ids):
    """200 steps of mfi_allocate with random releases: the occupancy and
    every decision equal the reference's at every step."""
    rng = np.random.default_rng([len(metric), tensor_ids])
    m = 12
    jo = jnp.zeros((m, 8), jnp.int32)
    to = torch.zeros((m, 8), dtype=torch.int32)
    live = []
    accepted = 0
    for step in range(200):
        pid = int(rng.integers(0, tmig.NUM_PROFILES))
        p = torch.tensor(pid) if tensor_ids else pid
        jo, jd = jcluster.mfi_allocate(jo, jnp.int32(pid), metric)
        before = to.clone()
        to, td = tcluster.mfi_allocate(to, p, metric)
        assert_decision_equal(td, jd)
        assert np.array_equal(to.numpy(), np.asarray(jo)), step
        if bool(td.accepted):
            accepted += 1
            live.append((td.gpu, pid, td.anchor))
        else:
            assert torch.equal(to, before)
        if live and rng.random() < 0.45:
            g, q, a = live.pop(int(rng.integers(0, len(live))))
            jo = jcluster.release(jo, jnp.asarray(g.numpy()), jnp.int32(q), jnp.asarray(a.numpy()))
            if tensor_ids:
                to = tcluster.release(to, g, torch.tensor(q), a)
            else:
                to = tcluster.release(to, int(g), q, int(a))
            assert np.array_equal(to.numpy(), np.asarray(jo)), step
    assert 20 < accepted < 200  # the stream both fills and rejects


def test_rejected_release_is_not_a_noop_as_in_the_reference():
    """``release(occ, -1, pid, -1)`` after a rejected decision clears the
    last GPU's column-0 window (for 1g.10gb, slice 0): the reference's
    behaviour, reproduced."""
    pid = tmig.PROFILE_NAMES.index("1g.10gb")
    want = np.asarray(jcluster.release(jnp.ones((3, 8), jnp.int32), -1, pid, -1))
    assert want[-1].tolist() == [0, 1, 1, 1, 1, 1, 1, 1]
    ones = torch.ones((3, 8), dtype=torch.int32)
    for args in ((-1, pid, -1), (torch.tensor(-1), torch.tensor(pid), torch.tensor(-1))):
        got = tcluster.release(ones, *args)
        assert np.array_equal(got.numpy(), want)
    assert bool((ones == 1).all())  # the input is left unchanged
    # a rejected mfi_allocate leaves the cluster as it was
    occ, d = tcluster.mfi_allocate(ones, pid)
    assert not bool(d.accepted) and (int(d.gpu), int(d.anchor)) == (-1, -1)
    assert torch.equal(occ, ones)


def test_allocate_release_roundtrip():
    occ = torch.zeros((3, 8), dtype=torch.int32)
    pid = tmig.PROFILE_NAMES.index("3g.40gb")
    occ1, d = tcluster.mfi_allocate(occ, pid)
    assert bool(d.accepted)
    assert torch.equal(tcluster.release(occ1, d.gpu, pid, d.anchor), occ)
    assert tcluster.MAX_ANCHORS == jcluster.MAX_ANCHORS == 7


@pytest.mark.parametrize("metric", ["blocked", "partial"])
def test_ops_equal_reference_ops(metric):
    rng = np.random.default_rng(len(metric))
    occ = (rng.random((130, 8)) < 0.45).astype(np.int32)
    jo, to = jnp.asarray(occ), torch.as_tensor(occ)
    f_j = np.asarray(jops.fragmentation_scores(jo, metric))
    f_t = tops.fragmentation_scores(to, metric)
    assert np.array_equal(f_t.numpy(), f_j)
    t = tcluster.tables_for(tmig.A100_80GB, device="cpu")
    base = to.to(torch.float32) @ t.placement_masks.T
    free = 8 - to.sum(dim=1)
    for pid in range(tmig.NUM_PROFILES):
        assert np.array_equal(tops.mfi_delta_f(to, pid, metric).numpy(),
                              np.asarray(jops.mfi_delta_f(jo, jnp.int32(pid), metric)))
        want = jops.delta_from_base_f(jnp.asarray(base.numpy()), jnp.asarray(free.numpy()),
                                      jnp.int32(pid), jnp.asarray(f_j), metric)
        for p in (pid, torch.tensor(pid)):
            got = tops.delta_from_base_f(base, free, p, f_t, metric)
            assert got.shape == (130, 7) and np.array_equal(got.numpy(), np.asarray(want))
        jg, ja, jacc = jops.mfi_select(jo, jnp.int32(pid), metric)
        tg, ta, tacc = tops.mfi_select(to, pid, metric)
        assert (int(tg), int(ta), bool(tacc)) == (int(jg), int(ja), bool(jacc))


def test_ops_refuse_numpy_input():
    occ = np.zeros((4, 8), np.int32)
    before = tk.mfi_delta.launches
    with pytest.raises(TypeError, match="torch.Tensor"):
        tops.fragmentation_scores(occ)
    with pytest.raises(TypeError, match="torch.Tensor"):
        tops.mfi_delta_f(occ, 0)
    with pytest.raises(TypeError, match="torch.Tensor"):
        tops.mfi_select(occ, 0)
    with pytest.raises(TypeError, match="torch.Tensor"):
        tops.delta_from_base_f(np.zeros((4, 18), np.float32), np.full(4, 8), 0, np.zeros(4, np.float32))
    assert tk.mfi_delta.launches == before
