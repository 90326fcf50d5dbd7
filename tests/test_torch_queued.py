"""The queued protocol (``steady-queued``) in the port's batched engine
against the reference package (tolerance 0): the presampled streams, the
reference's pinned queued trace hashes, every trace field, ``run_batched``'s
whole dict, the refusals, and a reference state carried across mid-stream.

The reference runs with ``use_kernel=False`` in JAX on the CPU; the port
runs with ``device="cpu"``, through its kernel wrappers' plain versions
(``use_kernel=True``) and through its plain lowering (``use_kernel=False``).
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.sim import batched as jb
from repro.sim import simulator as jsim

from repro_torch import api as tapi
from repro_torch.core import mig as tmig
from repro_torch.sim import batched as tb
from repro_torch.sim import simulator as tsim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps torch's idle
    worker threads from competing with the other test processes for the
    CPU when files run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MIXED = "a100-80:3,a100-40:3"
RUNS = 3

#: the reference's pinned queued results (tests/test_engine_core.py)
GOLDEN_QUEUED_TRACE_HASHES = {
    "homog": "e3d1a83fced05aaa968ff95c2d9e3ed5d71839e2e12d4c6634e0389f80918925",
    "mixed": "e368416188f84d500dbb7115410d3a24152fa06eac0dce525001032273a9f32f",
}
#: (policy, SimConfig keywords, fleet) of each pinned hash
GOLDEN_CASES = {
    "homog": ("mfi", dict(num_gpus=5, offered_load=1.2, seed=7), None),
    "mixed": ("mfi-queued", dict(offered_load=1.1, seed=9), MIXED),
}
#: the hash's field order in the reference's test
HASH_FIELDS = ("ok", "gpu", "aidx", "parked", "wadm_eidx", "wadm_gpu", "wadm_aidx",
               "free_sum", "active", "frag")


def twin_configs(fleet=None, **kw):
    """(port SimConfig, reference SimConfig) of one description."""
    if fleet is None:
        return tsim.SimConfig(**kw), jsim.SimConfig(**kw)
    return (tsim.SimConfig(cluster_spec=tmig.ClusterSpec.parse(fleet), **kw),
            jsim.SimConfig(cluster_spec=jmig.ClusterSpec.parse(fleet), **kw))


def jax_common(cfg, rows, cols):
    spec = cfg.spec()
    return dict(metric=cfg.metric, num_gpus=cfg.num_gpus, ring_rows=rows, ring_cols=cols,
                use_kernel=False, protocol="steady-queued", wait_slots=cfg.wait_capacity,
                wait_patience=cfg.wait_patience, midx=jnp.asarray(spec.model_index),
                tables=jb.spec_tables(spec))


def to_jax(events):
    return jax.tree.map(lambda a: jnp.asarray(a) if a is not None else None, events)


@functools.lru_cache(maxsize=None)
def reference(tag):
    """The reference's queued stream and trace of a pinned case."""
    policy, kw, fleet = GOLDEN_CASES[tag]
    _, cfg = twin_configs(fleet, **kw)
    events, _, rows, cols = jb.presample_arrivals(cfg, RUNS, queued=True)
    _, trace = jax.device_get(jb._simulate(to_jax(events), policy=policy,
                                           **jax_common(cfg, rows, cols)))
    return events, trace


def port_run(policy, cfg, use_kernel, events=None, rows=None, state=None):
    """The port's queued trace (numpy) and final state over ``cfg``'s stream."""
    if events is None:
        events, _, *rows = tb.presample_arrivals(cfg, RUNS, queued=True)
    spec = cfg.spec()
    final, trace = tb._simulate(
        events, policy=policy, metric=cfg.metric, num_gpus=cfg.num_gpus,
        ring_rows=rows[0], ring_cols=rows[1], use_kernel=use_kernel, kernel_spec=spec,
        protocol="steady-queued", wait_slots=cfg.wait_capacity,
        wait_patience=cfg.wait_patience, midx=torch.as_tensor(spec.model_index),
        tables=tb.spec_tables(spec, "cpu"), state=state, device="cpu",
    )
    return tb.trace_to_numpy(trace), final


def assert_traces_equal(got, want):
    for name in tb.EventTrace._fields:
        g, w = getattr(got, name), getattr(want, name, None)
        assert (g is None) == (w is None), name
        if w is not None:
            w = np.asarray(w)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("tag", sorted(GOLDEN_CASES))
def test_golden_queued_trace_hashes(tag, use_kernel):
    policy, kw, fleet = GOLDEN_CASES[tag]
    cfg, _ = twin_configs(fleet, **kw)
    trace, _ = port_run(policy, cfg, use_kernel)
    h = hashlib.sha256()
    for name in HASH_FIELDS:
        h.update(np.ascontiguousarray(getattr(trace, name)).tobytes())
    assert h.hexdigest() == GOLDEN_QUEUED_TRACE_HASHES[tag]
    assert (trace.wadm_eidx >= 0).sum() > 0 and trace.parked.sum() > 0


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("tag", sorted(GOLDEN_CASES))
def test_queued_trace_equals_reference(tag, use_kernel):
    policy, kw, fleet = GOLDEN_CASES[tag]
    cfg, _ = twin_configs(fleet, **kw)
    got, _ = port_run(policy, cfg, use_kernel)
    assert_traces_equal(got, reference(tag)[1])


@pytest.mark.parametrize("tag", sorted(GOLDEN_CASES))
def test_presample_queued_is_byte_identical(tag):
    """The queued stream equals the reference's field by field, and its
    steady fields equal the ``queued=False`` stream (tenant and priority
    are drawn after the shared arrival stream)."""
    _, kw, fleet = GOLDEN_CASES[tag]
    tcfg, jcfg = twin_configs(fleet, **kw)
    t_ev, t_meta, *t_ring = tb.presample_arrivals(tcfg, RUNS, queued=True)
    j_ev, j_meta, *j_ring = jb.presample_arrivals(jcfg, RUNS, queued=True)
    assert t_ring == j_ring
    for name in tb.EventStream._fields:
        got, want = getattr(t_ev, name), getattr(j_ev, name)
        if name in ("fail", "recover"):  # the faulted protocol's lanes
            assert got is None and want is None, name
            continue
        assert got is not None and want is not None, name
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == np.ascontiguousarray(want).tobytes(), name
    for got, want in zip(t_meta, j_meta):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    plain, p_meta, *p_ring = tb.presample_arrivals(tcfg, RUNS)
    assert p_ring == t_ring
    for name in tb.EventStream._fields:
        steady = getattr(plain, name)
        if steady is None:  # a queued-only field, or a faulted-only lane
            assert name in ("slot", "end", "prio", "tenant", "wlive", "fail", "recover"), name
            continue
        assert steady.tobytes() == getattr(t_ev, name).tobytes(), name
    assert t_ev.slot.dtype == t_ev.end.dtype == np.int32
    assert np.array_equal(t_ev.wlive, t_ev.slot < t_ev.slot.max())


def test_run_batched_queued_equals_reference():
    """The reference's configuration (tests/test_engine_core.py,
    test_run_batched_queued_metrics): the whole dict, the queued keys
    included, on both lowerings and through ``api.simulate``."""
    kw = dict(num_gpus=8, offered_load=1.2, seed=5, protocol="steady-queued")
    tcfg, jcfg = twin_configs(**kw)
    want = jb.run_batched("mfi", jcfg, runs=RUNS)
    for use_kernel in (False, True):
        got = tb.run_batched("mfi", tcfg, runs=RUNS, use_kernel=use_kernel, device="cpu")
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(got[k], v), (use_kernel, k)
    via_api = tapi.simulate("mfi", engine="batched", runs=RUNS, device="cpu", **kw)
    assert all(np.array_equal(via_api[k], v) for k, v in want.items())
    assert {"wait_p50", "wait_p99", "fairness", "queue_admits"} <= got.keys()
    assert got["queue_admits"] > 0


def test_queued_refusals():
    """A defrag spec and ``wait_slots <= 0`` raise as in the reference."""
    cfg = tsim.SimConfig(num_gpus=4, offered_load=1.0, seed=1, protocol="steady-queued")
    with pytest.raises(ValueError, match="defrag"):
        tb.run_batched("mfi-defrag", cfg, runs=2, device="cpu")
    events, _, rows, cols = tb.presample_arrivals(cfg, 2, queued=True)
    with pytest.raises(ValueError, match="wait_slots"):
        tb._simulate(events, policy="mfi", metric=cfg.metric, num_gpus=cfg.num_gpus,
                     ring_rows=rows, ring_cols=cols, use_kernel=False,
                     protocol="steady-queued", wait_slots=0, device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
def test_state_carried_from_reference_continues_identically(use_kernel):
    """The reference runs the first half of the homogeneous pinned stream;
    the port continues from its carry (the wait ring and ``ev`` included)
    and reproduces the reference's second half."""
    policy, kw, fleet = GOLDEN_CASES["homog"]
    tcfg, jcfg = twin_configs(fleet, **kw)
    jev, want = reference("homog")
    _, _, rows, cols = jb.presample_arrivals(jcfg, RUNS, queued=True)
    half = jev.pid.shape[0] // 2
    first = jb.EventStream(*[None if a is None else a[:half] for a in jev])
    carry, _ = jax.device_get(jb._simulate(to_jax(first), policy=policy,
                                           **jax_common(jcfg, rows, cols)))
    d = carry._asdict()
    assert d["wait_pid"].shape == (RUNS, jcfg.wait_capacity)
    assert (d["wait_pid"] >= 0).any() and (d["ev"] == half).all()
    state = tb.state_from_numpy(d, "cpu")
    tev, _, _, _ = tb.presample_arrivals(tcfg, RUNS, queued=True)
    second = tb.EventStream(*[None if a is None else a[half:] for a in tev])
    got, final = port_run(policy, tcfg, use_kernel, events=second, rows=(rows, cols),
                          state=state)
    assert_traces_equal(got, type(want)(*[None if a is None else np.asarray(a)[half:]
                                         for a in want]))
    assert (tb.state_to_numpy(final)["ev"] == jev.pid.shape[0]).all()
