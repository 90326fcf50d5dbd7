"""The faulted protocol (``steady-faulted``) in the port's batched engine
against the reference package (tolerance 0): the reference's pinned faulted
trace hashes, every trace field, the presampled streams and fault tables,
``run_batched``'s whole dict, a zero retry budget, the calm fault model, a
reference state carried across mid-stream, and the host replay
``faulted_host_decisions``.

The reference runs with ``use_kernel=False`` in JAX on the CPU; the port
runs with ``device="cpu"``, through its kernel wrappers' plain versions
(``use_kernel=True``) and through its plain lowering (``use_kernel=False``).
"""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.core.policy import resolve as jresolve
from repro.sim import batched as jb
from repro.sim import replay as jreplay
from repro.sim import simulator as jsim

from repro_torch import api as tapi
from repro_torch.core import mig as tmig
from repro_torch.sim import batched as tb
from repro_torch.sim import replay as treplay
from repro_torch.sim import simulator as tsim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps torch's idle
    worker threads from competing with the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MIXED = "a100-80:3,a100-40:3"
RUNS = 3
#: the fault process of the reference's golden and parity tests
#: (tests/test_faults.py): MTBF 60 slots on a ~200-slot horizon
FM = dict(mtbf=60.0, mttr=10.0)

#: the reference's pinned faulted results (tests/test_faults.py)
GOLDEN_FAULTED_TRACE_HASHES = {
    "homog": "abb15f38d863b0c6ce819b7bb452235f163bf35e876e944c1df4c51e4deaad97",
    "mixed": "1bf958443af4abdbe75e50c4ac1e026875e84b3bbddd2658800f8b7f9079f7fe",
}
#: (policy, SimConfig keywords, fleet) of each pinned hash
GOLDEN_CASES = {
    "homog": ("mfi", dict(num_gpus=5, offered_load=1.2, seed=7), None),
    "mixed": ("mfi-queued", dict(offered_load=1.1, seed=9), MIXED),
}
#: the hash's field order in the reference's test
HASH_FIELDS = ("ok", "gpu", "aidx", "parked", "wadm_eidx", "wadm_gpu", "wadm_aidx",
               "evicted", "evict_lost", "evict_esum", "free_sum", "active", "frag")


def twin_configs(fleet=None, **kw):
    """(port SimConfig, reference SimConfig) of one description."""
    if fleet is None:
        return tsim.SimConfig(**kw), jsim.SimConfig(**kw)
    return (tsim.SimConfig(cluster_spec=tmig.ClusterSpec.parse(fleet), **kw),
            jsim.SimConfig(cluster_spec=jmig.ClusterSpec.parse(fleet), **kw))


def twin_models(**kw):
    """(port FaultModel, reference FaultModel) of one description."""
    return tmig.FaultModel(**kw), jmig.FaultModel(**kw)


def to_jax(events):
    return jax.tree.map(lambda a: jnp.asarray(a) if a is not None else None, events)


def jax_common(cfg, rows, cols, retries=2, backoff=2):
    spec = cfg.spec()
    proto = dataclasses.replace(jb.resolve_protocol("steady-faulted"),
                                fault_retries=retries, fault_backoff=backoff)
    return dict(metric=cfg.metric, num_gpus=cfg.num_gpus, ring_rows=rows, ring_cols=cols,
                use_kernel=False, protocol=proto, wait_slots=cfg.wait_capacity,
                wait_patience=cfg.wait_patience, midx=jnp.asarray(spec.model_index),
                tables=jb.spec_tables(spec))


@functools.lru_cache(maxsize=None)
def reference(tag):
    """The reference's faulted stream and trace of a pinned case.  The
    policy is passed resolved, as ``run_batched`` passes it, so that the
    reference's ``run_batched`` of the same case reuses this compiled
    program."""
    policy, kw, fleet = GOLDEN_CASES[tag]
    _, cfg = twin_configs(fleet, **kw)
    _, fm = twin_models(**FM)
    events, meta, rows, cols = jb.presample_arrivals(cfg, RUNS, queued=True, fault_model=fm)
    _, trace = jax.device_get(jb._simulate(
        to_jax(events), policy=jresolve(policy, engine="batched"),
        **jax_common(cfg, rows, cols, fm.max_retries, fm.backoff_base)))
    return events, meta, trace


def port_run(policy, cfg, fm, use_kernel, events=None, rows=None, state=None):
    """The port's faulted trace (numpy) and final state over ``cfg``'s stream."""
    if events is None:
        events, _, *rows = tb.presample_arrivals(cfg, RUNS, queued=True, fault_model=fm)
    spec = cfg.spec()
    proto = dataclasses.replace(tb.resolve_protocol("steady-faulted"),
                                fault_retries=fm.max_retries, fault_backoff=fm.backoff_base)
    final, trace = tb._simulate(
        events, policy=policy, metric=cfg.metric, num_gpus=cfg.num_gpus,
        ring_rows=rows[0], ring_cols=rows[1], use_kernel=use_kernel, kernel_spec=spec,
        protocol=proto, wait_slots=cfg.wait_capacity, wait_patience=cfg.wait_patience,
        midx=torch.as_tensor(spec.model_index), tables=tb.spec_tables(spec, "cpu"),
        state=state, device="cpu",
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


def faulted_hash(trace):
    h = hashlib.sha256()
    for name in HASH_FIELDS:
        h.update(np.ascontiguousarray(getattr(trace, name)).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("tag", sorted(GOLDEN_CASES))
def test_golden_faulted_trace_hashes(tag, use_kernel):
    policy, kw, fleet = GOLDEN_CASES[tag]
    cfg, _ = twin_configs(fleet, **kw)
    trace, _ = port_run(policy, cfg, tmig.FaultModel(**FM), use_kernel)
    assert faulted_hash(trace) == GOLDEN_FAULTED_TRACE_HASHES[tag]
    assert trace.evicted.sum() > 0 and (trace.wadm_eidx >= 0).sum() > 0


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("tag", sorted(GOLDEN_CASES))
def test_faulted_trace_equals_reference(tag, use_kernel):
    policy, kw, fleet = GOLDEN_CASES[tag]
    cfg, _ = twin_configs(fleet, **kw)
    got, _ = port_run(policy, cfg, tmig.FaultModel(**FM), use_kernel)
    assert_traces_equal(got, reference(tag)[2])


@pytest.mark.parametrize("tag", sorted(GOLDEN_CASES))
def test_presample_faulted_is_byte_identical(tag):
    """The faulted stream equals the reference's field by field, fail and
    recover lanes included, and every other field equals the plain queued
    stream (the fault draws come after every other draw)."""
    _, kw, fleet = GOLDEN_CASES[tag]
    tcfg, _ = twin_configs(fleet, **kw)
    t_ev, t_meta, *t_ring = tb.presample_arrivals(tcfg, RUNS, queued=True,
                                                  fault_model=tmig.FaultModel(**FM))
    j_ev, j_meta, _ = reference(tag)
    for name in tb.EventStream._fields:
        got, want = getattr(t_ev, name), getattr(j_ev, name)
        assert got is not None and want is not None, name
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == np.ascontiguousarray(want).tobytes(), name
    for got, want in zip(t_meta, j_meta):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert t_ev.fail.shape == t_ev.pid.shape + (tcfg.num_gpus,)
    assert t_ev.fail.any() and t_ev.recover.any()
    queued, _, *q_ring = tb.presample_arrivals(tcfg, RUNS, queued=True)
    assert q_ring == t_ring
    for name in tb.EventStream._fields:
        if name in ("fail", "recover"):
            assert getattr(queued, name) is None
            continue
        assert getattr(queued, name).tobytes() == getattr(t_ev, name).tobytes(), name


def test_presample_fault_slots_is_byte_identical():
    """The per-GPU fail/recover tables, per-model rates included, equal the
    reference's from one seeded generator, and leave it in the same state."""
    fleet = "a100-80:2,h100-96:2"
    kw = dict(mtbf=40.0, mttr=6.0, per_model=(("H100-96GB", (25.0, 3.0)),))
    tfm, jfm = twin_models(**kw)
    t_rng, j_rng = np.random.default_rng(11), np.random.default_rng(11)
    got = tb.presample_fault_slots(tmig.ClusterSpec.parse(fleet), tfm, 2, 300, t_rng)
    want = jb.presample_fault_slots(jmig.ClusterSpec.parse(fleet), jfm, 2, 300, j_rng)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert got[0].any() and not (got[0] & got[1]).any()
    assert t_rng.integers(1 << 30) == j_rng.integers(1 << 30)


def test_run_batched_faulted_equals_reference():
    """The reference's configuration (tests/test_faults.py,
    test_run_batched_reports_fault_stats) at R = 3: the whole dict, the
    fault keys included, on both lowerings and through ``api.simulate``."""
    kw = dict(num_gpus=5, offered_load=1.2, seed=7, protocol="steady-faulted")
    tcfg, _ = twin_configs(fault_model=tmig.FaultModel(**FM), **kw)
    _, jcfg = twin_configs(fault_model=jmig.FaultModel(**FM), **kw)
    reference("homog")  # compiles the reference's program of this case once
    want = jb.run_batched("mfi", jcfg, runs=RUNS)
    for use_kernel in (False, True):
        got = tb.run_batched("mfi", tcfg, runs=RUNS, use_kernel=use_kernel, device="cpu")
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(got[k], v), (use_kernel, k)
    via_api = tapi.simulate("mfi", engine="batched", runs=RUNS, device="cpu",
                            fault_model=tmig.FaultModel(**FM), **kw)
    assert all(np.array_equal(via_api[k], v) for k, v in want.items())
    assert got["evictions"] > 0 and got["goodput"] < got["acceptance_rate"]
    with pytest.raises(ValueError, match="fault_model"):
        tb.run_batched("mfi", tsim.SimConfig(**kw), runs=2, device="cpu")


def test_zero_retry_budget_loses_every_eviction():
    """``FaultModel(max_retries=0)``: every eviction is a final loss and
    only parked arrivals are admitted from the wait ring, event for event
    as in the reference's host replay of the same stream."""
    fm = tmig.FaultModel(**FM, max_retries=0)
    policy, kw, fleet = GOLDEN_CASES["homog"]
    cfg, jcfg = twin_configs(fleet, **kw)
    events, meta, *rows = tb.presample_arrivals(cfg, RUNS, queued=True, fault_model=fm)
    got, _ = port_run(policy, cfg, fm, True, events=events, rows=rows)
    assert got.evicted.sum() > 0
    np.testing.assert_array_equal(got.evict_lost, got.evicted)
    want = jreplay.faulted_host_decisions(
        events, meta, policy, cfg.num_gpus, metric=cfg.metric, capacity=cfg.wait_capacity,
        patience=cfg.wait_patience, max_retries=0, backoff_base=fm.backoff_base)
    for name in ("ok", "parked", "wadm_eidx", "evicted", "evict_lost", "evict_esum"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.gpu[want.ok], want.gpu[want.ok])
    adm = np.argwhere(got.wadm_eidx >= 0)
    assert len(adm) and all(got.parked[got.wadm_eidx[e, r], r] for e, r in adm)


def test_calm_fault_model_decides_as_the_queued_protocol():
    """A fault model that never fires (MTBF 10^6 slots) leaves the
    decisions of the queued protocol unchanged."""
    policy, kw, fleet = GOLDEN_CASES["homog"]
    cfg, _ = twin_configs(fleet, **kw)
    faulted, _ = port_run(policy, cfg, tmig.FaultModel(mtbf=1e6, mttr=1.0), False)
    assert faulted.evicted.sum() == 0
    events, _, rows, cols = tb.presample_arrivals(cfg, RUNS, queued=True)
    spec = cfg.spec()
    _, queued = tb._simulate(
        events, policy=policy, metric=cfg.metric, num_gpus=cfg.num_gpus, ring_rows=rows,
        ring_cols=cols, use_kernel=False, protocol="steady-queued",
        wait_slots=cfg.wait_capacity, wait_patience=cfg.wait_patience,
        midx=torch.as_tensor(spec.model_index), tables=tb.spec_tables(spec, "cpu"),
        device="cpu")
    queued = tb.trace_to_numpy(queued)
    for name in ("ok", "gpu", "aidx", "parked", "wadm_eidx", "wadm_gpu", "wadm_aidx",
                 "free_sum", "active", "frag"):
        np.testing.assert_array_equal(getattr(faulted, name), getattr(queued, name),
                                      err_msg=name)


@functools.lru_cache(maxsize=None)
def reference_half(tag):
    """The reference's carry after the first half of a pinned stream."""
    policy, kw, fleet = GOLDEN_CASES[tag]
    _, cfg = twin_configs(fleet, **kw)
    events, _, _ = reference(tag)
    _, _, rows, cols = jb.presample_arrivals(cfg, RUNS, queued=True,
                                             fault_model=jmig.FaultModel(**FM))
    half = events.pid.shape[0] // 2
    first = jb.EventStream(*[None if a is None else a[:half] for a in events])
    carry, _ = jax.device_get(jb._simulate(to_jax(first), policy=jresolve(policy, engine="batched"),
                                           **jax_common(cfg, rows, cols)))
    return half, (rows, cols), carry._asdict()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
def test_state_carried_from_reference_continues_identically(use_kernel):
    """The reference runs the first half of the homogeneous pinned stream;
    the port continues from its carry (up-mask, fault ring planes and
    retry bookkeeping included) and reproduces the reference's second
    half."""
    policy, kw, fleet = GOLDEN_CASES["homog"]
    tcfg, _ = twin_configs(fleet, **kw)
    half, rows, d = reference_half("homog")
    assert (~d["up"]).any() and (d["ring_end"] > 0).any() and (d["ev"] == half).all()
    state = tb.state_from_numpy(d, "cpu")
    tev, _, _, _ = tb.presample_arrivals(tcfg, RUNS, queued=True,
                                         fault_model=tmig.FaultModel(**FM))
    second = tb.EventStream(*[None if a is None else a[half:] for a in tev])
    got, final = port_run(policy, tcfg, tmig.FaultModel(**FM), use_kernel, events=second,
                          rows=rows, state=state)
    want = reference("homog")[2]
    assert_traces_equal(got, type(want)(*[None if a is None else np.asarray(a)[half:]
                                         for a in want]))
    out = tb.state_to_numpy(final)
    assert (out["ev"] == tev.pid.shape[0]).all()
    assert {"up", "ring_end", "ring_eidx", "ring_prio", "ring_ten", "wait_try",
            "wait_rdy"} <= out.keys()


@pytest.mark.parametrize("tag", sorted(GOLDEN_CASES))
def test_faulted_host_decisions_equal_reference_and_engine(tag):
    """The port's host replay of the faulted protocol equals the
    reference's on the same stream, field for field, and the port's engine
    equals it event for event (anchors compared through the placement
    tables: the engine records indices, the host anchor values)."""
    policy, kw, fleet = GOLDEN_CASES[tag]
    tcfg, _ = twin_configs(fleet, **kw)
    events, meta, trace = reference(tag)
    common = dict(metric=tcfg.metric, capacity=tcfg.wait_capacity,
                  patience=tcfg.wait_patience, max_retries=2, backoff_base=2)
    tspec = tcfg.spec()
    got = treplay.faulted_host_decisions(events, meta, policy, tcfg.num_gpus,
                                         spec=tspec, **common)
    want = jreplay.faulted_host_decisions(
        events, meta, policy, tcfg.num_gpus,
        spec=None if fleet is None else jmig.ClusterSpec.parse(fleet), **common)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got.evicted.sum() > 0 and (got.wadm_eidx >= 0).sum() > 0

    engine, _ = port_run(policy, tcfg, tmig.FaultModel(**FM), True)
    for name in ("ok", "parked", "wadm_eidx", "evicted", "evict_lost", "evict_esum"):
        np.testing.assert_array_equal(getattr(engine, name), getattr(got, name), err_msg=name)
    ok = got.ok
    np.testing.assert_array_equal(engine.gpu[ok], got.gpu[ok])
    adm = got.wadm_eidx >= 0
    np.testing.assert_array_equal(engine.wadm_gpu[adm], got.wadm_gpu[adm])
    for e, r in np.argwhere(ok):
        model = tspec.model_of(int(engine.gpu[e, r]))
        assert model.profiles[int(events.pid[e, r])].anchors[int(engine.aidx[e, r])] \
            == got.anchor[e, r]
