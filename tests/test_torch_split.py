"""The port's replica split (``shard=``) against the unsplit port and the
reference package (tolerance 0).

The reference splits the replica axis over the visible devices
(``_replica_sharding``/``shard_events``); its own split run fails on jax
0.9.0 (ROADMAP.md §3), so the port's split is held to the unsplit port, to
the unsplit reference and to the reference's pinned results.  Here the
visible devices are ``_visible_devices`` patched to return the CPU D times
(the reference forces D host devices instead); each block of R/D
replicas then runs its own state on its own "device", and the traces join
along R before the aggregate.

The pinned trace hashes are of R = 3 runs, so they are reproduced by a
3-way split (one replica a block); the 2- and 4-way splits run at R = 4
(the pinned steady aggregates' R) and R = 8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.sim import batched as jb
from repro.sim import simulator as jsim

from repro_torch.core import mig as tmig
from repro_torch.sim import batched as tb
from repro_torch.sim import simulator as tsim

from test_torch_chunked import (
    FM,
    GOLDEN,
    RUNS,
    assert_traces_equal,
    chunked,
    config,
    monolithic,
    spliced_hash,
    stream,
    trace_hash,
)
from test_torch_engine import GOLDEN_AGGREGATES

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps torch's idle
    worker threads from competing with the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def devices(monkeypatch):
    """``devices(D)`` makes D CPU devices visible to the split."""
    def show(d):
        monkeypatch.setattr(tb, "_visible_devices", lambda dev: [CPU] * d)
    return show


#: the five configurations of the split: (policy, SimConfig keywords)
CASES = {
    "steady-mfi": ("mfi", dict(num_gpus=3, offered_load=1.2, seed=7)),
    "steady-mfi-defrag": ("mfi-defrag", dict(num_gpus=3, offered_load=1.2, seed=7)),
    "cumulative": ("mfi", dict(num_gpus=4, offered_load=1.1, seed=3, protocol="cumulative")),
    "steady-queued": ("mfi", dict(num_gpus=3, offered_load=1.2, seed=7,
                                  protocol="steady-queued")),
    "steady-faulted": ("mfi", dict(num_gpus=3, offered_load=1.2, seed=7,
                                   protocol="steady-faulted")),
}


def twin_configs(kw):
    fm = kw.get("protocol") == "steady-faulted"
    return (tsim.SimConfig(**kw, fault_model=tmig.FaultModel(**FM) if fm else None),
            jsim.SimConfig(**kw, fault_model=jmig.FaultModel(**FM) if fm else None))


def results_equal(got, want) -> bool:
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(results_equal(got[k], want[k]) for k in want)
    return np.array_equal(np.asarray(got), np.asarray(want))


@functools.lru_cache(maxsize=None)
def reference(case, runs):
    policy, kw = CASES[case]
    return jb.run_batched(policy, twin_configs(kw)[1], runs=runs, shard=False)


@functools.lru_cache(maxsize=None)
def unsplit(case, runs):
    policy, kw = CASES[case]
    return tb.run_batched(policy, twin_configs(kw)[0], runs=runs, device="cpu", shard=False)


# ---------------------------------------------------------------------------
# The reference's rules
# ---------------------------------------------------------------------------


def test_single_device_rules_and_messages(devices):
    """One visible device: no split, and ``shard=True`` raises the
    reference's message; D devices that do not divide R: no split, and
    ``shard=True`` raises the reference's message; ``shard=False`` never
    splits."""
    events, *_ = tb.presample_arrivals(tsim.SimConfig(num_gpus=2, seed=0), 4)
    assert tb._visible_devices(CPU) == [CPU]
    assert tb._replica_devices(4, None, "cpu") is None
    assert tb._replica_devices(4, False, "cpu") is None
    assert tb.shard_events(events, 4, None, "cpu") is events
    assert tb.shard_events(events, 4, False, "cpu") is events
    with pytest.raises(ValueError, match="^replica sharding requested but only one device "
                                         "is visible$"):
        tb.shard_events(events, 4, True, "cpu")
    devices(3)
    assert tb._replica_devices(4, None, "cpu") is None
    with pytest.raises(ValueError, match=r"^runs=4 does not divide across 3 devices$"):
        tb._replica_devices(4, True, "cpu")
    assert tb._replica_devices(6, None, "cpu") == [CPU] * 3
    assert tb._replica_devices(6, False, "cpu") is None


def test_auto_split_only_when_runs_divide(devices, monkeypatch):
    """``shard=None`` splits when R divides across the visible devices and
    runs unsplit otherwise; both give the unsplit results."""
    calls = []
    split = tb._simulate_split
    monkeypatch.setattr(tb, "_simulate_split", lambda *a, **k: calls.append(1) or split(*a, **k))
    devices(2)
    cfg = tsim.SimConfig(num_gpus=4, offered_load=1.0, seed=1)
    for runs, splits in ((4, True), (3, False)):
        calls.clear()
        got = tb.run_batched("mfi", cfg, runs=runs, device="cpu")
        assert bool(calls) == splits, runs
        want = tb.run_batched("mfi", cfg, runs=runs, device="cpu", shard=False)
        assert results_equal(got, want)


def test_shard_events_returns_an_already_split_stream_without_a_copy(devices):
    """The blocks are the stream's contiguous replica columns, each on its
    device; splitting a split stream again returns the same object and the
    same storage, and an unsplit stream of another split is re-split."""
    events, *_ = tb.presample_arrivals(tsim.SimConfig(num_gpus=4, offered_load=1.0, seed=0), 8,
                                       queued=True)
    devices(4)
    ev1 = tb.shard_events(events, 8, True, "cpu")
    assert isinstance(ev1, tb.ShardedStream) and ev1.devices == (CPU,) * 4
    for i, block in enumerate(ev1.shards):
        for name in tb.EventStream._fields:
            whole, part = getattr(events, name), getattr(block, name)
            assert (whole is None) == (part is None), name
            if part is not None:
                assert part.device == ev1.devices[i] and part.is_contiguous()
                np.testing.assert_array_equal(part.numpy(), whole[:, 2 * i:2 * i + 2])
    ev2 = tb.shard_events(ev1, 8, True)
    assert ev2 is ev1
    assert all(a.data_ptr() == b.data_ptr() for s1, s2 in zip(ev1.shards, ev2.shards)
               for a, b in zip(s1, s2) if a is not None)
    devices(2)
    ev3 = tb.shard_events(ev1, 8, True, "cpu")
    assert len(ev3.shards) == 2
    np.testing.assert_array_equal(ev3.shards[1].pid.numpy(), events.pid[:, 4:])


def test_each_block_steps_in_turn_on_its_own_device(devices, monkeypatch):
    """One loop over the events steps every block in turn, each under its
    own device scope, with its state, stream and tables on that device
    (here every device is the CPU; ``chip_smoke.py`` phase 17 runs the
    blocks on the card)."""
    devices(2)
    order = []
    step = tb.EngineCore.step

    def checked(core, state, x):
        dev = core.midx.device
        for t in list(state) + list(x) + list(core.tables):
            assert t is None or t.device == dev
        order.append(id(core))
        return step(core, state, x)

    monkeypatch.setattr(tb.EngineCore, "step", checked)
    scopes = []
    scope = tb._device_scope
    monkeypatch.setattr(tb, "_device_scope", lambda dev: scopes.append(dev) or scope(dev))
    cfg = tsim.SimConfig(num_gpus=3, offered_load=1.0, seed=2)
    events, *_ = tb.presample_arrivals(cfg, 4)
    tb.run_batched("mfi", cfg, runs=4, device="cpu", shard=True)
    e_max = events.pid.shape[0]
    first, second = order[0], order[1]
    assert first != second and order == [first, second] * e_max
    assert scopes == [CPU, CPU] * e_max


# ---------------------------------------------------------------------------
# Split runs against the unsplit port, the reference and its pinned results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("protocol,tag", sorted(GOLDEN))
def test_split_reproduces_the_pinned_trace_hashes(protocol, tag, devices):
    """Each pinned hash (R = 3) comes out of a 3-way split, one replica a
    block: monolithic, and on the homogeneous fleet also chunked (a ragged
    chunk size, through the kernel wrappers)."""
    policy, kw, fleet, fields, want = GOLDEN[(protocol, tag)]
    events, _, rows, statics = stream(config(fleet, **kw), protocol)
    devices(RUNS)
    placed = tb.shard_events(events, RUNS, True, "cpu")
    _, trace = tb._simulate_split(placed, policy=policy, ring_rows=rows[0], ring_cols=rows[1],
                                  use_kernel=False, **statics)
    assert trace_hash(trace, fields) == want
    if tag == "homog":
        _, trace = chunked(policy, events, rows, statics, 29, use_kernel=True, shard=True)
        assert trace_hash(trace, fields) == want


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_equals_unsplit_and_reference(case, d, devices):
    """``run_batched(shard=True)`` split 2 and 4 ways at R = 4 gives the
    unsplit port's and the unsplit reference's aggregates exactly (the
    cumulative protocol's grid traces too); steady mfi also the pinned
    aggregates of R = 4."""
    policy, kw = CASES[case]
    devices(d)
    got = tb.run_batched(policy, twin_configs(kw)[0], runs=4, device="cpu", shard=True)
    assert results_equal(got, unsplit(case, 4))
    assert results_equal(got, reference(case, 4))
    if case == "steady-mfi":
        kw, want = GOLDEN_AGGREGATES[("homog_m6", "mfi")]
        pinned = tb.run_batched("mfi", tsim.SimConfig(**kw), runs=4, device="cpu", shard=True)
        for key, value in want.items():
            assert pinned[key] == value, key


@pytest.mark.parametrize("case", ["steady-mfi-defrag", "steady-faulted"])
def test_split_trace_and_carry_equal_unsplit(case, devices):
    """Split 2 ways at R = 4 through the kernel wrappers: the joined trace
    and the gathered carry equal the unsplit run's, monolithic and chunked
    with the trace kept on the device (``stream=False``); the chunk stats
    sum over the blocks."""
    policy, kw = CASES[case]
    protocol = kw.get("protocol", "steady")
    events, _, rows, statics = stream(config(**{k: v for k, v in kw.items()
                                                if k != "protocol"}), protocol, runs=4)
    state, mono = monolithic(policy, events, rows, statics, use_kernel=True)
    devices(2)
    s_state, trace = tb._simulate_split(tb.shard_events(events, 4, True, "cpu"), policy=policy,
                                        ring_rows=rows[0], ring_cols=rows[1], use_kernel=True,
                                        **statics)
    assert_traces_equal(trace, mono)
    assert_states_equal(s_state, state)
    stats = {}
    c_state, resident = chunked(policy, events, rows, statics, 17, use_kernel=True,
                                shard=True, stream=False, stats=stats)
    assert isinstance(resident.ok, torch.Tensor)
    assert_traces_equal(tb.trace_to_numpy(resident), mono)
    assert_states_equal(c_state, state)
    e_max = events.pid.shape[0]
    assert stats["chunks"] == -(-e_max // 17)
    assert stats["h2d_overlap_frac"] == pytest.approx((e_max - 17) / e_max)


def assert_states_equal(a, b):
    da, db = tb.state_to_numpy(a), tb.state_to_numpy(b)
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


# ---------------------------------------------------------------------------
# Checkpoints across the split and across the packages
# ---------------------------------------------------------------------------


def test_split_checkpoint_resumes_unsplit_and_in_the_reference(devices, tmp_path):
    """A faulted run split 3 ways checkpoints its gathered carry every 3
    chunks of 13 events; the last checkpoint resumes unsplit in the port
    (the pinned hash, spliced onto the monolithic head) and restores into
    the reference's template equal, key for key, to the reference's own
    carry at that event."""
    protocol = "steady-faulted"
    policy, kw, fleet, _, _ = GOLDEN[(protocol, "homog")]
    events, _, rows, statics = stream(config(fleet, **kw), protocol)
    devices(RUNS)
    path = tmp_path / "carry"
    chunked(policy, events, rows, statics, 13, shard=True, checkpoint_path=path,
            checkpoint_every=3)
    template = tb.init_carry(RUNS, policy=policy, ring_rows=rows[0], ring_cols=rows[1],
                             **statics)
    state, done = tb.load_stream_checkpoint(path, template)
    assert 0 < done < events.pid.shape[0] and done % 39 == 0
    _, tail = chunked(policy, events, rows, statics, 13, carry=state, start=done, shard=False)
    got, want = spliced_hash(protocol, "homog", done, tail)
    assert got == want

    jcfg = jsim.SimConfig(**kw)
    jev, _, jrows, jcols = jb.presample_arrivals(jcfg, RUNS, queued=True,
                                                 fault_model=jmig.FaultModel(**FM))
    jstat = dict(policy=policy, metric=jcfg.metric, num_gpus=jcfg.num_gpus, use_kernel=False,
                 protocol=jb.resolve_protocol(protocol), wait_slots=jcfg.wait_capacity,
                 wait_patience=jcfg.wait_patience)
    head = jb.EventStream(*[None if a is None else jnp.asarray(a[:done]) for a in jev])
    jcarry, _ = jax.device_get(jb._simulate(head, ring_rows=jrows, ring_cols=jcols, **jstat))
    jtemplate = jb.init_carry(RUNS, ring_rows=jrows, ring_cols=jcols, **jstat)
    restored, jstep = jb.load_stream_checkpoint(path, jtemplate)
    assert jstep == done
    for name, want_leaf in jcarry._asdict().items():
        got_leaf = getattr(restored, name)
        assert (got_leaf is None) == (want_leaf is None), name
        if got_leaf is not None:
            np.testing.assert_array_equal(np.asarray(got_leaf), np.asarray(want_leaf),
                                          err_msg=name)


def test_unsplit_and_reference_checkpoints_resume_split(devices, tmp_path):
    """An unsplit carry, the port's and the reference's checkpoint of the
    same queued event, resumes split 3 ways and gives the pinned hash."""
    protocol = "steady-queued"
    policy, kw, fleet, _, _ = GOLDEN[(protocol, "homog")]
    events, _, rows, statics = stream(config(fleet, **kw), protocol)
    done = events.pid.shape[0] // 2
    head = tb.EventStream(*[None if a is None else a[:done] for a in events])
    t_state, _ = tb._simulate(head, policy=policy, ring_rows=rows[0], ring_cols=rows[1],
                              use_kernel=False, **statics)
    tb.save_stream_checkpoint(tmp_path / "port", t_state, done)

    jcfg = jsim.SimConfig(**kw)
    jev, _, jrows, jcols = jb.presample_arrivals(jcfg, RUNS, queued=True)
    jstat = dict(policy=policy, metric=jcfg.metric, num_gpus=jcfg.num_gpus, use_kernel=False,
                 protocol=jb.resolve_protocol(protocol), wait_slots=jcfg.wait_capacity,
                 wait_patience=jcfg.wait_patience)
    jhead = jb.EventStream(*[None if a is None else jnp.asarray(a[:done]) for a in jev])
    jcarry, _ = jax.device_get(jb._simulate(jhead, ring_rows=jrows, ring_cols=jcols, **jstat))
    jb.save_stream_checkpoint(tmp_path / "ref", jcarry, done)

    devices(RUNS)
    template = tb.init_carry(RUNS, policy=policy, ring_rows=rows[0], ring_cols=rows[1],
                             **statics)
    for name in ("port", "ref"):
        state, step = tb.load_stream_checkpoint(tmp_path / name, template)
        assert step == done
        _, tail = chunked(policy, events, rows, statics, 31, use_kernel=True, carry=state,
                          start=done, shard=True)
        got, want = spliced_hash(protocol, "homog", done, tail)
        assert got == want, name
