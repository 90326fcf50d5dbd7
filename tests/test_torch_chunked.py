"""The port's chunked streaming driver and stream checkpoints against the
reference package (tolerance 0).

``simulate_chunked`` must give the monolithic run's trace for any chunk
size: every pinned golden hash (steady, queued, faulted) reproduces through
it at chunk size 1, a divisor of the stream length and a ragged size; the
cumulative protocol and mfi-defrag equal their monolithic runs; a run
resumed from a checkpoint, the port's or the reference's, rejoins the
stream exactly, also after the writing process was killed; and the
checkpoint files keep the reference's integrity guarantees.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import mig as jmig
from repro.sim import batched as jb
from repro.sim import simulator as jsim

from repro_torch import api as tapi
from repro_torch.checkpoint import ckpt
from repro_torch.core import mig as tmig
from repro_torch.sim import batched as tb
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
FM = dict(mtbf=60.0, mttr=10.0)

#: the reference's pinned hashes (tests/test_engine_core.py,
#: tests/test_faults.py): (protocol, tag) -> (policy, SimConfig keywords,
#: fleet, hash fields, hash)
STEADY_FIELDS = ("ok", "gpu", "aidx", "free_sum", "active", "frag")
QUEUED_FIELDS = ("ok", "gpu", "aidx", "parked", "wadm_eidx", "wadm_gpu", "wadm_aidx",
                 "free_sum", "active", "frag")
FAULTED_FIELDS = QUEUED_FIELDS[:7] + ("evicted", "evict_lost", "evict_esum") + STEADY_FIELDS[3:]
GOLDEN = {
    ("steady", "homog"): ("mfi", dict(num_gpus=5, offered_load=1.1, seed=7), None,
                          STEADY_FIELDS,
                          "3f61871a2075ffe549c554a6820d3bccc437d8606c80dd6e471e9daa0ad00705"),
    ("steady", "mixed"): ("mfi", dict(offered_load=1.0, seed=9), MIXED, STEADY_FIELDS,
                          "fc5a944c82ab6c74ca8a49b6a1ca19981d1d3fe8953f9b35cce26e67a8678d62"),
    ("steady-queued", "homog"): (
        "mfi", dict(num_gpus=5, offered_load=1.2, seed=7), None, QUEUED_FIELDS,
        "e3d1a83fced05aaa968ff95c2d9e3ed5d71839e2e12d4c6634e0389f80918925"),
    ("steady-queued", "mixed"): (
        "mfi-queued", dict(offered_load=1.1, seed=9), MIXED, QUEUED_FIELDS,
        "e368416188f84d500dbb7115410d3a24152fa06eac0dce525001032273a9f32f"),
    ("steady-faulted", "homog"): (
        "mfi", dict(num_gpus=5, offered_load=1.2, seed=7), None, FAULTED_FIELDS,
        "abb15f38d863b0c6ce819b7bb452235f163bf35e876e944c1df4c51e4deaad97"),
    ("steady-faulted", "mixed"): (
        "mfi-queued", dict(offered_load=1.1, seed=9), MIXED, FAULTED_FIELDS,
        "1bf958443af4abdbe75e50c4ac1e026875e84b3bbddd2658800f8b7f9079f7fe"),
}


def config(fleet=None, **kw):
    if fleet is None:
        return tsim.SimConfig(**kw)
    return tsim.SimConfig(cluster_spec=tmig.ClusterSpec.parse(fleet), **kw)


def stream(cfg, protocol, runs=RUNS):
    """The presampled stream of ``protocol`` and the engine's keywords."""
    fm = tmig.FaultModel(**FM) if protocol == "steady-faulted" else None
    if protocol == "cumulative":
        events, meta, rows, cols = tb.presample_cumulative(cfg, runs)
    else:
        events, meta, rows, cols = tb.presample_arrivals(
            cfg, runs, queued=protocol != "steady" and protocol != "cumulative",
            fault_model=fm)
    spec = cfg.spec()
    statics = dict(metric=cfg.metric, num_gpus=cfg.num_gpus, protocol=protocol,
                   kernel_spec=spec, midx=torch.as_tensor(spec.model_index),
                   tables=tb.spec_tables(spec, "cpu"), device="cpu")
    if protocol in ("steady-queued", "steady-faulted"):
        statics.update(wait_slots=cfg.wait_capacity, wait_patience=cfg.wait_patience)
    return events, meta, (rows, cols), statics


def monolithic(policy, events, rows, statics, use_kernel=False):
    state, trace = tb._simulate(events, policy=policy, ring_rows=rows[0], ring_cols=rows[1],
                                use_kernel=use_kernel, **statics)
    return state, tb.trace_to_numpy(trace)


def chunked(policy, events, rows, statics, chunk_size, use_kernel=False, **kw):
    return tb.simulate_chunked(events, chunk_size=chunk_size, policy=policy,
                               ring_rows=rows[0], ring_cols=rows[1],
                               use_kernel=use_kernel, **statics, **kw)


def trace_hash(trace, fields):
    h = hashlib.sha256()
    for name in fields:
        h.update(np.ascontiguousarray(getattr(trace, name)).tobytes())
    return h.hexdigest()


def chunk_size_of(kind, e_max):
    """1, a divisor of the stream length, or a non-divisor (a ragged last
    chunk), chosen as the reference's chunked tests choose them."""
    if kind == "one":
        return 1
    if kind == "divisor":
        return next((d for d in range(2, e_max) if e_max % d == 0), e_max)
    return next(c for c in range(max(2, e_max // 3), e_max) if e_max % c)


def assert_traces_equal(a, b):
    for name in tb.EventTrace._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def assert_states_equal(a, b):
    da, db = tb.state_to_numpy(a), tb.state_to_numpy(b)
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


# ---------------------------------------------------------------------------
# Golden hashes through the chunked driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["one", "divisor", "ragged"])
@pytest.mark.parametrize("protocol,tag", sorted(GOLDEN))
def test_golden_hashes_at_every_chunk_size(protocol, tag, kind):
    policy, kw, fleet, fields, want = GOLDEN[(protocol, tag)]
    events, _, rows, statics = stream(config(fleet, **kw), protocol)
    e_max = events.pid.shape[0]
    size = chunk_size_of(kind, e_max)
    stats = {}
    _, trace = chunked(policy, events, rows, statics, size, use_kernel=kind == "ragged",
                       stats=stats)
    assert isinstance(trace.ok, np.ndarray)
    assert trace_hash(trace, fields) == want, f"chunk_size={size}"
    assert stats["chunks"] == -(-e_max // size) and stats["events"] == e_max
    # every chunk's bytes but the first chunk's are staged behind another
    assert stats["h2d_overlap_frac"] == pytest.approx((e_max - size) / e_max)


@pytest.mark.parametrize("policy,protocol,size", [
    ("mfi", "cumulative", 17), ("mfi-defrag", "steady", 11), ("mfi-defrag", "cumulative", 9)])
def test_chunked_equals_monolithic(policy, protocol, size):
    """Trace and final carry equal the monolithic run's, through the kernel
    wrappers' plain versions; ``stream=False`` keeps the same trace on the
    device (cumulative mfi)."""
    cfg = tsim.SimConfig(num_gpus=4 if protocol == "cumulative" else 5, offered_load=1.1,
                         seed=3 if protocol == "cumulative" else 7)
    events, _, rows, statics = stream(cfg, protocol, runs=2)
    state, mono = monolithic(policy, events, rows, statics, use_kernel=True)
    c_state, trace = chunked(policy, events, rows, statics, size, use_kernel=True)
    assert_traces_equal(trace, mono)
    assert_states_equal(c_state, state)
    if policy == "mfi":
        _, resident = chunked(policy, events, rows, statics, size, use_kernel=True,
                              stream=False)
        assert isinstance(resident.ok, torch.Tensor)
        assert_traces_equal(tb.trace_to_numpy(resident), mono)
    if protocol == "steady":
        assert mono.mig.any()


def test_run_batched_and_api_chunked_equal_monolithic():
    """``run_batched`` and ``api.simulate`` take ``chunk_size``/``stream``
    and return the monolithic dict; the knobs without a chunk size, a
    non-positive chunk size and ``shard=True`` with one visible device
    raise."""
    cfg = tsim.SimConfig(num_gpus=5, offered_load=1.2, seed=7, protocol="steady-faulted",
                         fault_model=tmig.FaultModel(**FM))
    want = tb.run_batched("mfi", cfg, runs=2, device="cpu")
    stats = {}
    got = tb.run_batched("mfi", cfg, runs=2, device="cpu", chunk_size=23, stats=stats)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], v) for k, v in want.items())
    assert stats["chunks"] > 1 and 0 < stats["h2d_overlap_frac"] < 1
    via_api = tapi.simulate("mfi", cfg, engine="batched", runs=2, device="cpu",
                            chunk_size=40, stream=False)
    assert all(np.array_equal(via_api[k], v) for k, v in want.items())
    with pytest.raises(ValueError, match="chunk_size"):
        tb.run_batched("mfi", cfg, runs=2, device="cpu", stream=True)
    with pytest.raises(ValueError, match="chunk_size"):
        tb.run_batched("mfi", cfg, runs=2, device="cpu", stats={})
    with pytest.raises(ValueError, match="chunk_size"):
        tb.run_batched("mfi", cfg, runs=2, device="cpu", chunk_size=0)
    with pytest.raises(ValueError, match="only one device is visible"):
        tb.run_batched("mfi", cfg, runs=2, device="cpu", chunk_size=8, shard=True)


def test_chunked_refusals():
    """The reference's errors: a chunk size <= 0, ``start`` outside the
    stream, a carry of another ring geometry; and ``shard=True`` with one
    visible device."""
    cfg = tsim.SimConfig(num_gpus=3, offered_load=1.0, seed=1)
    events, _, rows, statics = stream(cfg, "steady", runs=2)
    e_max = events.pid.shape[0]
    with pytest.raises(ValueError, match="chunk_size"):
        chunked("mfi", events, rows, statics, 0)
    for start in (-1, e_max):
        with pytest.raises(ValueError, match="start"):
            chunked("mfi", events, rows, statics, 8, start=start)
    bad = tb.init_carry(2, policy="mfi", ring_rows=rows[0] + 1, ring_cols=rows[1], **statics)
    with pytest.raises(ValueError, match="ring geometry"):
        chunked("mfi", events, rows, statics, 8, carry=bad)
    with pytest.raises(ValueError, match="only one device is visible"):
        chunked("mfi", events, rows, statics, 8, shard=True)


# ---------------------------------------------------------------------------
# Checkpoint and resume
# ---------------------------------------------------------------------------


def spliced_hash(protocol, tag, done, tail):
    """The golden hash of the monolithic head ``[:done]`` spliced onto a
    resumed run's ``tail``."""
    policy, kw, fleet, fields, want = GOLDEN[(protocol, tag)]
    events, _, rows, statics = stream(config(fleet, **kw), protocol)
    _, mono = monolithic(policy, events, rows, statics)
    head = tb.EventTrace(*[None if a is None else a[:done] for a in mono])
    return trace_hash(tb._concat_traces([head, tail], np.concatenate), fields), want


@pytest.mark.parametrize("protocol", ["steady-queued", "steady-faulted"])
def test_resume_from_port_checkpoint(protocol, tmp_path):
    """Checkpoint every 3 chunks of 13 events, restore the last one into a
    fresh template, resume the tail (with the kernel dispatch, whose
    occupancy the resume rebuilds from the ring) and splice it onto the
    monolithic head: the pinned hash comes out unchanged."""
    policy, kw, fleet, _, _ = GOLDEN[(protocol, "homog")]
    events, _, rows, statics = stream(config(fleet, **kw), protocol)
    e_max = events.pid.shape[0]
    path = tmp_path / "carry"
    chunked(policy, events, rows, statics, 13, checkpoint_path=path, checkpoint_every=3)
    side = json.loads((tmp_path / "carry.json").read_text())
    assert side["kind"] == "replica-carry" and side["step"] % 39 == 0
    template = tb.init_carry(RUNS, policy=policy, ring_rows=rows[0], ring_cols=rows[1],
                             **statics)
    state, done = tb.load_stream_checkpoint(path, template)
    assert 0 < done < e_max
    _, tail = chunked(policy, events, rows, statics, 13, use_kernel=True, carry=state,
                      start=done)
    got, want = spliced_hash(protocol, "homog", done, tail)
    assert got == want
    with pytest.raises(ValueError, match="mismatch"):
        other = dict(statics, protocol="steady")
        other.pop("wait_slots"), other.pop("wait_patience")
        tb.load_stream_checkpoint(path, tb.init_carry(RUNS, policy=policy, ring_rows=rows[0],
                                                      ring_cols=rows[1], **other))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A faulted carry the reference checkpointed mid-stream resumes in the
    port and reproduces the reference's golden hash; the port's checkpoint
    of the same point restores into the reference's template with the
    reference's carry, key for key (``.base``-style names, no key for an
    absent field)."""
    policy, kw, _, _, _ = GOLDEN[("steady-faulted", "homog")]
    jcfg = jsim.SimConfig(**kw)
    jfm = jmig.FaultModel(**FM)
    jev, _, rows, cols = jb.presample_arrivals(jcfg, RUNS, queued=True, fault_model=jfm)
    jstat = dict(policy=policy, metric=jcfg.metric, num_gpus=jcfg.num_gpus, use_kernel=False,
                 protocol=jb.resolve_protocol("steady-faulted"),
                 wait_slots=jcfg.wait_capacity, wait_patience=jcfg.wait_patience)
    done = jev.pid.shape[0] // 2
    head = jb.EventStream(*[None if a is None else a[:done] for a in jev])
    jcarry, _ = jax.device_get(jb._simulate(
        jax.tree.map(lambda a: jnp.asarray(a) if a is not None else None, head),
        ring_rows=rows, ring_cols=cols, **jstat))
    jb.save_stream_checkpoint(tmp_path / "ref", jcarry, done)

    events, _, trows, statics = stream(tsim.SimConfig(**kw), "steady-faulted")
    template = tb.init_carry(RUNS, policy=policy, ring_rows=rows, ring_cols=cols, **statics)
    state, step = tb.load_stream_checkpoint(tmp_path / "ref", template)
    assert step == done and state.up.dtype == torch.bool and not bool(state.up.all())
    _, tail = chunked(policy, events, trows, statics, 29, carry=state, start=done)
    got, want = spliced_hash("steady-faulted", "homog", done, tail)
    assert got == want

    t_state, _ = tb._simulate(tb.EventStream(*[None if a is None else a[:done] for a in events]),
                              policy=policy, ring_rows=rows, ring_cols=cols, use_kernel=False,
                              **statics)
    tb.save_stream_checkpoint(tmp_path / "port", t_state, done)
    jtemplate = jb.init_carry(RUNS, ring_rows=rows, ring_cols=cols, **jstat)
    restored, jstep = jb.load_stream_checkpoint(tmp_path / "port", jtemplate)
    assert jstep == done
    for key, value in jckpt._flatten(jax.device_get(restored)).items():
        np.testing.assert_array_equal(value, jckpt._flatten(jcarry)[key], err_msg=key)
    assert sorted(np.load(tmp_path / "port.npz").files) == sorted(
        np.load(tmp_path / "ref.npz").files)


class TestCheckpointIntegrity:
    """The reference's four integrity cases (tests/test_faults.py) on the
    port's ``ckpt``, over a dict of a tensor and an array."""

    def _tree(self):
        return {"a": torch.arange(12, dtype=torch.int32).reshape(3, 4),
                "b": np.linspace(0.0, 1.0, 5, dtype=np.float32)}

    def test_sidecar_records_payload_digest(self, tmp_path):
        tree = self._tree()
        ckpt.save_checkpoint(tmp_path / "c", tree, step=3)
        side = json.loads((tmp_path / "c.json").read_text())
        digest = hashlib.sha256((tmp_path / "c.npz").read_bytes()).hexdigest()
        assert side["sha256"] == digest
        restored, step = ckpt.load_checkpoint(tmp_path / "c", tree)
        assert step == 3
        assert torch.equal(restored["a"], tree["a"])
        np.testing.assert_array_equal(restored["b"], tree["b"])

    def test_corrupted_payload_is_rejected(self, tmp_path):
        tree = self._tree()
        ckpt.save_checkpoint(tmp_path / "c", tree, step=1)
        payload = tmp_path / "c.npz"
        raw = bytearray(payload.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        payload.write_bytes(bytes(raw))
        with pytest.raises(ValueError, match="mismatch"):
            ckpt.load_checkpoint(tmp_path / "c", tree)

    def test_missing_sidecar_means_interrupted_save(self, tmp_path):
        tree = self._tree()
        ckpt.save_checkpoint(tmp_path / "c", tree, step=1)
        (tmp_path / "c.json").unlink()
        with pytest.raises(FileNotFoundError, match="sidecar"):
            ckpt.load_checkpoint(tmp_path / "c", tree)

    def test_no_partial_payload_left_behind(self, tmp_path):
        ckpt.save_checkpoint(tmp_path / "c", self._tree(), step=1)
        names = sorted(p.name for p in tmp_path.iterdir())
        assert names == ["c.json", "c.npz"]


def test_sigkilled_run_resumes_from_last_checkpoint(tmp_path):
    """SIGKILL a chunked faulted run on the CPU right after its second
    checkpoint lands; resuming from the surviving checkpoint reproduces the
    pinned faulted hash."""
    path = tmp_path / "carry"
    code = textwrap.dedent(
        f"""
        import os, signal, sys
        sys.path.insert(0, "src")
        import torch
        torch.set_num_threads(1)
        from repro_torch.core.mig import FaultModel
        from repro_torch.sim import batched
        from repro_torch.sim.simulator import SimConfig

        cfg = SimConfig(num_gpus=5, offered_load=1.2, seed=7)
        events, _, rr, rc = batched.presample_arrivals(
            cfg, {RUNS}, queued=True, fault_model=FaultModel(**{FM!r}))
        orig = batched.save_stream_checkpoint
        calls = [0]
        def killing_save(path, state, events_done, metadata=None):
            orig(path, state, events_done, metadata=metadata)
            calls[0] += 1
            if calls[0] == 2:
                os.kill(os.getpid(), signal.SIGKILL)
        batched.save_stream_checkpoint = killing_save
        batched.simulate_chunked(
            events, chunk_size=13, policy="mfi", metric=cfg.metric, num_gpus=5,
            ring_rows=rr, ring_cols=rc, protocol="steady-faulted",
            wait_slots=cfg.wait_capacity, wait_patience=cfg.wait_patience,
            checkpoint_path={str(path)!r}, checkpoint_every=1, device="cpu")
        print("UNREACHABLE")
        """
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=repo)
    assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
    assert "UNREACHABLE" not in r.stdout

    policy, kw, fleet, _, _ = GOLDEN[("steady-faulted", "homog")]
    events, _, rows, statics = stream(config(fleet, **kw), "steady-faulted")
    template = tb.init_carry(RUNS, policy=policy, ring_rows=rows[0], ring_cols=rows[1],
                             **statics)
    state, done = tb.load_stream_checkpoint(path, template)
    assert done == 26  # the second checkpoint: two chunks of 13 events
    _, tail = chunked(policy, events, rows, statics, 13, carry=state, start=done)
    got, want = spliced_hash("steady-faulted", "homog", done, tail)
    assert got == want
