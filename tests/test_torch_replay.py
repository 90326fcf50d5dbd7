"""The port's host replays (``repro_torch.sim.replay``) against the
reference package's on the same streams and traces (tolerance 0), and
against the port's own batched engine: ``replay``, ``drain_all``,
``host_decisions`` / ``host_decisions_full`` and ``queued_host_decisions``.

The streams and traces are the port's (numpy, engine on the CPU, kernel
wrappers' plain versions); the reference's replay functions read the same
arrays, so no JAX program is compiled here.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.sim import replay as jreplay

from repro_torch.core import mig as tmig
from repro_torch.sim import batched as tb
from repro_torch.sim import replay as treplay
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

#: (policy, SimConfig keywords, fleet, runs, host scheduler keywords): the
#: reference's configurations (tests/test_engine_core.py) of the steady,
#: defrag and cumulative replays, and the two pinned queued streams
CASES = {
    "steady-homog": ("mfi", dict(num_gpus=5, offered_load=1.1, seed=7), None, 3, {}),
    "steady-mixed": ("mfi", dict(offered_load=1.0, seed=9), MIXED, 3, {}),
    "defrag": ("mfi-defrag", dict(num_gpus=4, offered_load=1.1, seed=3), None, 2,
               dict(max_candidates=None)),
    "cumulative-mixed": ("mfi", dict(seed=2, protocol="cumulative"), MIXED, 2, {}),
    "queued-homog": ("mfi", dict(num_gpus=5, offered_load=1.2, seed=7,
                                 protocol="steady-queued"), None, 3, {}),
    "queued-mixed": ("mfi-queued", dict(offered_load=1.1, seed=9,
                                        protocol="steady-queued"), MIXED, 3, {}),
}
QUEUED = sorted(k for k in CASES if k.startswith("queued"))


@functools.lru_cache(maxsize=None)
def engine_run(case):
    """The port's stream, meta, engine trace (numpy) and both packages'
    cluster specs for ``case``."""
    policy, kw, fleet, runs, _ = CASES[case]
    spec = tmig.ClusterSpec.parse(fleet) if fleet else None
    cfg = tsim.SimConfig(cluster_spec=spec, **kw) if spec else tsim.SimConfig(**kw)
    spec = cfg.spec()
    proto = tb.resolve_protocol(cfg.protocol)
    if proto.name == "cumulative":
        events, meta, rows, cols = tb.presample_cumulative(cfg, runs)
    else:
        events, meta, rows, cols = tb.presample_arrivals(cfg, runs, queued=proto.queued)
    _, trace = tb._simulate(
        events, policy=policy, metric=cfg.metric, num_gpus=cfg.num_gpus,
        ring_rows=rows, ring_cols=cols, use_kernel=True, kernel_spec=spec,
        protocol=proto, wait_slots=cfg.wait_capacity if proto.queued else 0,
        wait_patience=cfg.wait_patience, midx=torch.as_tensor(spec.model_index),
        tables=tb.spec_tables(spec, "cpu"), device="cpu",
    )
    jspec = jmig.ClusterSpec.parse(fleet) if fleet else None
    return cfg, events, meta, tb.trace_to_numpy(trace), (spec if fleet else None), jspec


def anchors_of(spec, pid, gpu, aidx):
    """Anchor values of the accepted decisions of a trace (``-1`` elsewhere)."""
    out = np.full(pid.shape, -1, np.int32)
    for e, r in zip(*np.nonzero(gpu >= 0)):
        out[e, r] = spec.model_of(int(gpu[e, r])).profiles[int(pid[e, r])].anchors[
            int(aidx[e, r])]
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_and_drain_equal_reference(case):
    """The final occupancy of the replay walk and the drained occupancy
    (all zero: every release restores its exact window) equal the
    reference's on the same stream and trace."""
    cfg, events, meta, trace, spec, jspec = engine_run(case)
    got = treplay.replay(events, meta, trace, cfg.num_gpus, spec=spec)
    want = jreplay.replay(events, meta, trace, cfg.num_gpus, spec=jspec)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    final, drained = treplay.drain_all(events, meta, trace, cfg.num_gpus, spec=spec)
    j_final, j_drained = jreplay.drain_all(events, meta, trace, cfg.num_gpus, spec=jspec)
    assert np.array_equal(final, j_final) and np.array_equal(drained, j_drained)
    assert final.any() and not drained.any()


@pytest.mark.parametrize("case", sorted(k for k in CASES if k not in QUEUED))
def test_host_decisions_equal_reference_and_engine(case):
    """The port's host schedulers over the engine's stream decide as the
    reference's do, field for field, and as the port's engine did."""
    cfg, events, meta, trace, spec, jspec = engine_run(case)
    policy, _, _, _, kwargs = CASES[case]
    got = treplay.host_decisions_full(events, meta, policy, cfg.num_gpus,
                                      metric=cfg.metric, spec=spec, **kwargs)
    want = jreplay.host_decisions_full(events, meta, policy, cfg.num_gpus,
                                       metric=cfg.metric, spec=jspec, **kwargs)
    assert got._fields == want._fields
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    short = treplay.host_decisions(events, meta, policy, cfg.num_gpus, metric=cfg.metric,
                                   spec=spec, **kwargs)
    assert all(np.array_equal(a, b) for a, b in zip(short, (got.ok, got.gpu, got.anchor)))

    ok = trace.ok
    assert np.array_equal(ok, got.ok)
    assert np.array_equal(trace.gpu[ok], got.gpu[ok])
    gpu = np.where(ok, trace.gpu, -1)
    assert np.array_equal(anchors_of(cfg.spec(), events.pid, gpu, trace.aidx), got.anchor)
    if trace.mig is not None:
        m = trace.mig
        assert m.sum() > 0 and np.array_equal(m, got.mig)
        for name in ("mig_from_gpu", "mig_from_anchor", "mig_to_gpu", "mig_to_anchor"):
            assert np.array_equal(getattr(trace, name), getattr(got, name)), name


@pytest.mark.parametrize("case", QUEUED)
def test_queued_host_decisions_equal_reference_and_engine(case):
    """The queued host reference of the port equals the reference's field
    for field, and the port's engine trace: every in-place decision, park
    and wait admission (origin and placement)."""
    cfg, events, meta, trace, spec, jspec = engine_run(case)
    policy = CASES[case][0]
    kw = dict(metric=cfg.metric, capacity=cfg.wait_capacity, patience=cfg.wait_patience)
    got = treplay.queued_host_decisions(events, meta, policy, cfg.num_gpus, spec=spec, **kw)
    want = jreplay.queued_host_decisions(events, meta, policy, cfg.num_gpus, spec=jspec,
                                         **kw)
    assert got._fields == want._fields
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name

    ok = trace.ok
    assert np.array_equal(ok, got.ok) and np.array_equal(trace.parked, got.parked)
    assert np.array_equal(trace.gpu[ok], got.gpu[ok])
    assert np.array_equal(trace.wadm_eidx, got.wadm_eidx)
    adm = got.wadm_eidx >= 0
    assert adm.sum() > 0
    assert np.array_equal(trace.wadm_gpu, got.wadm_gpu)
    pid_w = np.where(adm, events.pid[np.maximum(got.wadm_eidx, 0),
                                     np.arange(ok.shape[1])[None, :]], 0)
    assert np.array_equal(anchors_of(cfg.spec(), pid_w, trace.wadm_gpu, trace.wadm_aidx),
                          got.wadm_anchor)
    with pytest.raises(ValueError, match="queued stream"):
        steady = tb.EventStream(*[None if name in ("prio", "tenant", "wlive", "slot", "end")
                                  else a for name, a in zip(tb.EventStream._fields, events)])
        treplay.queued_host_decisions(steady, meta, policy, cfg.num_gpus, spec=spec, **kw)
