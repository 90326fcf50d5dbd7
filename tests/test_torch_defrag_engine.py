"""Whole mfi-defrag runs of the port against the reference package's plain
lowering (tolerance 0): every trace field of every event, the ``mig*``
fields included, on homogeneous and mixed fleets, through the port's
kernel dispatch (on CPU tensors the wrappers compute their plain
versions) and its plain lowering, and a replica state carried across from
the reference mid-stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.sim import batched as jb
from repro.sim import simulator as jsim

from repro_torch.core import mig as tmig
from repro_torch.core.policy import PolicySpec
from repro_torch.sim import batched as tb
from repro_torch.sim import simulator as tsim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps torch's idle worker threads
    from competing with the other test processes for the CPU when files
    run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MIXED = "a100-80:3,a100-40:3"
H200_MIX = "a100-80:2,h200-141:2,a100-40:1"
STATE_FIELDS = ("base", "free", "f", "rr", "ring_gpu", "ring_mask", "ring_pid", "ring_aidx")


def twin_configs(fleet=None, **kw):
    if fleet is None:
        return tsim.SimConfig(**kw), jsim.SimConfig(**kw)
    return (tsim.SimConfig(cluster_spec=tmig.ClusterSpec.parse(fleet), **kw),
            jsim.SimConfig(cluster_spec=jmig.ClusterSpec.parse(fleet), **kw))


def reference_run(jcfg, runs, policy="mfi-defrag"):
    jev, _, rows, cols = jb.presample_arrivals(jcfg, runs)
    spec = jcfg.spec()
    common = dict(metric=jcfg.metric, num_gpus=jcfg.num_gpus, use_kernel=False,
                  midx=jnp.asarray(spec.model_index), tables=jb.spec_tables(spec),
                  ring_rows=rows, ring_cols=cols)
    final, trace = jax.device_get(jb._simulate(jax.tree.map(jnp.asarray, jev),
                                               policy=policy, **common))
    return jev, (rows, cols), common, final, trace


def port_run(policy, cfg, runs, use_kernel, rows, events=None, state=None):
    if events is None:
        events = tb.presample_arrivals(cfg, runs)[0]
    spec = cfg.spec()
    final, trace = tb._simulate(
        events, policy=policy, metric=cfg.metric, num_gpus=cfg.num_gpus,
        ring_rows=rows[0], ring_cols=rows[1], use_kernel=use_kernel, kernel_spec=spec,
        midx=torch.as_tensor(spec.model_index), tables=tb.spec_tables(spec, "cpu"),
        state=state, device="cpu",
    )
    return tb.trace_to_numpy(trace), final


def assert_traces_equal(got, want):
    for name in tb.EventTrace._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            w = np.asarray(w)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("fleet,kw", [
    (None, dict(num_gpus=4, offered_load=1.1, seed=3)),
    (MIXED, dict(offered_load=1.0, seed=3)),
    (H200_MIX, dict(offered_load=1.0, seed=3)),
], ids=["homog", "mixed", "h200"])
def test_defrag_traces_equal_reference(fleet, kw, use_kernel):
    tcfg, jcfg = twin_configs(fleet, **kw)
    _, rows, _, _, want = reference_run(jcfg, 2)
    assert np.asarray(want.mig).sum() > 0  # migrations happened
    got, _ = port_run("mfi-defrag", tcfg, 2, use_kernel, rows)
    assert_traces_equal(got, want)


def test_delta_only_defrag_spec_keeps_the_plain_search():
    """A ``kernel_lowering="delta"`` defrag spec gets the ΔF kernel and the
    plain migrate search (one ΔF launch per class), and decides exactly
    like mfi-defrag."""
    spec = PolicySpec(name="mfi-defrag-delta", keys=("frag-delta", "gpu", "anchor"),
                      defrag=True, kernel_lowering="delta")
    core = tb._build_core(policy=spec, metric="blocked", num_gpus=4, use_kernel=True,
                          runs=2, device="cpu")
    assert core.delta_fn is not None and core.select_fn is None and core.migrate_fn is None
    fused = tb._build_core(policy="mfi-defrag", metric="blocked", num_gpus=4,
                           use_kernel=True, runs=2, device="cpu")
    assert fused.select_fn is not None and fused.migrate_fn is not None
    tcfg, jcfg = twin_configs(num_gpus=4, offered_load=1.1, seed=3)
    _, rows, _, _, want = reference_run(jcfg, 2)
    got, _ = port_run(spec, tcfg, 2, True, rows)
    assert_traces_equal(got, want)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
def test_state_carried_from_reference_continues_identically(use_kernel):
    """The reference scans the first half of the stream; the port continues
    from the converted carry — ``ring_pid``/``ring_aidx`` included — and
    reproduces the reference's second half and final state."""
    tcfg, jcfg = twin_configs(num_gpus=5, offered_load=1.2, seed=41)
    runs = 3
    jev, rows, common, j_final, want = reference_run(jcfg, runs)
    half = jev.pid.shape[0] // 2
    assert np.asarray(want.mig)[half:].sum() > 0  # the second half migrates
    carry = jb.init_carry(runs, policy="mfi-defrag", **common)
    first = jb.EventStream(*[None if a is None else a[:half] for a in jev])
    scan_kw = {k: v for k, v in common.items() if k not in ("ring_rows", "ring_cols")}
    carry, _ = jb._scan_chunk(carry, jax.tree.map(jnp.asarray, first),
                              policy="mfi-defrag", **scan_kw)
    carried = jax.device_get(carry)._asdict()
    assert carried["ring_pid"] is not None
    state = tb.state_from_numpy(carried, "cpu")
    tev = tb.presample_arrivals(tcfg, runs)[0]
    second = tb.EventStream(*[None if a is None else a[half:] for a in tev])
    got, final = port_run("mfi-defrag", tcfg, runs, use_kernel, rows, events=second,
                          state=state)
    assert_traces_equal(got, type(want)(*[None if a is None else np.asarray(a)[half:]
                                          for a in want]))
    back = tb.state_to_numpy(final)
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(j_final, name)),
                                      err_msg=name)


def test_defrag_needs_the_allocation_planes():
    cfg = tsim.SimConfig(num_gpus=3, offered_load=1.0, seed=1)
    events, _, rows, cols = tb.presample_arrivals(cfg, 2)
    spec = cfg.spec()
    state, _ = tb._simulate(events, policy="mfi", metric="blocked", num_gpus=3,
                            ring_rows=rows, ring_cols=cols, use_kernel=False,
                            device="cpu")
    assert state.ring_pid is None
    with pytest.raises(ValueError, match="ring_pid"):
        tb._simulate(events, policy="mfi-defrag", metric="blocked", num_gpus=3,
                     ring_rows=rows, ring_cols=cols, use_kernel=False,
                     tables=tb.spec_tables(spec, "cpu"),
                     midx=torch.as_tensor(spec.model_index), state=state, device="cpu")
