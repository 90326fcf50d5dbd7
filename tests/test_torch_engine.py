"""The port's engine against the reference package (tolerance 0): single
decisions, one staged step from a random state, the pinned golden results,
a replica state carried across from the reference mid-stream, and the
paper's full-width configuration (M = 100).
"""

import hashlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.sim import batched as jb
from repro.sim import simulator as jsim

from repro_torch.core import cluster as tcluster
from repro_torch.core import mig as tmig
from repro_torch.core.policy import PolicySpec, resolve
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


REPO = Path(__file__).resolve().parents[1]
POLICIES = ("mfi", "ff", "bf-bi", "wf-bi", "rr")
FOUR = "a100-80:2,a100-40:2,h100-96:2,h100-80:2"
MIXED = "a100-80:3,a100-40:3"

#: the reference's pinned results (tests/test_engine_core.py)
GOLDEN_TRACE_HASHES = {
    "homog": "3f61871a2075ffe549c554a6820d3bccc437d8606c80dd6e471e9daa0ad00705",
    "mixed": "fc5a944c82ab6c74ca8a49b6a1ca19981d1d3fe8953f9b35cce26e67a8678d62",
}
GOLDEN_AGGREGATES = {
    ("homog_m6", "mfi"): (dict(num_gpus=6, offered_load=0.9, seed=12), {
        "acceptance_rate": 0.835978120978121, "active_gpus": 5.0,
        "allocated_workloads": 37.25, "frag_severity": 7.736111243565877,
        "utilization": 0.6440972222222222}),
    ("mixed_k2", "rr"): (dict(fleet=MIXED, offered_load=0.9, seed=12), {
        "acceptance_rate": 0.705775877918735, "active_gpus": 5.583333333333333,
        "allocated_workloads": 31.25, "frag_severity": 8.333333651224772,
        "utilization": 0.6458333333333334}),
    ("four_k4", "bf-bi"): (dict(fleet=FOUR, offered_load=0.85, seed=3), {
        "acceptance_rate": 0.8497768071971659, "active_gpus": 7.1875,
        "allocated_workloads": 53.25, "frag_severity": 7.015625,
        "utilization": 0.68359375}),
}


def twin_configs(fleet=None, **kw):
    if fleet is None:
        return tsim.SimConfig(**kw), jsim.SimConfig(**kw)
    return (tsim.SimConfig(cluster_spec=tmig.ClusterSpec.parse(fleet), **kw),
            jsim.SimConfig(cluster_spec=jmig.ClusterSpec.parse(fleet), **kw))


def trace_hash(trace) -> str:
    """SHA-256 over the trace's fields that exist, in field order."""
    h = hashlib.sha256()
    for a in trace:
        if a is not None:
            h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def port_run(policy, cfg, runs, use_kernel, events=None, state=None, rows=None):
    """The port's trace (numpy) and final state over ``cfg``'s stream."""
    if events is None:
        events, _, rows_, cols = tb.presample_arrivals(cfg, runs)
        rows = (rows_, cols)
    spec = cfg.spec()
    final, trace = tb._simulate(
        events, policy=policy, metric=cfg.metric, num_gpus=cfg.num_gpus,
        ring_rows=rows[0], ring_cols=rows[1], use_kernel=use_kernel,
        kernel_spec=spec, midx=torch.as_tensor(spec.model_index),
        tables=tb.spec_tables(spec, "cpu"), state=state, device="cpu",
    )
    return tb.trace_to_numpy(trace), final


def jax_common(cfg, rows, cols):
    spec = cfg.spec()
    return dict(metric=cfg.metric, num_gpus=cfg.num_gpus, use_kernel=False,
                midx=jnp.asarray(spec.model_index), tables=jb.spec_tables(spec),
                ring_rows=rows, ring_cols=cols)


def assert_traces_equal(got, want):
    for name in tb.EventTrace._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is None:
            continue
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# Single decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fleet", [None, FOUR], ids=["homog", "four-model"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_select_equals_reference(policy, fleet):
    text = fleet or "a100-80:7"
    spec, jspec = tmig.ClusterSpec.parse(text), jmig.ClusterSpec.parse(text)
    rng = np.random.default_rng(len(policy) + len(text))
    for fill in (0.0, 0.5, 0.85):
        occ = np.zeros((spec.num_gpus, spec.num_mem_slices), np.int32)
        for g in range(spec.num_gpus):
            s = spec.model_of(g).num_mem_slices
            occ[g, :s] = rng.random(s) < fill
        for pid in range(tmig.NUM_PROFILES):
            cursor = int(rng.integers(0, spec.num_gpus))
            got = tb.policy_select(occ, pid, policy, spec=spec, cursor=cursor, device="cpu")
            want = jb.policy_select(jnp.asarray(occ), pid, policy, spec=jspec, cursor=cursor)
            assert tuple(int(x) for x in got) == tuple(int(x) for x in want), (fill, pid)


def test_policy_select_full_reports_no_migration():
    """A spec without defrag reports no migration; a defrag spec runs its
    search, which finds no candidate without running workloads."""
    empty = np.zeros((3, 8), np.int32)
    d = tb.policy_select_full(empty, 0, "mfi", device="cpu")
    assert (int(d.gpu), int(d.anchor), bool(d.ok), bool(d.mig)) == (0, 0, True, False)
    assert [int(x) for x in (d.vic_gpu, d.vic_anchor, d.new_gpu, d.new_anchor)] == [-1] * 4
    assert tuple(int(x) for x in tb.policy_select(empty, 0, "mfi-defrag", device="cpu")) == (
        0, 0, 1)
    full = tb.policy_select_full(np.ones((3, 8), np.int32), 0, "mfi-defrag", device="cpu")
    assert (bool(full.ok), bool(full.mig), int(full.gpu), int(full.vic_gpu)) == (
        False, False, -1, -1)


# ---------------------------------------------------------------------------
# One staged step from a random state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("policy,fleet", [("mfi", None), ("rr", MIXED), ("bf-bi", FOUR)],
                         ids=["mfi-homog", "rr-mixed", "bf-bi-four-model"])
def test_one_step_equals_reference(policy, fleet, use_kernel):
    """A reference carry after a random number of events, stepped once by
    both engines: the new state and the trace row agree."""
    kw = dict(offered_load=1.0, seed=31)
    tcfg, jcfg = twin_configs(fleet, **({} if fleet else {"num_gpus": 5}), **kw)
    runs = 3
    jev, _, rows, cols = jb.presample_arrivals(jcfg, runs)
    k = int(np.random.default_rng(len(policy)).integers(20, jev.pid.shape[0] - 1))
    head = jb.EventStream(*[None if a is None else a[:k] for a in jev])
    carry, _ = jb._simulate(jax.tree.map(jnp.asarray, head), policy=policy,
                            **jax_common(jcfg, rows, cols))
    core, _, _ = jb._build_core(policy=policy, metric=jcfg.metric,
                                num_gpus=jcfg.num_gpus, use_kernel=False,
                                midx=jnp.asarray(jcfg.spec().model_index),
                                tables=jb.spec_tables(jcfg.spec()))
    x = tuple(jnp.asarray(a[k]) for a in jb._scan_xs(jev, core.protocol))
    j_next, j_row = jax.device_get(jax.vmap(core.step)(carry, x))

    spec = tcfg.spec()
    state = tb.state_from_numpy(jax.device_get(carry)._asdict(), "cpu")
    t_core = tb._build_core(policy=policy, metric=tcfg.metric, num_gpus=tcfg.num_gpus,
                            use_kernel=use_kernel, runs=runs, device="cpu",
                            kernel_spec=spec, midx=torch.as_tensor(spec.model_index),
                            tables=tb.spec_tables(spec, "cpu"))
    if t_core.frag_fn is None:
        state = state._replace(occ=None)
    xs = [torch.as_tensor(np.ascontiguousarray(a[k]))
          for a in (jev.pid, jev.exp_row, jev.exp_col, jev.drain_row, jev.new_slot)]
    t_row = t_core.step(state, xs)
    for name in tb.EventTrace._fields:
        got, want = getattr(t_row, name), getattr(j_row, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    got = tb.state_to_numpy(state)
    for name in ("base", "free", "f", "rr", "ring_gpu", "ring_mask"):
        assert got[name].dtype == np.asarray(getattr(j_next, name)).dtype, name
        np.testing.assert_array_equal(got[name], getattr(j_next, name), err_msg=name)
    if state.occ is not None:  # occupancy stays what the ring implies
        assert torch.equal(state.occ, tb._occ_from_ring(state, spec.num_gpus))


# ---------------------------------------------------------------------------
# The reference's pinned golden results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("tag,fleet,kw", [
    ("homog", None, dict(num_gpus=5, offered_load=1.1, seed=7)),
    ("mixed", MIXED, dict(offered_load=1.0, seed=9)),
])
def test_golden_trace_hashes(tag, fleet, kw, use_kernel):
    cfg, _ = twin_configs(fleet, **kw)
    trace, _ = port_run("mfi", cfg, 3, use_kernel)
    assert trace_hash(trace) == GOLDEN_TRACE_HASHES[tag]


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("key", sorted(GOLDEN_AGGREGATES), ids=lambda k: "/".join(k))
def test_golden_aggregates(key, use_kernel):
    kw, want = GOLDEN_AGGREGATES[key]
    cfg, _ = twin_configs(**kw)
    r = tb.run_batched(key[1], cfg, runs=4, use_kernel=use_kernel, device="cpu")
    for name, value in want.items():
        assert r[name] == value, name


# ---------------------------------------------------------------------------
# A replica state carried across from the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("policy,fleet", [("mfi", None), ("wf-bi", FOUR)],
                         ids=["mfi-homog", "wf-bi-four-model"])
def test_state_carried_from_reference_continues_identically(policy, fleet, use_kernel):
    """The reference scans the first half of the stream (its chunked
    chunked scan, ``init_carry`` + ``_scan_chunk``); the port continues from the
    converted carry and reproduces the reference's second half."""
    tcfg, jcfg = twin_configs(fleet, **({} if fleet else {"num_gpus": 6}),
                              offered_load=1.0, seed=41)
    runs = 3
    jev, _, rows, cols = jb.presample_arrivals(jcfg, runs)
    common = jax_common(jcfg, rows, cols)
    _, want = jax.device_get(jb._simulate(jax.tree.map(jnp.asarray, jev),
                                          policy=policy, **common))
    half = jev.pid.shape[0] // 2
    carry = jb.init_carry(runs, policy=policy, **common)
    first = jb.EventStream(*[None if a is None else a[:half] for a in jev])
    scan_kw = {k: v for k, v in common.items() if k not in ("ring_rows", "ring_cols")}
    carry, _ = jb._scan_chunk(carry, jax.tree.map(jnp.asarray, first), policy=policy,
                              **scan_kw)
    state = tb.state_from_numpy(jax.device_get(carry)._asdict(), "cpu")
    tev, _, _, _ = tb.presample_arrivals(tcfg, runs)
    second = tb.EventStream(*[None if a is None else a[half:] for a in tev])
    got, final = port_run(policy, tcfg, runs, use_kernel, events=second,
                          state=state, rows=(rows, cols))
    want_second = type(want)(*[None if a is None else np.asarray(a)[half:] for a in want])
    assert_traces_equal(got, want_second)
    back = tb.state_to_numpy(final)
    assert set(back) >= {"base", "free", "f", "rr", "ring_gpu", "ring_mask"}


# ---------------------------------------------------------------------------
# Full width: the paper's fleet of M = 100 A100-80GB at offered load 1.0
# ---------------------------------------------------------------------------


def test_full_width_mfi_equals_reference():
    tcfg, jcfg = twin_configs(num_gpus=100, offered_load=1.0, seed=0)
    runs = 4
    jev, _, rows, cols = jb.presample_arrivals(jcfg, runs)
    _, want = jax.device_get(jb._simulate(jax.tree.map(jnp.asarray, jev), policy="mfi",
                                          **jax_common(jcfg, rows, cols)))
    got, _ = port_run("mfi", tcfg, runs, use_kernel=True)
    assert_traces_equal(got, want)


def test_full_width_hash_pinned_in_chip_smoke_is_the_reference():
    pinned = re.search(r'^FULL_WIDTH_HASH = "([0-9a-f]{64})"',
                       (REPO / "chip_smoke.py").read_text(), re.M).group(1)
    _, jcfg = twin_configs(num_gpus=100, offered_load=1.0, seed=0)
    jev, _, rows, cols = jb.presample_arrivals(jcfg, 8)
    _, trace = jax.device_get(jb._simulate(jax.tree.map(jnp.asarray, jev), policy="mfi",
                                           **jax_common(jcfg, rows, cols)))
    fields = (trace.ok, trace.gpu, trace.aidx, trace.free_sum, trace.active, trace.frag)
    assert trace_hash(fields) == pinned


# ---------------------------------------------------------------------------
# Entry-point rules
# ---------------------------------------------------------------------------


def test_delta_only_spec_matches_fused_decisions():
    """A ``kernel_lowering="delta"`` spec takes the ΔF-kernel path and
    decides exactly like mfi."""
    cfg = tsim.SimConfig(num_gpus=4, offered_load=1.0, seed=3)
    delta_only = PolicySpec(name="mfi-delta-only", keys=("frag-delta", "gpu", "anchor"),
                            kernel_lowering="delta")
    core = tb._build_core(policy=delta_only, metric="blocked", num_gpus=4,
                          use_kernel=True, runs=2, device="cpu")
    assert core.delta_fn is not None and core.select_fn is None
    a = port_run(delta_only, cfg, 2, use_kernel=True)[0]
    b = port_run("mfi", cfg, 2, use_kernel=True)[0]
    assert_traces_equal(a, b)


def test_device_none_means_cuda_and_never_falls_back():
    cfg = tsim.SimConfig(num_gpus=3, offered_load=1.0, seed=1)
    spec = tmig.ClusterSpec.homogeneous(tmig.A100_80GB, 3)
    helpers = {
        "make_frag_fn": lambda: tb.make_frag_fn(),
        "make_delta_fn": lambda: tb.make_delta_fn(spec),
        "make_select_fn": lambda: tb.make_select_fn(spec, resolve("mfi")),
        "make_migrate_fn": lambda: tb.make_migrate_fn(spec, resolve("mfi-defrag")),
        "spec_tables": lambda: tb.spec_tables(spec),
        "tables_for": lambda: tcluster.tables_for(tmig.A100_80GB),
    }
    if torch.cuda.is_available():
        assert tb.resolve_device(None).type == "cuda"
        assert tb.spec_tables(spec).W.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=None means 'cuda'"):
            tb.run_batched("mfi", cfg, runs=2)
        with pytest.raises(RuntimeError, match="cuda"):
            tb.policy_select(np.zeros((3, 8), np.int32), 0, "mfi")
        for name, helper in helpers.items():
            with pytest.raises(RuntimeError, match="device=None means 'cuda'"):
                helper()
    assert tb.spec_tables(spec, "cpu").W.device.type == "cpu"
    assert tcluster.tables_for(tmig.A100_80GB, device="cpu").placement_masks.device.type == "cpu"


def test_unported_configurations_raise():
    """Every protocol is ported: the faulted one raises only without a
    fault model, as in the reference; the cumulative, queued and faulted
    protocols and mfi-defrag run; ``shard=True`` with one visible device
    raises the reference's ``ValueError``."""
    with pytest.raises(ValueError, match="fault_model"):
        tb.run_batched("mfi", tsim.SimConfig(num_gpus=3, protocol="steady-faulted"),
                       runs=2, device="cpu")
    for protocol in ("cumulative", "steady-queued", "steady-faulted"):
        r = tb.run_batched("mfi", tsim.SimConfig(num_gpus=3, protocol=protocol,
                                                 fault_model=tmig.FaultModel()),
                           runs=2, device="cpu")
        assert 0.0 < r["acceptance_rate"] <= 1.0, protocol
    with pytest.raises(ValueError, match="only one device is visible"):
        tb.run_batched("mfi", tsim.SimConfig(num_gpus=3), runs=2, shard=True, device="cpu")
    r = tb.run_batched("mfi-defrag", tsim.SimConfig(num_gpus=3), runs=2, device="cpu")
    assert 0.0 < r["acceptance_rate"] <= 1.0
    no_kernels = PolicySpec(name="plain-only", keys=("gpu",), kernel_lowering=False)
    with pytest.raises(ValueError, match="opts out"):
        tb.run_batched(no_kernels, tsim.SimConfig(num_gpus=3), runs=2,
                       use_kernel=True, device="cpu")
