"""The cumulative protocol in the port's batched engine against the
reference package (tolerance 0): the presampled streams, every trace field
and ``run_batched``'s whole dict, the demand-grid traces included.

The reference runs with ``use_kernel=False`` in JAX on the CPU; the port
runs with ``device="cpu"``, through its kernel wrappers' plain versions
(``use_kernel=True``) and through its plain lowering (``use_kernel=False``).
Each reference trace is computed with ``run_batched``'s own static
arguments, so ``run_batched`` reuses that compiled program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.core import policy as jpolicy
from repro.sim import batched as jb
from repro.sim import simulator as jsim

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

#: the reference's cumulative configurations (tests/test_engine_core.py,
#: TestBatchedCumulative): (policy, SimConfig keywords, fleet, runs)
CASES = {
    "mfi": ("mfi", dict(num_gpus=4, seed=5), None, 3),
    "ff": ("ff", dict(num_gpus=4, seed=5), None, 3),
    "rr": ("rr", dict(num_gpus=4, seed=5), None, 3),
    "mixed-mfi": ("mfi", dict(seed=2), MIXED, 2),
    "mfi-defrag": ("mfi-defrag", dict(num_gpus=2, seed=8), None, 2),
}


def twin_configs(fleet, **kw):
    """(port SimConfig, reference SimConfig) of one cumulative description."""
    kw = dict(kw, protocol="cumulative")
    if fleet is None:
        return tsim.SimConfig(**kw), jsim.SimConfig(**kw)
    return (tsim.SimConfig(cluster_spec=tmig.ClusterSpec.parse(fleet), **kw),
            jsim.SimConfig(cluster_spec=jmig.ClusterSpec.parse(fleet), **kw))


@functools.lru_cache(maxsize=None)
def reference(case):
    """The reference's stream, trace and ``run_batched`` dict of ``case``."""
    policy, kw, fleet, runs = CASES[case]
    _, cfg = twin_configs(fleet, **kw)
    spec = cfg.spec()
    events, meta, rows, cols = jb.presample_cumulative(cfg, runs)
    _, trace = jax.device_get(jb._simulate(
        jax.tree.map(jnp.asarray, events),
        policy=jpolicy.resolve(policy, engine="batched"), metric=cfg.metric,
        num_gpus=cfg.num_gpus, ring_rows=rows, ring_cols=cols, use_kernel=False,
        kernel_spec=None, protocol=jb.resolve_protocol("cumulative"), wait_slots=0,
        wait_patience=0, midx=jnp.asarray(spec.model_index), tables=jb.spec_tables(spec),
    ))
    return events, meta, (rows, cols), trace, jb.run_batched(policy, cfg, runs=runs)


def port_trace(case, use_kernel):
    policy, kw, fleet, runs = CASES[case]
    cfg, _ = twin_configs(fleet, **kw)
    spec = cfg.spec()
    events, _, rows, cols = tb.presample_cumulative(cfg, runs)
    _, trace = tb._simulate(
        events, policy=policy, metric=cfg.metric, num_gpus=cfg.num_gpus,
        ring_rows=rows, ring_cols=cols, use_kernel=use_kernel, kernel_spec=spec,
        protocol="cumulative", midx=torch.as_tensor(spec.model_index),
        tables=tb.spec_tables(spec, "cpu"), device="cpu",
    )
    return tb.trace_to_numpy(trace)


def assert_results_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k].keys() == v.keys(), k
            for name, arr in v.items():
                assert np.array_equal(got[k][name], arr), (k, name)
        else:
            assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_presample_cumulative_is_byte_identical(case):
    policy, kw, fleet, runs = CASES[case]
    tcfg, jcfg = twin_configs(fleet, **kw)
    t_ev, t_meta, t_rows, t_cols = tb.presample_cumulative(tcfg, runs)
    j_ev, j_meta, j_rows, j_cols = jb.presample_cumulative(jcfg, runs)
    assert (t_rows, t_cols) == (j_rows, j_cols)
    for name in tb.EventStream._fields:
        got, want = getattr(t_ev, name), getattr(j_ev, name)
        assert (got is None) == (want is None), name
        if want is not None:
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.tobytes() == np.ascontiguousarray(want).tobytes(), name
    for got, want in zip(t_meta, j_meta):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cumulative_trace_equals_reference(case, use_kernel):
    """Every field: ``ok``, ``gpu``, ``aidx``, the ``post_*`` metrics (and
    the ``mig*`` fields for mfi-defrag); the boundary metrics are absent
    in both."""
    want = reference(case)[3]
    got = port_trace(case, use_kernel)
    for name in tb.EventTrace._fields:
        g, w = getattr(got, name), getattr(want, name, None)
        assert (g is None) == (w is None), name
        if w is not None:
            w = np.asarray(w)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.free_sum is None and got.post_free is not None
    if case == "mfi-defrag":
        assert got.mig is not None


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-dispatch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_run_batched_cumulative_equals_reference(case, use_kernel):
    policy, kw, fleet, runs = CASES[case]
    cfg, _ = twin_configs(fleet, **kw)
    got = tb.run_batched(policy, cfg, runs=runs, use_kernel=use_kernel, device="cpu")
    want = reference(case)[4]
    assert_results_equal(got, want)
    assert got["traces"]["utilization"].shape == (len(cfg.demand_grid),)

