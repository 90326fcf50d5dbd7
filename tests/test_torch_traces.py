"""Whole decision traces of the port equal the reference's jnp lowering,
for the paper's five policies on homogeneous, two-model and four-model
fleets (tolerance 0): every field of every event of every replica.

The port runs twice: through its kernel dispatch (``use_kernel=True``; on
CPU tensors the wrappers compute their plain versions) and through the
plain lowering.
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


FLEETS = {
    "homog": None,
    "mixed": "a100-80:3,a100-40:3",
    "four": "a100-80:2,a100-40:2,h100-96:2,h100-80:2",
}
LOAD = {"homog": 1.0, "mixed": 1.0, "four": 0.9}


def run_both(policy, fleet, metric="blocked", runs=3, seed=21):
    kw = dict(offered_load=LOAD[fleet], seed=seed, metric=metric)
    if FLEETS[fleet] is None:
        tcfg, jcfg = tsim.SimConfig(num_gpus=6, **kw), jsim.SimConfig(num_gpus=6, **kw)
    else:
        tcfg = tsim.SimConfig(cluster_spec=tmig.ClusterSpec.parse(FLEETS[fleet]), **kw)
        jcfg = jsim.SimConfig(cluster_spec=jmig.ClusterSpec.parse(FLEETS[fleet]), **kw)
    jev, _, rows, cols = jb.presample_arrivals(jcfg, runs)
    jspec = jcfg.spec()
    _, want = jax.device_get(jb._simulate(
        jax.tree.map(jnp.asarray, jev), policy=policy, metric=metric,
        num_gpus=jcfg.num_gpus, ring_rows=rows, ring_cols=cols, use_kernel=False,
        midx=jnp.asarray(jspec.model_index), tables=jb.spec_tables(jspec),
    ))
    tev, _, _, _ = tb.presample_arrivals(tcfg, runs)
    spec = tcfg.spec()
    got = {}
    for use_kernel in (True, False):
        _, trace = tb._simulate(
            tev, policy=policy, metric=metric, num_gpus=tcfg.num_gpus,
            ring_rows=rows, ring_cols=cols, use_kernel=use_kernel, kernel_spec=spec,
            midx=torch.as_tensor(spec.model_index), tables=tb.spec_tables(spec, "cpu"),
            device="cpu",
        )
        got[use_kernel] = tb.trace_to_numpy(trace)
    return got, want


@pytest.mark.parametrize("fleet", sorted(FLEETS))
@pytest.mark.parametrize("policy", ["mfi", "ff", "bf-bi", "wf-bi", "rr"])
def test_traces_equal_reference(policy, fleet):
    got, want = run_both(policy, fleet)
    for trace in got.values():
        for name in tb.EventTrace._fields:
            g, w = getattr(trace, name), getattr(want, name)
            assert (g is None) == (w is None), name
            if w is None:
                continue
            w = np.asarray(w)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=f"{policy}/{fleet}/{name}")


def test_partial_metric_trace_equals_reference():
    got, want = run_both("mfi", "homog", metric="partial", seed=5)
    for trace in got.values():
        for name in tb.EventTrace._fields:
            g, w = getattr(trace, name), getattr(want, name)
            assert (g is None) == (w is None), name
            if w is not None:
                np.testing.assert_array_equal(g, np.asarray(w))
