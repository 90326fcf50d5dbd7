"""The port's host reference engine and its facade equal the reference's.

``repro_torch.sim.simulator.run_simulation`` against
``repro.sim.simulator.run_simulation`` field for field (types included)
under all four protocols, on a homogeneous and a mixed fleet, with the
host schedulers of both packages; ``run_many``'s dict; the same stream
decided through ``cluster.mfi_select(use_kernel=True)`` (the path
``chip_smoke.py`` drives on the card); and ``repro_torch.api.simulate``
against ``repro.api.simulate`` on both engines (the batched one on the
CPU), with the facade's refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import mig as jmig
from repro.core import schedulers as jschedulers
from repro.sim import simulator as jsim

from repro_torch import api as tapi
from repro_torch.core import cluster as tcluster
from repro_torch.core import mig as tmig
from repro_torch.core import schedulers as tschedulers
from repro_torch.kernels.fragscore import fragscore as tk
from repro_torch.sim import simulator as tsim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PROTOCOLS = ("steady", "cumulative", "steady-queued", "steady-faulted")
FLEETS = {"homog": None, "mixed": "a100-80:4,a100-40:4,h200-141:2"}
CASES = [(proto, policy, fleet)
         for proto in PROTOCOLS
         for policy in ("mfi", "ff", "rr", "mfi-defrag")
         + (("mfi-queued",) if proto == "steady-queued" else ())
         for fleet in FLEETS]


def configs(protocol, fleet, **kw):
    """Equal ``SimConfig``s of both packages."""
    kw = {"num_gpus": 8, "offered_load": 1.1, "seed": 3, "protocol": protocol, **kw}
    out = []
    for mig, sim in ((jmig, jsim), (tmig, tsim)):
        c = dict(kw)
        if FLEETS[fleet]:
            c["cluster_spec"] = mig.ClusterSpec.parse(FLEETS[fleet])
        if protocol == "steady-faulted":
            c["fault_model"] = mig.FaultModel(mtbf=60.0, mttr=10.0)
        out.append(sim.SimConfig(**c))
    return out


def assert_result_equal(got, want):
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (f.name, k)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert type(a) is type(b) and a == b, (f.name, a, b)


def outcome(run):
    """The result, or the ValueError the run raised."""
    try:
        return run()
    except ValueError as e:
        return e


@pytest.mark.parametrize("protocol,policy,fleet", CASES)
def test_run_simulation_equals_reference(protocol, policy, fleet):
    jcfg, tcfg = configs(protocol, fleet)
    want = outcome(lambda: jsim.run_simulation(jschedulers.make_scheduler(policy), jcfg))
    got = outcome(lambda: tsim.run_simulation(tschedulers.make_scheduler(policy), tcfg))
    if protocol == "steady-faulted" and policy == "mfi-defrag":
        # the reference's faulted dispatch never applies a defrag
        # scheduler's pending migration, so its placement collides: the
        # port raises the same error at the same arrival
        assert isinstance(want, ValueError) and "overlaps occupied slices" in str(want)
        assert isinstance(got, ValueError) and str(got) == str(want)
        return
    assert not isinstance(want, Exception), want
    assert_result_equal(got, want)
    if protocol == "steady-faulted":
        assert got.evictions > 0


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_run_many_equals_reference(protocol):
    jcfg, tcfg = configs(protocol, "homog", seed=5)
    want = jsim.run_many("mfi", jcfg, runs=3)
    got = tsim.run_many("mfi", tcfg, runs=3)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert all(np.array_equal(got[k][i], v[i]) for i in v)
        else:
            assert np.array_equal(got[k], v) and type(got[k]) is type(v), k


class KernelMFI(tschedulers.Scheduler):
    """MFI deciding through ``cluster.mfi_select(use_kernel=True)`` on the
    occupancy tensor (on the CPU: the kernel's plain version)."""

    name = "mfi-kernel"

    def select(self, cluster, profile_id):
        occ = torch.as_tensor(cluster.occupancy_matrix())
        d = tcluster.mfi_select(occ, profile_id, self.metric, use_kernel=True)
        self.calls += 1
        return (int(d.gpu), int(d.anchor)) if bool(d.accepted) else None

    def reset(self):
        self.calls = 0


@pytest.mark.parametrize("metric", ["blocked", "partial"])
def test_kernel_lowered_decisions_drive_the_host_engine(metric):
    """The slice end to end: run_simulation -> select -> mfi_select(use_kernel)
    -> mfi_delta gives the reference's host-MFI result, one ΔF table per
    arrival."""
    jcfg, tcfg = configs("steady", "homog", num_gpus=12, offered_load=1.0, seed=0,
                         metric=metric)
    sched = KernelMFI(metric)
    launches = tk.mfi_delta.launches
    got = tsim.run_simulation(sched, tcfg)
    want = jsim.run_simulation(jschedulers.make_scheduler("mfi", metric), jcfg)
    assert_result_equal(got, want)
    assert sched.calls > 0
    assert tk.mfi_delta.launches == launches  # CPU tensors: no kernel launch


@pytest.mark.parametrize("policy", ["mfi", "bf-bi", "mfi-defrag"])
def test_simulate_python_engine_equals_reference(policy):
    kw = dict(engine="python", runs=2, num_gpus=8, offered_load=1.0, seed=2)
    want = japi.simulate(policy, **kw)
    got = tapi.simulate(policy, **kw)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("policy", ["mfi", "rr"])
def test_simulate_batched_engine_on_cpu_equals_reference(policy):
    kw = dict(engine="batched", runs=3, num_gpus=5, offered_load=1.0, seed=4)
    want = japi.simulate(policy, use_kernel=False, **kw)
    got = tapi.simulate(policy, device="cpu", **kw)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_simulate_refusals():
    """The reference's refusals: the python engine refuses the chunked
    knobs, a chunk size must be positive, the faulted protocol needs a
    fault model; the batched engine takes ``chunk_size``/``stream``."""
    cfg = tsim.SimConfig(num_gpus=4)
    for kw in (dict(chunk_size=8), dict(stream=True)):
        with pytest.raises(ValueError, match="batched-engine knobs"):
            tapi.simulate("mfi", cfg, engine="python", **kw)
    for engine in ("batched", "python"):
        with pytest.raises(ValueError, match="chunk_size"):
            tapi.simulate("mfi", cfg, engine=engine, chunk_size=0)
    with pytest.raises(ValueError, match="fault_model"):
        tapi.simulate("mfi", tsim.SimConfig(num_gpus=4, protocol="steady-faulted"),
                      engine="batched", device="cpu")
    whole = tapi.simulate("mfi", cfg, engine="batched", runs=2, device="cpu")
    chunked = tapi.simulate("mfi", cfg, engine="batched", runs=2, device="cpu",
                            chunk_size=64, stream=False)
    assert all(np.array_equal(chunked[k], v) for k, v in whole.items())
    with pytest.raises(ValueError, match="batched-engine knob"):
        tapi.simulate("mfi", cfg, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tapi.simulate("mfi", cfg, num_gpus=4)
    with pytest.raises(ValueError, match="unknown policy"):
        tapi.simulate("no-such-policy", cfg)
    if not torch.cuda.is_available():  # device=None means the card
        with pytest.raises(RuntimeError, match="cuda"):
            tapi.simulate("mfi", cfg, engine="batched", runs=1)


def test_facade_exports_match_reference():
    names = [n for n in dir(japi) if not n.startswith("_") and n not in ("annotations", "Dict", "Optional")]
    for n in names:
        assert hasattr(tapi, n), n
    assert tapi.make_policy("ff").spec.name == "ff"
    import repro.core as jcore
    import repro.sim as jsim_pkg
    import repro_torch.core as tcore
    import repro_torch.sim as tsim_pkg
    for jp, tp in ((jcore, tcore), (jsim_pkg, tsim_pkg)):
        public = [n for n in dir(jp) if not n.startswith("_") and n.isidentifier()
                  and not isinstance(getattr(jp, n), type(np))]
        missing = [n for n in public if not hasattr(tp, n)]
        assert missing == [], missing
