"""The port's host control plane equals the reference package's exactly:
``ClusterState``, the fragmentation scorer, the six host schedulers and
the serving ``AdmissionController`` (queue, quotas, faults, backoff,
stats).

Both packages are driven through the same operations; every return value,
the queue, the placements, the occupancy and ``stats()`` are compared with
``==`` (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import fragmentation as jfrag
from repro.core import mig as jmig
from repro.core import schedulers as jsched
from repro.serving import admission as jadm
from repro.sim import simulator as jsim

from repro_torch.core import fragmentation as tfrag
from repro_torch.core import mig as tmig
from repro_torch.core import schedulers as tsched
from repro_torch.serving import admission as tadm
from repro_torch.sim import simulator as tsim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


POLICIES = ["mfi", "ff", "rr", "bf-bi", "wf-bi", "mfi-defrag"]
FLEETS = {
    "homog": "a100-80:4",
    "mixed": "a100-80:2,a100-40:2",
    "four": "a100-80:2,a100-40:2,h100-96:1,h200-141:1",
}


def specs(fleet):
    return jmig.ClusterSpec.parse(FLEETS[fleet]), tmig.ClusterSpec.parse(FLEETS[fleet])


# ---------------------------------------------------------------------------
# ClusterState and fragmentation
# ---------------------------------------------------------------------------


def cluster_view(c):
    return (c.occupancy_matrix().tolist(), c.up_mask().tolist(), c.active_gpus,
            c.used_mem_slices, c.used_compute_slices, c.total_mem_slices,
            [sorted((w, dataclasses.astuple(a)) for w, a in g.allocations.items())
             for g in c.gpus],
            [g.free_slices for g in c.gpus])


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_cluster_state_operations_match(fleet):
    js, ts = specs(fleet)
    jc, tc = jmig.ClusterState(spec=js), tmig.ClusterState(spec=ts)
    rng = np.random.default_rng(11)
    live = []
    for wid in range(60):
        op = rng.random()
        if op < 0.15 and live:
            w = live.pop(int(rng.integers(len(live))))
            jc.release(w)
            tc.release(w)
        elif op < 0.2:
            g = int(rng.integers(js.num_gpus))
            if jc.gpus[g].up:
                got = (jc.fail_gpu(g), tc.fail_gpu(g))
                live = [w for w in live if w not in got[0]]
            else:
                got = (jc.recover_gpu(g), tc.recover_gpu(g))
            assert got[0] == got[1]
        else:
            pid = int(rng.integers(jmig.NUM_PROFILES))
            g = int(rng.integers(js.num_gpus))
            anchors = jc.gpus[g].feasible_anchors(pid)
            assert anchors == tc.gpus[g].feasible_anchors(pid)
            if anchors:
                a = anchors[int(rng.integers(len(anchors)))]
                jc.allocate(wid, pid, g, a)
                tc.allocate(wid, pid, g, a)
                live.append(wid)
        assert cluster_view(jc) == cluster_view(tc)
    # a migration and the validation errors
    if live:
        w = live[0]
        pid = jc.gpus[jc.gpu_of(w)].allocations[w].profile_id
        for g in range(js.num_gpus):
            anchors = jc.gpus[g].feasible_anchors(pid)
            if anchors:
                assert jc.migrate(w, g, anchors[0]) == tc.migrate(w, g, anchors[0])
                break
        with pytest.raises(ValueError, match="already placed"):
            tc.allocate(w, 0, 0, 0)
    with pytest.raises(KeyError, match="not placed"):
        tc.release(10_000)
    assert cluster_view(jc) == cluster_view(tc)


def test_gpu_state_errors_match():
    for pkg in (jmig, tmig):
        g = pkg.GPUState(0)
        with pytest.raises(ValueError, match="illegal"):
            g.allocate(1, pkg.PROFILE_NAMES.index("3g.40gb"), 1)
        g.allocate(1, pkg.PROFILE_NAMES.index("1g.10gb"), 0)
        with pytest.raises(ValueError, match="overlaps"):
            g.allocate(2, pkg.PROFILE_NAMES.index("1g.10gb"), 0)
    assert [tmig.profile_placement_rows(p) for p in range(tmig.NUM_PROFILES)] == [
        jmig.profile_placement_rows(p) for p in range(jmig.NUM_PROFILES)]


@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("model", ["A100_80GB", "A100_40GB", "H100_96GB", "H200_141GB"])
def test_fragmentation_scores_match(metric, model):
    jm, tm = getattr(jmig, model), getattr(tmig, model)
    rng = np.random.default_rng(3)
    occ = (rng.random((64, jm.num_mem_slices)) < 0.4).astype(np.int32)
    got = tfrag.fragmentation_scores(occ, metric, tm)
    want = jfrag.fragmentation_scores(occ, metric, jm)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    g = tmig.GPUState(0, tm)
    g.occupancy[:] = occ[5]
    assert tfrag.fragmentation_score(g, metric) == jfrag.fragmentation_score(occ[5], metric, jm)
    for pid in range(tmig.NUM_PROFILES):
        for a in tm.profiles[pid].anchors:
            for row in occ[:8]:
                if not row[a:a + tm.profiles[pid].mem].any():
                    assert tfrag.delta_f(row, pid, a, metric, tm) == jfrag.delta_f(
                        row, pid, a, metric, jm)


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_spec_fragmentation_matches(fleet):
    js, ts = specs(fleet)
    rng = np.random.default_rng(5)
    occ = (rng.random((js.num_gpus, js.num_mem_slices)) < 0.5).astype(np.int32)
    for g in range(js.num_gpus):
        occ[g, js.model_of(g).num_mem_slices:] = 0
    for metric in ("blocked", "partial"):
        assert np.array_equal(tfrag.spec_fragmentation_scores(occ, ts, metric),
                              jfrag.spec_fragmentation_scores(occ, js, metric))
        assert tfrag.cluster_fragmentation(occ, metric, ts) == jfrag.cluster_fragmentation(
            occ, metric, js)
    with pytest.raises(ValueError, match="metric"):
        tfrag.fragmentation_scores(occ, "bogus")


def test_jain_fairness_matches():
    for values in ([], [0.0, 0.0], [1.0], [0.2, 0.9, 0.5], np.linspace(0, 1, 7)):
        assert tsim.jain_fairness(values) == jsim.jain_fairness(values)


# ---------------------------------------------------------------------------
# Host schedulers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fleet", ["homog", "mixed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_scheduler_decisions_match(policy, fleet):
    """The same random arrival/termination stream through both compiled
    schedulers: every decision, pending migration and end state equal."""
    js, ts = specs(fleet)
    jc, tc = jmig.ClusterState(spec=js), tmig.ClusterState(spec=ts)
    jsch, tsch = jsched.make_scheduler(policy), tsched.make_scheduler(policy)
    assert type(tsch).__name__ == type(jsch).__name__
    rng = np.random.default_rng(21)
    live = []
    migrations = 0
    for wid in range(120):
        for _ in range(int(rng.integers(0, 3))):
            if live and rng.random() < 0.5:
                w = live.pop(0)
                jc.release(w)
                tc.release(w)
        pid = int(rng.integers(jmig.NUM_PROFILES))
        jsel, tsel = jsch.select(jc, pid), tsch.select(tc, pid)
        assert jsel == tsel
        jpend = getattr(jsch, "pending_migration", None)
        assert jpend == getattr(tsch, "pending_migration", None)
        if jsel is None:
            continue
        if jpend is not None:
            migrations += 1
            jc.migrate(*jpend)
            tc.migrate(*jpend)
        jc.allocate(wid, pid, *jsel)
        tc.allocate(wid, pid, *jsel)
        live.append(wid)
    assert cluster_view(jc) == cluster_view(tc)
    if policy == "mfi-defrag":
        assert tsch.migrations == jsch.migrations == migrations


@pytest.mark.parametrize("metric", ["blocked", "partial"])
def test_mfi_candidates_match(metric):
    rng = np.random.default_rng(9)
    for model in ("A100_80GB", "A100_40GB", "H200_141GB"):
        jm, tm = getattr(jmig, model), getattr(tmig, model)
        occ = (rng.random((12, jm.num_mem_slices)) < 0.35).astype(np.int32)
        for pid in range(jmig.NUM_PROFILES):
            got = tsched.mfi_candidates(occ, pid, metric, tm)
            want = jsched.mfi_candidates(occ, pid, metric, jm)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)


def test_defrag_candidate_budget_matches():
    js, ts = specs("homog")
    jc, tc = jmig.ClusterState(spec=js), tmig.ClusterState(spec=ts)
    j = jsched.MFIDefrag(max_candidates=2)
    t = tsched.MFIDefrag(max_candidates=2)
    rng = np.random.default_rng(2)
    for wid in range(40):
        pid = int(rng.integers(jmig.NUM_PROFILES))
        sel = j.select(jc, pid)
        assert sel == t.select(tc, pid)
        assert j.pending_migration == t.pending_migration
        if sel is not None:
            if j.pending_migration:
                jc.migrate(*j.pending_migration)
                tc.migrate(*j.pending_migration)
            jc.allocate(wid, pid, *sel)
            tc.allocate(wid, pid, *sel)
    assert sorted(tsched.SCHEDULERS) == sorted(jsched.SCHEDULERS)
    with pytest.raises(ValueError, match="unknown policy"):
        tsched.make_scheduler("nope")


# ---------------------------------------------------------------------------
# AdmissionController
# ---------------------------------------------------------------------------


def norm(x):
    """Comparable form of a controller's return value."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, dataclasses.astuple(x))
    if isinstance(x, list):
        return [norm(v) for v in x]
    return x


def controller_view(ac):
    return (
        ac.stats(),
        [dataclasses.astuple(e) for e in ac.queue],
        {w: dataclasses.astuple(p) for w, p in ac.placements.items()},
        ac.cluster.occupancy_matrix().tolist(),
        ac.cluster.up_mask().tolist(),
        (ac.accepted, ac.rejected, ac.completed, ac.evictions, ac.evict_lost,
         ac.clock, ac.acceptance_rate, ac.queue_depth),
    )


def drive(script, **kwargs):
    """Run ``script`` (``(method, args, kwargs)`` triples) through both
    controllers; assert equal results step by step; return the port's
    controller and the results."""
    j, t = jadm.AdmissionController(**kwargs), tadm.AdmissionController(**kwargs)
    results = []
    for name, args, kw in script:
        out = []
        for ac in (j, t):
            try:
                out.append(("ok", norm(getattr(ac, name)(*args, **kw))))
            except (ValueError, KeyError) as e:
                out.append(("raise", type(e).__name__))
        assert out[0] == out[1], (name, args, kw)
        results.append(out[1])
        assert controller_view(j) == controller_view(t), (name, args, kw)
    return t, results


def op(name, *args, **kw):
    return (name, args, kw)


#: the reference's serving unit tests (tests/test_serving.py TestAdmission,
#: TestQueuedAdmission; tests/test_faults.py TestServingFaults), as scripts
SCENARIOS = {
    "admit_release": (dict(num_gpus=2), [
        op("admit", 1, "3g.40gb"), op("release", 1)]),
    "rejection_when_full": (dict(num_gpus=1), [
        op("admit", 1, "7g.80gb"), op("admit", 2, "1g.10gb")]),
    "duplicate_and_unknown": (dict(num_gpus=2), [
        op("admit", 1, "1g.10gb"), op("admit", 1, "1g.10gb"), op("release", 99),
        op("submit", 2, "9g.90gb"), op("submit", 3, "1g.10gb", priority=-1),
        op("submit", 4, "1g.10gb", patience=-1), op("release", 1)]),
    "parked_dispatches_on_release": (dict(num_gpus=1), [
        op("submit", 1, "7g.80gb"), op("submit", 2, "7g.80gb", patience=4),
        op("in_queue", 2), op("release", 1), op("drain_dispatched"), op("in_queue", 2)]),
    "priority_orders_queue": (dict(num_gpus=1), [
        op("submit", 1, "7g.80gb"), op("submit", 2, "7g.80gb", priority=1, patience=8),
        op("submit", 3, "7g.80gb", priority=0, patience=8), op("release", 1),
        op("drain_dispatched"), op("in_queue", 2)]),
    "patience_expiry": (dict(num_gpus=1), [
        op("submit", 1, "7g.80gb"), op("submit", 2, "1g.10gb", patience=2),
        op("tick", 3), op("drain_expired")]),
    "tenant_quota": (dict(num_gpus=2, tenant_quotas={"a": 1}), [
        op("submit", 1, "1g.10gb", tenant="a"), op("submit", 2, "1g.10gb", tenant="a", patience=4),
        op("submit", 3, "1g.10gb", tenant="b"), op("release", 1), op("drain_dispatched")]),
    "queue_capacity": (dict(num_gpus=1, queue_capacity=1), [
        op("submit", 1, "7g.80gb"), op("submit", 2, "1g.10gb", patience=4),
        op("submit", 3, "1g.10gb", patience=4)]),
    "wait_and_fairness": (dict(num_gpus=1), [
        op("submit", 1, "7g.80gb", tenant="a"), op("submit", 2, "7g.80gb", tenant="b", patience=8),
        op("tick", 2), op("release", 1), op("drain_dispatched")]),
    "fail_requeues_with_backoff": (dict(num_gpus=2, queue_capacity=4), [
        op("submit", 1, "3g.40gb", patience=8), op("submit", 2, "3g.40gb", patience=8),
        op("fail_gpu", 0), op("drain_dispatched"), op("tick"), op("tick"),
        op("drain_dispatched"), op("fail_gpu", 0), op("recover_gpu", 0), op("recover_gpu", 0)]),
    "recovery_readmits": (dict(num_gpus=2, queue_capacity=4), [
        op("submit", 1, "7g.80gb", patience=8), op("submit", 2, "7g.80gb", patience=8),
        op("fail_gpu", 1), op("tick"), op("tick"), op("drain_dispatched"),
        op("recover_gpu", 1), op("drain_dispatched")]),
    "zero_retry_budget": (dict(num_gpus=1, max_retries=0), [
        op("submit", 1, "1g.10gb"), op("fail_gpu", 0), op("drain_expired")]),
    "full_queue_eviction": (dict(num_gpus=1, queue_capacity=0), [
        op("submit", 1, "1g.10gb"), op("fail_gpu", 0), op("drain_expired")]),
    "retry_budget_exhausts": (dict(num_gpus=1, queue_capacity=4, max_retries=2), [
        op("submit", 1, "7g.80gb"), op("fail_gpu", 0)] + [op("tick")] * 12 + [
        op("drain_expired")]),
    "goodput": (dict(num_gpus=2, max_retries=0), [
        op("submit", 1, "1g.10gb"), op("submit", 2, "1g.10gb"), op("release", 1),
        op("fail_gpu", 0), op("drain_expired")]),
    "flush_with_evictions": (dict(num_gpus=1, queue_capacity=4), [
        op("submit", 1, "4g.40gb", patience=3), op("submit", 2, "3g.40gb", patience=9),
        op("submit", 3, "7g.80gb", patience=9), op("fail_gpu", 0), op("flush_queue"),
        op("drain_expired"), op("recover_gpu", 0)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_admission_scenarios_match(name):
    kwargs, script = SCENARIOS[name]
    drive(script, policy="mfi", **kwargs)


def test_defrag_admission_applies_migration():
    """mfi-defrag admission migrates the blocking victim in both packages
    (the reference's test_defrag_policy_applies_migration scenario)."""
    acs = [jadm.AdmissionController(num_gpus=2, policy="mfi-defrag"),
           tadm.AdmissionController(num_gpus=2, policy="mfi-defrag")]
    pid = tmig.PROFILE_NAMES.index("1g.10gb")
    for ac, pkg in zip(acs, (jadm, tadm)):
        ac.admit(1, "1g.10gb")
        ac.release(1)
        ac.cluster.allocate(1, pid, 0, 1)
        ac.placements[1] = pkg.Placement(1, "1g.10gb", 0, 1)
        for wid, prof in ((2, "4g.40gb"), (3, "2g.20gb"), (4, "4g.40gb")):
            assert ac.admit(wid, prof) is not None
    assert controller_view(acs[0]) == controller_view(acs[1])
    assert (acs[1].placements[1].gpu, acs[1].placements[1].anchor) != (0, 1)


def random_script(seed, n=70):
    rng = np.random.default_rng(seed)
    script, ids = [], []
    tenants = ["a", "b", "c"]
    for wid in range(n):
        r = rng.random()
        if r < 0.4 and ids:
            for _ in range(int(rng.integers(1, 3))):
                if ids:
                    script.append(op("release", ids.pop(int(rng.integers(len(ids))))))
        elif r < 0.5:
            script.append(op("tick", int(rng.integers(1, 3))))
        elif r < 0.53:
            script.append(op("fail_gpu", int(rng.integers(3))))
        elif r < 0.6:
            script.append(op("recover_gpu", int(rng.integers(3))))
        elif r < 0.63:
            script.append(op("drain_dispatched"))
        elif r < 0.66:
            script.append(op("drain_expired"))
        elif r < 0.67:
            script.append(op("flush_queue"))
        script.append(op("submit", wid, tmig.PROFILE_NAMES[int(rng.integers(tmig.NUM_PROFILES))],
                         tenant=tenants[int(rng.integers(3))],
                         priority=int(rng.integers(0, 3)),
                         patience=int(rng.integers(0, 6))))
        ids.append(wid)
    return script + [op("drain_dispatched"), op("drain_expired"), op("stats")]


@pytest.mark.parametrize("fleet", ["homog", "mixed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_admission_random_streams_match(policy, fleet):
    """Random submit/release/tick/fail/recover/drain/flush streams with
    tenants, priorities, patience and a quota: equal at every step."""
    spec = tmig.ClusterSpec.parse(FLEETS[fleet])
    for seed in (0, 1, 2):
        drive(random_script(seed), policy=policy, cluster_spec=spec, queue_capacity=10,
              tenant_quotas={"a": 2}, max_retries=2, backoff_base=1)


@pytest.mark.parametrize("fleet", ["homog", "mixed"])
@pytest.mark.parametrize("policy", ["mfi", "bf-bi", "mfi-defrag"])
def test_admission_matches_host_scheduler(policy, fleet):
    """The reference's TestServingSimulatorParity, on the port: admission
    decisions equal a raw scheduler over ClusterState on one stream."""
    spec = tmig.ClusterSpec.parse(FLEETS[fleet])
    rng = np.random.default_rng(7)
    stream, live = [], []
    for wid in range(80):
        for _ in range(int(rng.integers(0, 3))):
            if live and rng.random() < 0.5:
                stream.append(("end", live.pop(0), -1))
        stream.append(("arr", wid, int(rng.integers(0, tmig.NUM_PROFILES))))
        live.append(wid)
    stream += [("end", w, -1) for w in live]

    cluster, sched = tmig.ClusterState(spec=spec), tsched.make_scheduler(policy)
    ac = tadm.AdmissionController(policy=policy, cluster_spec=spec)
    want, got = {}, {}
    for kind, wid, pid in stream:
        if kind == "end":
            if want.get(wid) is not None:
                cluster.release(wid)
                ac.release(wid)
            continue
        sel = sched.select(cluster, pid)
        if sel is not None:
            if getattr(sched, "pending_migration", None) is not None:
                cluster.migrate(*sched.pending_migration)
            cluster.allocate(wid, pid, *sel)
        want[wid] = sel
        p = ac.admit(wid, tmig.PROFILE_NAMES[pid])
        got[wid] = None if p is None else (p.gpu, p.anchor)
    assert got == want
    assert np.array_equal(ac.cluster.occupancy_matrix(), cluster.occupancy_matrix())


def test_profile_for_model_matches():
    for nbytes in (int(5e9), int(15e9), int(30e9), int(70e9)):
        for heavy in (False, True):
            assert tadm.profile_for_model(nbytes, compute_heavy=heavy) == \
                jadm.profile_for_model(nbytes, compute_heavy=heavy)
    with pytest.raises(ValueError, match="exceeds the largest"):
        tadm.profile_for_model(int(100e9))


def test_controller_argument_validation():
    for kwargs in (dict(queue_capacity=-1), dict(max_retries=-1), dict(backoff_base=0)):
        with pytest.raises(ValueError):
            tadm.AdmissionController(2, **kwargs)
