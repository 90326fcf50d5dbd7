"""The port's defrag migrate search (tolerance 0): the factored search,
plain and through the kernel dispatch, against the dense oracle, and the
single-decision defrag search of ``policy_select_full`` against the
reference package's (the textbook scenario and 40 random clusters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_jit

from repro.core import mig as jmig
from repro.sim import batched as jb

from repro_torch.core import mig as tmig
from repro_torch.core.policy import resolve as tresolve
from repro_torch.sim import batched as tb


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
H200_MIX = "a100-80:2,h200-141:2,a100-40:1"


def window_state(spec, occ, rows, metric):
    """``base, free, f`` of occupancy rows on the GPUs ``rows`` (numpy)."""
    t = tb._spec_tables_np(spec)
    midx = spec.model_index[rows]
    base = np.einsum("...s,...ns->...n", occ.astype(np.float32), t["W"][midx])
    free = (t["slices"][midx] - occ.sum(axis=-1)).astype(np.int32)
    f = tb._frag_from_base(torch.as_tensor(base), torch.as_tensor(free), metric,
                           torch.as_tensor(t["V"][midx])).numpy()
    return base, free, f


# ---------------------------------------------------------------------------
# The factored migrate search: dense oracle, kernel dispatch and reference
# ---------------------------------------------------------------------------

RESULT_FIELDS = ("gpu", "aidx", "vic_row", "vic_col", "vic_gpu", "vic_anchor", "vic_pid",
                 "new_gpu", "new_aidx", "new_anchor", "old_mask", "old_mwin", "new_mask",
                 "new_mwin")


def random_cluster(rng, text=None, num_gpus=None, density=0.7):
    """A random reference cluster state and its ``(gpu, pid, anchor)``
    workload list."""
    cl = (jmig.ClusterState(num_gpus) if text is None
          else jmig.ClusterState(spec=jmig.ClusterSpec.parse(text)))
    wid = 0
    for g in range(cl.num_gpus):
        for pid in rng.permutation(jmig.NUM_PROFILES):
            if rng.random() < density:
                anchors = cl.gpus[g].feasible_anchors(int(pid))
                if anchors:
                    cl.allocate(wid, int(pid), g, int(rng.choice(anchors)))
                    wid += 1
    workloads = [(g.gpu_id, a.profile_id, a.anchor)
                 for g in cl.gpus for a in g.allocations.values()]
    return cl, workloads


def search_args(cl, text, workloads, pid, ring_shape, rng, metric):
    """The workloads scattered over a random ring layout, and the window
    state, as numpy arrays of one replica (``R = 1``)."""
    spec = tmig.ClusterSpec.parse(text) if text else tmig.ClusterSpec.homogeneous(
        tmig.A100_80GB, cl.num_gpus)
    occ = np.asarray(cl.occupancy_matrix(), np.int32)
    base, free, f = window_state(spec, occ[None], np.arange(spec.num_gpus), metric)
    rows, cols = ring_shape
    s = spec.num_mem_slices
    ring = dict(ring_gpu=np.zeros((1, rows, cols), np.int32),
                ring_mask=np.zeros((1, rows, cols, s), np.int32),
                ring_pid=np.zeros((1, rows, cols), np.int32),
                ring_aidx=np.zeros((1, rows, cols), np.int32))
    for slot, (g, p, anchor) in zip(rng.choice(rows * cols, len(workloads), replace=False),
                                    workloads):
        prof = spec.model_of(int(g)).profiles[int(p)]
        r, c = divmod(int(slot), cols)
        ring["ring_gpu"][0, r, c] = g
        ring["ring_mask"][0, r, c, anchor:anchor + prof.mem] = 1
        ring["ring_pid"][0, r, c] = p
        ring["ring_aidx"][0, r, c] = prof.anchors.index(int(anchor))
    return spec, dict(base=base, free=free, f=f, **ring)


@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("text", [None, MIXED, H200_MIX], ids=["homog", "mixed", "h200"])
def test_factored_search_equals_dense(text, metric):
    """On random clusters with oversized rings (mostly dead slots, so the
    live-entry compaction acts): the factored search, plain and through
    the kernel dispatch, equals the dense search field by field."""
    rng = np.random.default_rng(29 + len(metric))
    pspec = tresolve("mfi-defrag")
    migrations = 0
    for trial in range(25):
        cl, workloads = random_cluster(
            rng, text, num_gpus=int(rng.integers(2, 6)) if text is None else None,
            density=rng.random() * 1.2)
        if not workloads:
            continue
        pid = int(rng.integers(0, tmig.NUM_PROFILES))
        rows = int(rng.integers(1, 40))
        cols = -(-len(workloads) // rows) + int(rng.integers(0, 4))
        spec, a = search_args(cl, text, workloads, pid, (rows, cols), rng, metric)
        t = tb.spec_tables(spec, "cpu")
        midx = torch.as_tensor(spec.model_index).long()
        common = dict(spec=pspec, metric=metric, tables=t, midx=midx, vg=t.V[midx],
                      **{k: torch.as_tensor(v) for k, v in a.items()},
                      pid_c=torch.tensor([pid], dtype=torch.int32),
                      cursor=torch.zeros(1, dtype=torch.int32),
                      want=torch.tensor([True]))
        want = tb._migrate_search_dense(**common)
        for got in (tb._migrate_search(**common),
                    tb._migrate_search(**common, migrate_fn=tb.make_migrate_fn(
                        spec, pspec, metric, "cpu"))):
            assert bool(got.mig[0]) == bool(want.mig[0]), trial
            if bool(want.mig[0]):
                for field in RESULT_FIELDS:
                    assert torch.equal(getattr(got, field), getattr(want, field)), (
                        f"trial {trial}: {field}")
        migrations += bool(want.mig[0])
    assert migrations >= 2  # the fuzz exercised the search


def test_search_gated_by_want():
    rng = np.random.default_rng(5)
    cl, workloads = random_cluster(rng, num_gpus=3, density=1.2)
    spec, a = search_args(cl, None, workloads, 0, (4, len(workloads)), rng, "blocked")
    t = tb.spec_tables(spec, "cpu")
    midx = torch.as_tensor(spec.model_index).long()
    res = tb._migrate_search(
        tresolve("mfi-defrag"), "blocked", t, midx, t.V[midx],
        *(torch.as_tensor(a[k]) for k in ("base", "free", "f", "ring_gpu", "ring_mask",
                                          "ring_pid", "ring_aidx")),
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        want=torch.tensor([False]))
    assert not bool(res.mig[0])


# ---------------------------------------------------------------------------
# The single-decision defrag search
# ---------------------------------------------------------------------------

PID = {name: i for i, name in enumerate(jmig.PROFILE_NAMES)}

#: the reference's decision compiled as one program per cluster shape and
#: workload list; called op by op it compiles each primitive anew for every
#: new shape of the random clusters, which costs twice as long
reference_select_full = reference_jit.jit(
    jb.policy_select_full,
    static_argnames=("policy", "metric", "spec", "cursor", "workloads"))


def assert_decisions_equal(occ, pid, text, workloads):
    spec = tmig.ClusterSpec.parse(text) if text else None
    jspec = jmig.ClusterSpec.parse(text) if text else None
    got = tb.policy_select_full(occ, pid, "mfi-defrag", spec=spec, workloads=workloads,
                                device="cpu")
    want = reference_select_full(jnp.asarray(occ), jnp.int32(pid), "mfi-defrag",
                                 spec=jspec, workloads=tuple(map(tuple, workloads)))
    for name in tb.PolicyDecision._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.numpy().dtype == w.dtype and g.item() == w.item(), name
    return got


def test_textbook_migration_equals_reference():
    """A misplaced 1g.10gb blocks a 4g.40gb: both packages migrate the
    same victim to the same place and admit the request."""
    cl = jmig.ClusterState(2)
    cl.allocate(1, PID["1g.10gb"], 0, 1)
    cl.allocate(2, PID["4g.40gb"], 1, 0)
    cl.allocate(3, PID["2g.20gb"], 1, 4)
    workloads = [(g.gpu_id, a.profile_id, a.anchor)
                 for g in cl.gpus for a in g.allocations.values()]
    d = assert_decisions_equal(np.asarray(cl.occupancy_matrix(), np.int32),
                               PID["4g.40gb"], None, workloads)
    assert bool(d.ok) and bool(d.mig)
    assert (int(d.vic_gpu), int(d.vic_anchor)) == (0, 1)


def test_random_single_decisions_equal_reference():
    """40 random homogeneous and mixed clusters: all eight decision fields,
    the migration included, equal the reference's."""
    rng = np.random.default_rng(17)
    migrations = 0
    for trial in range(40):
        text = None if trial % 2 == 0 else MIXED
        cl, workloads = random_cluster(
            rng, text, num_gpus=int(rng.integers(1, 6)) if text is None else None,
            density=rng.random() * 1.2)
        pid = int(rng.integers(0, tmig.NUM_PROFILES))
        d = assert_decisions_equal(np.asarray(cl.occupancy_matrix(), np.int32), pid, text,
                                   workloads)
        migrations += bool(d.mig)
    assert migrations >= 2
