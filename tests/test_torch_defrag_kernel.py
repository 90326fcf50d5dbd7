"""The ``migrate_refine`` kernel's wrapper, on CPU tensors (its plain
torch version), against the reference's Pallas ``migrate_refine`` in
interpret mode through its dispatch and host merge (tolerance 0), and the
plain version's conventions for masked entries.

States are random occupancy fills made from a seed with numpy, one
replica per fill, with random victims (GPU, demand class and a patched
row of the victim's model).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_jit

from repro.core import mig as jmig
from repro.core.policy import resolve as jresolve
from repro.sim import batched as jb

from repro_torch.core import mig as tmig
from repro_torch.core.policy import PolicySpec
from repro_torch.core.policy import resolve as tresolve
from repro_torch.kernels.fragscore import fragscore as tk
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


MODEL_NAMES = sorted({m.name for m in tmig.DEVICE_MODELS.values()})
MIXED = "a100-80:3,a100-40:3"
H200_MIX = "a100-80:2,h200-141:2,a100-40:1"
FILLS = (0.0, 0.5, 0.95)
VICTIMS = 9


def random_occ(spec, rng, fill, rows=None):
    """Occupancy bitmaps of ``spec``'s GPUs (or of the GPUs ``rows``)."""
    midx = spec.model_index if rows is None else spec.model_index[rows]
    occ = np.zeros((len(midx), spec.num_mem_slices), np.int32)
    for i, k in enumerate(midx):
        s = spec.models[k].num_mem_slices
        occ[i, :s] = rng.random(s) < fill
    return occ


def window_state(spec, occ, rows, metric):
    """``base, free, f`` of occupancy rows on the GPUs ``rows`` (numpy)."""
    t = tb._spec_tables_np(spec)
    midx = spec.model_index[rows]
    base = np.einsum("...s,...ns->...n", occ.astype(np.float32), t["W"][midx])
    free = (t["slices"][midx] - occ.sum(axis=-1)).astype(np.int32)
    f = tb._frag_from_base(torch.as_tensor(base), torch.as_tensor(free), metric,
                           torch.as_tensor(t["V"][midx])).numpy()
    return base, free, f


def kernel_case(text, metric, seed):
    """One replica per fill: the fleet state and ``VICTIMS`` random victims
    (GPU, class and a patched row of the victim's model)."""
    spec = tmig.ClusterSpec.parse(text)
    rng = np.random.default_rng(seed)
    gpus = np.arange(spec.num_gpus)
    state, vic = [], []
    for fill in FILLS:
        state.append(window_state(spec, random_occ(spec, rng, fill), gpus, metric))
        rg = rng.integers(0, spec.num_gpus, VICTIMS)
        rp = rng.integers(0, tmig.NUM_PROFILES, VICTIMS).astype(np.int32)
        occ2 = random_occ(spec, rng, fill, rows=rg)
        vic.append(window_state(spec, occ2, rg, metric)
                   + (rg.astype(np.int32), rp, spec.model_index[rg].astype(np.int32)))
    stack = lambda xs: [np.stack(a) for a in zip(*xs)]  # noqa: E731
    return spec, stack(state), stack(vic)


def port_migrate_refine(spec, state, vic, keys, metric):
    t = tb.spec_tables(spec, "cpu")
    args = [torch.as_tensor(a) for a in state + vic]
    return [o.numpy() for o in tk.migrate_refine(
        *args, torch.as_tensor(spec.model_index), t.V, t.maskwin, t.profile_rows,
        t.profile_valid, t.profile_anchors, t.profile_mem, keys=keys, metric=metric)]


@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("text", [f"{n}:6" for n in MODEL_NAMES] + [MIXED, H200_MIX])
def test_migrate_refine_equals_pallas(text, metric):
    """The plain version equals the reference's Pallas ``migrate_refine``
    (interpret mode, through its dispatch and host merge) for each
    replica: every flag, gpu and column, and the keys wherever ``ok``
    holds (the reference leaves a masked pass-0 key row unspecified; the
    port fixes it to ``BIG``, pinned by the next test)."""
    spec, state, vic = kernel_case(text, metric, seed=len(text) + len(metric))
    pspec = tresolve("mfi-defrag")
    got = port_migrate_refine(spec, state, vic, tb._effective_keys(pspec), metric)
    migrate_fn = reference_jit.jit(jb.make_migrate_fn(
        jmig.ClusterSpec.parse(text), jresolve("mfi-defrag"), metric=metric, interpret=True))
    names = ("g1", "ok1", "a1", "k1", "g2", "ok2", "a2", "k2", "ap", "okp", "kp")
    for r in range(len(FILLS)):
        want = migrate_fn(*(jnp.asarray(a[r]) for a in state + vic))
        out = dict(zip(names, zip(got, want)))
        for name, (g, w) in out.items():
            g, w = g[r], np.asarray(w)
            assert g.dtype == w.dtype, name
            if name in ("k1", "k2"):  # keys where the row exists
                ok = out["ok" + name[1]][0][r]
                g, w = g[ok], w[ok]
            np.testing.assert_array_equal(g, w, err_msg=f"{text}/{metric}/{FILLS[r]}/{name}")


def test_migrate_refine_masked_conventions():
    """A fully packed fleet: no row is feasible in either pass.  Pass 0
    gives gpu = column = 0 and keys ``BIG``; pass 1 gives column 0 and the
    unmasked keys of column 0, as the engine's plain search does."""
    spec = tmig.ClusterSpec.parse("a100-80:4")
    full = np.ones((1, 4, 8), np.int32)
    base, free, f = window_state(spec, full, np.arange(4), "blocked")
    rg = np.array([[0, 3]], np.int32)
    rp = np.array([[2, 5]], np.int32)
    vic = list(window_state(spec, full[:, :2], rg[0], "blocked")) + [rg, rp, np.zeros_like(rg)]
    g1, ok1, a1, k1, g2, ok2, a2, k2, ap, okp, kp = port_migrate_refine(
        spec, [base, free, f], vic, tb._effective_keys(tresolve("mfi-defrag")), "blocked")
    assert not ok1.any() and not ok2.any() and not okp.any()
    for x in (g1, a1, g2, a2, ap):
        assert not x.any()
    assert (k1 == tb.BIG).all() and (k2 == tb.BIG).all()
    t = tb.spec_tables(spec, "cpu")
    anchors0 = t.profile_anchors[0, torch.as_tensor(rp[0]).long(), 0].numpy()
    np.testing.assert_array_equal(kp[0, :, 1], rg[0])          # the gpu key
    np.testing.assert_array_equal(kp[0, :, 2], anchors0)       # column 0's anchor


def test_migrate_refine_keys_with_free_slices_and_sign():
    """A defrag spec with bf-bi's keys (``free-slices`` and a negated
    ``anchor``) through the plain version equals the reference."""
    spec, state, vic = kernel_case("a100-80:5,h100-96:3", "blocked", seed=5)
    keys = ("free-slices", "gpu", "-anchor")
    tspec = PolicySpec(name="bf-bi-defrag", keys=keys, defrag=True)
    from repro.core.policy import PolicySpec as JPolicySpec

    jspec = JPolicySpec(name="bf-bi-defrag", keys=keys, defrag=True)
    got = port_migrate_refine(spec, state, vic, tb._effective_keys(tspec), "blocked")
    migrate_fn = reference_jit.jit(jb.make_migrate_fn(jmig.ClusterSpec.parse("a100-80:5,h100-96:3"),
                                                      jspec, interpret=True))
    for r in range(len(FILLS)):
        want = migrate_fn(*(jnp.asarray(a[r]) for a in state + vic))
        ok = {3: got[1][r], 7: got[5][r]}  # k1, k2 where the row exists
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g[r], np.asarray(w)
            if i in ok:
                g, w = g[ok[i]], w[ok[i]]
            np.testing.assert_array_equal(g, w)


def test_migrate_refine_wrapper_counts_no_cpu_launch():
    spec, state, vic = kernel_case("a100-80:4", "blocked", seed=1)
    before = tk.migrate_refine.launches
    port_migrate_refine(spec, state, vic, tb._effective_keys(tresolve("mfi-defrag")), "blocked")
    assert tk.migrate_refine.launches == before
