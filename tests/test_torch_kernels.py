"""Each kernel wrapper of the port, on CPU tensors (its plain torch version),
equals the reference's Pallas kernel in interpret mode and its ``ref.py``
oracle, with a tolerance of 0.

States are random window-count states made from a seed with numpy
(occupancy bitmaps per GPU → ``base = occ · W[midx]ᵀ``, ``free``, ``f``) and
handed to both packages.  One replica of the port per ``(fill, demand
class)`` pair; the reference decides each replica on its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.core.policy import resolve as jresolve
from repro.kernels.fragscore import fragscore as jk
from repro.kernels.fragscore import ref as jref
from repro.sim import batched as jb

from repro_torch.core import mig as tmig
from repro_torch.core.policy import resolve as tresolve
from repro_torch.kernels.fragscore import fragscore as tk
from repro_torch.sim import batched as tb
from repro_torch.sim.simulator import SimConfig


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
FUSABLE = ("mfi", "ff", "bf-bi", "wf-bi")
FILLS = (0.0, 0.45, 0.9)


def twin_specs(text):
    return tmig.ClusterSpec.parse(text), jmig.ClusterSpec.parse(text)


def random_states(spec, seed, metric="blocked"):
    """``len(FILLS) · P`` replicas of ``spec``: numpy ``base, free, f, pid``."""
    rng = np.random.default_rng(seed)
    t = tb._spec_tables_np(spec)
    midx = spec.model_index
    reps = [(fill, pid) for fill in FILLS for pid in range(tmig.NUM_PROFILES)]
    occ = np.zeros((len(reps), spec.num_gpus, spec.num_mem_slices), np.int32)
    for r, (fill, _) in enumerate(reps):
        for g in range(spec.num_gpus):
            s = spec.models[midx[g]].num_mem_slices
            occ[r, g, :s] = rng.random(s) < fill
    base = np.einsum("rms,mns->rmn", occ.astype(np.float32), t["W"][midx])
    free = (t["slices"][midx][None] - occ.sum(axis=2)).astype(np.int32)
    f = tb._frag_from_base(
        torch.as_tensor(base), torch.as_tensor(free), metric, torch.as_tensor(t["V"][midx])
    ).numpy()
    pid = np.array([p for _, p in reps], np.int32)
    return occ, base, free, f, pid


def port_operands(spec, base, free, f, pid):
    t = tb.spec_tables(spec, "cpu")
    state = [torch.as_tensor(x) for x in (base, free, f, pid)]
    return state + [torch.as_tensor(spec.model_index)], t


@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_fragscore_equals_pallas_and_oracle(name, metric):
    model, jmodel = tmig.DEVICE_MODELS[name], jmig.DEVICE_MODELS[name]
    rng = np.random.default_rng(len(name))
    occ = (rng.random((73, model.num_mem_slices)) < 0.4).astype(np.int32)
    w = model.placement_masks.astype(np.float32)
    v = model.placement_mem.astype(np.float32)
    got = tk.fragscore(torch.as_tensor(occ), torch.as_tensor(w), torch.as_tensor(v),
                       metric=metric).numpy()
    assert got.dtype == np.float32
    want = np.asarray(jk.fragscore(jnp.asarray(occ), jnp.asarray(w), jnp.asarray(v),
                                   metric=metric, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jref.fragscore_ref(
        jnp.asarray(occ), metric, jmodel.placement_masks, jmodel.placement_mem)))


@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("text", [f"{n}:5" for n in MODEL_NAMES]
                         + ["a100-80:2,a100-40:2,h100-96:2,h100-80:2"])
def test_delta_from_base_equals_pallas(text, metric):
    spec, jspec = twin_specs(text)
    _, base, free, f, pid = random_states(spec, 7, metric)
    (b, fr, ff, p, midx), t = port_operands(spec, base, free, f, pid)
    got = tk.delta_from_base(b, fr, ff, p, midx, t.V, t.maskwin, t.profile_mem,
                             metric=metric).numpy()
    # the engine's own plain lowering (the blocked split) agrees as well
    mi, pi = midx.long()[None, :], p.long()[:, None]
    lowered = tb._delta_from_base(
        b, fr, metric, t.V[midx.long()], t.maskwin[mi, pi], t.maskpos[mi, pi],
        t.profile_mem[mi, pi], ff,
    ).numpy()
    np.testing.assert_array_equal(got, lowered)
    delta_fn = jb.make_delta_fn(jspec, metric, interpret=True)
    for r in range(len(pid)):
        want = np.asarray(delta_fn(jnp.asarray(base[r]), jnp.asarray(free[r]),
                                   jnp.asarray(f[r]), int(pid[r])))
        np.testing.assert_array_equal(got[r], want)


def _select_case(text, metric, policies, seed):
    spec, jspec = twin_specs(text)
    _, base, free, f, pid = random_states(spec, seed, metric)
    (b, fr, ff, p, midx), t = port_operands(spec, base, free, f, pid)
    for policy in policies:
        keys = tb._effective_keys(tresolve(policy))
        gpu, col, ok = tk.select_from_base(
            b, fr, ff, p, midx, t.V, t.maskwin, t.profile_rows, t.profile_valid,
            t.profile_anchors, t.profile_mem, keys=keys, metric=metric,
        )
        select_fn = jb.make_select_fn(jspec, jresolve(policy), metric=metric, interpret=True)
        for r in range(len(pid)):
            want = select_fn(jnp.asarray(base[r]), jnp.asarray(free[r]),
                             jnp.asarray(f[r]), int(pid[r]))
            assert (int(gpu[r]), int(col[r]), bool(ok[r])) == tuple(
                int(x) for x in want[:2]) + (bool(want[2]),), (policy, r)


@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_select_from_base_equals_pallas(name, metric):
    _select_case(f"{name}:9", metric, FUSABLE, seed=len(name))


@pytest.mark.parametrize("metric", ["blocked", "partial"])
def test_select_from_base_mixed_fleet_equals_pallas(metric):
    _select_case("a100-80:2,h200-141:2,a100-40:2", metric, ("mfi", "bf-bi"), seed=11)


def test_select_from_base_equals_oracle_and_lowering():
    """The plain select equals the reference's jnp lowering ``_select`` on
    a four-model fleet."""
    spec, jspec = twin_specs("a100-80:3,a100-40:3,h100-96:2,h100-80:2")
    _, base, free, f, pid = random_states(spec, 5)
    (b, fr, ff, p, midx), t = port_operands(spec, base, free, f, pid)
    jt = jb.spec_tables(jspec)
    jmidx = jnp.asarray(jspec.model_index)
    for policy in FUSABLE:
        gpu, col, ok = tk.select_from_base(
            b, fr, ff, p, midx, t.V, t.maskwin, t.profile_rows, t.profile_valid,
            t.profile_anchors, t.profile_mem, keys=tb._effective_keys(tresolve(policy)),
        )
        for r in range(len(pid)):
            want = jb._select(jresolve(policy), jnp.asarray(base[r]), jnp.asarray(free[r]),
                              jnp.asarray(f[r]), "blocked", jt, jmidx, jt.V[jmidx],
                              int(pid[r]), jnp.int32(0))
            assert (int(gpu[r]), int(col[r]), bool(ok[r])) == (
                int(want[0]), int(want[1]), bool(want[2])), (policy, r)


def test_multi_tile_fleet():
    """M = 516 > the reference kernels' 512-row tile: the reference merges
    tiles, the port's plain versions see one table; all three agree."""
    spec, jspec = twin_specs("a100-80:516")
    rng = np.random.default_rng(21)
    occ = (rng.random((2, 516, 8)) < 0.6).astype(np.int32)
    t = tb._spec_tables_np(spec)
    base = np.einsum("rms,ns->rmn", occ.astype(np.float32), t["W"][0])
    free = (8 - occ.sum(axis=2)).astype(np.int32)
    f = tk.fragscore(torch.as_tensor(occ.reshape(-1, 8)), torch.as_tensor(t["W"][0]),
                     torch.as_tensor(t["V"][0])).numpy().reshape(2, 516)
    w, v = jnp.asarray(t["W"][0]), jnp.asarray(t["V"][0])
    for r in range(2):
        np.testing.assert_array_equal(
            f[r], np.asarray(jk.fragscore(jnp.asarray(occ[r]), w, v, interpret=True)))
    pid = np.array([3, 5], np.int32)
    (b, fr, ff, p, midx), tt = port_operands(spec, base, free, f, pid)
    got_d = tk.delta_from_base(b, fr, ff, p, midx, tt.V, tt.maskwin, tt.profile_mem).numpy()
    gpu, col, ok = tk.select_from_base(
        b, fr, ff, p, midx, tt.V, tt.maskwin, tt.profile_rows, tt.profile_valid,
        tt.profile_anchors, tt.profile_mem, keys=tb._effective_keys(tresolve("mfi")),
    )
    delta_fn = jb.make_delta_fn(jspec, interpret=True)
    select_fn = jb.make_select_fn(jspec, jresolve("mfi"), interpret=True)
    for r in range(2):
        args = (jnp.asarray(base[r]), jnp.asarray(free[r]), jnp.asarray(f[r]), int(pid[r]))
        np.testing.assert_array_equal(got_d[r], np.asarray(delta_fn(*args)))
        want = select_fn(*args)
        assert (int(gpu[r]), int(col[r]), bool(ok[r])) == (
            int(want[0]), int(want[1]), bool(want[2]))


def test_all_infeasible_resolves_to_zero():
    spec = tmig.ClusterSpec.parse("a100-40:4")  # the 80 GiB class has no anchor
    _, base, free, f, pid = random_states(spec, 1)
    (b, fr, ff, p, midx), t = port_operands(spec, base, free, f, np.zeros_like(pid))
    gpu, col, ok = tk.select_from_base(
        b, fr, ff, p, midx, t.V, t.maskwin, t.profile_rows, t.profile_valid,
        t.profile_anchors, t.profile_mem, keys=tb._effective_keys(tresolve("mfi")),
    )
    assert not ok.any() and not gpu.any() and not col.any()


def test_wrappers_validate_and_count_only_launches():
    """On the CPU the wrappers compute their plain versions and count no
    launch; a bad metric and an unfusable key raise."""
    counters = (tk.fragscore, tk.delta_from_base, tk.select_from_base)
    before = [fn.launches for fn in counters]
    cfg = SimConfig(num_gpus=3, offered_load=1.0, seed=1)
    tb.run_batched("mfi", cfg, runs=2, use_kernel=True, device="cpu")
    assert [fn.launches for fn in counters] == before
    occ = torch.zeros((2, 8), dtype=torch.int32)
    w = torch.as_tensor(tmig.A100_80GB.placement_masks, dtype=torch.float32)
    v = torch.as_tensor(tmig.A100_80GB.placement_mem, dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown metric"):
        tk.fragscore(occ, w, v, metric="bogus")
    with pytest.raises(ValueError, match="not argmin-fusable"):
        tk.pack_keys((("rr-distance", 1.0),))
    assert tk.pack_keys((("frag-delta", 1.0), ("gpu", 1.0), ("anchor", -1.0))) == (
        0 | (2 << 3) | ((3 | 4) << 6))
