"""The port's tables, registry, load model and event streams equal the
reference package's (tolerance 0), and the port imports neither JAX nor
the reference package.

Both packages build their own objects from the same description (a model
name, a fleet string, a seed); the tests compare what comes out.
"""

import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import cluster as jcluster
from repro.core import mig as jmig
from repro.core import policy as jpolicy
from repro.sim import batched as jb
from repro.sim import distributions as jdist
from repro.sim import simulator as jsim

from repro_torch.core import cluster as tcluster
from repro_torch.core import mig as tmig
from repro_torch.core import policy as tpolicy
from repro_torch.sim import batched as tb
from repro_torch.sim import distributions as tdist
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

#: every registered device model once, by canonical name
MODEL_NAMES = sorted({m.name for m in tmig.DEVICE_MODELS.values()})

#: fleets as the reference's tests build them (tests/test_engine_core.py)
FLEETS = {
    "mixed": "a100-80:3,a100-40:3",
    "four": "a100-80:2,a100-40:2,h100-96:2,h100-80:2",
    "h200": "a100-80:2,h200-141:2,a100-40:1",
    "paper-mixed": "a100-80:30,a100-40:30,h100-96:20,h100-80:20",
}

#: the reference's golden configurations, as SimConfig keyword arguments
#: (``fleet`` names an entry of FLEETS), with their replica counts
GOLDEN_CONFIGS = [
    (dict(num_gpus=5, offered_load=1.1, seed=7), 3),
    (dict(fleet="mixed", offered_load=1.0, seed=9), 3),
    (dict(num_gpus=6, offered_load=0.9, seed=12), 4),
    (dict(fleet="mixed", offered_load=0.9, seed=12), 4),
    (dict(fleet="four", offered_load=0.85, seed=3), 4),
    (dict(num_gpus=100, offered_load=1.0, seed=0), 8),
]


def twin_configs(fleet=None, **kw):
    """(port SimConfig, reference SimConfig) of one description."""
    tkw, jkw = dict(kw), dict(kw)
    if fleet is not None:
        tkw["cluster_spec"] = tmig.ClusterSpec.parse(FLEETS[fleet])
        jkw["cluster_spec"] = jmig.ClusterSpec.parse(FLEETS[fleet])
    return tsim.SimConfig(**tkw), jsim.SimConfig(**jkw)


def assert_same_array(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# core/mig.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_device_model_tables_equal(name):
    t, j = tmig.DEVICE_MODELS[name], jmig.DEVICE_MODELS[name]
    assert (t.name, t.slice_gib, t.num_mem_slices, t.num_sm_slices) == (
        j.name, j.slice_gib, j.num_mem_slices, j.num_sm_slices)
    assert [dataclasses.astuple(p) for p in t.profiles] == [
        dataclasses.astuple(p) for p in j.profiles]
    for attr in ("placement_profile_id", "placement_anchor", "placement_masks",
                 "placement_mem", "profile_mem", "profile_compute"):
        assert_same_array(getattr(t, attr), getattr(j, attr))
    assert (t.num_placements, t.max_anchors) == (j.num_placements, j.max_anchors)
    for pid in range(tmig.NUM_PROFILES):
        assert t.profile_placement_rows(pid) == j.profile_placement_rows(pid)
        assert t.placeable(pid) == j.placeable(pid)


def test_profiles_registry_and_fault_model_equal():
    assert [dataclasses.astuple(p) for p in tmig.PROFILES] == [
        dataclasses.astuple(p) for p in jmig.PROFILES]
    assert tmig.PROFILE_NAMES == jmig.PROFILE_NAMES
    assert tmig.NUM_PROFILES == jmig.NUM_PROFILES
    assert {k: v.name for k, v in tmig.DEVICE_MODELS.items()} == {
        k: v.name for k, v in jmig.DEVICE_MODELS.items()}
    assert_same_array(tmig.PROFILE_MEM, jmig.PROFILE_MEM)
    kw = dict(mtbf=60.0, mttr=10.0, per_model=(("a100-40gb", (30.0, 5.0)),))
    t, j = tmig.FaultModel(**kw), jmig.FaultModel(**kw)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    for name in MODEL_NAMES:
        assert t.rates_for(name) == j.rates_for(name)
    assert [t.backoff(k) for k in range(5)] == [j.backoff(k) for k in range(5)]
    with pytest.raises(ValueError, match="MTBF"):
        tmig.FaultModel(mtbf=0.0)


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_cluster_spec_equal(fleet):
    t, j = tmig.ClusterSpec.parse(FLEETS[fleet]), jmig.ClusterSpec.parse(FLEETS[fleet])
    assert [m.name for m in t.models] == [m.name for m in j.models]
    assert_same_array(t.model_index, j.model_index)
    assert (t.num_gpus, t.num_mem_slices, t.total_mem_slices, t.is_homogeneous) == (
        j.num_gpus, j.num_mem_slices, j.total_mem_slices, j.is_homogeneous)
    for (tm, tr), (jm, jr) in zip(t.model_groups(), j.model_groups()):
        assert tm.name == jm.name
        np.testing.assert_array_equal(tr, jr)


# ---------------------------------------------------------------------------
# core/policy.py
# ---------------------------------------------------------------------------

BUILT_INS = ("bf-bi", "ff", "mfi", "mfi-defrag", "mfi-queued", "rr", "wf-bi")


def test_registries_hold_equal_built_in_specs():
    assert tpolicy.list_policies() == BUILT_INS
    for name in BUILT_INS:
        t, j = tpolicy.resolve(name), jpolicy.resolve(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        for prop in ("requires_delta_f", "stateful_cursor", "argmin_fusable",
                     "fused_argmin"):
            assert getattr(t, prop) == getattr(j, prop), (name, prop)
        assert tpolicy.queue_order(t) == jpolicy.queue_order(j)
        for engine in tpolicy.ENGINES:
            assert t.supports(engine) == j.supports(engine)
    for const in ("ENGINES", "KEY_VOCABULARY", "REQUEST_KEYS", "DEFAULT_QUEUE_ORDER",
                  "FEASIBILITY_FILTERS", "KERNEL_LOWERINGS", "FUSABLE_KEYS"):
        assert getattr(tpolicy, const) == getattr(jpolicy, const), const
    assert tb.POLICIES == BUILT_INS


@pytest.mark.parametrize("kw", [
    dict(name="x", keys=("bogus",)),
    dict(name="x", keys=("rr-distance",), defrag=True),
    dict(name="x", keys=("rr-distance", "gpu"), kernel_lowering="fused"),
    dict(name="x", keys=("gpu",), engines=("tpu",)),
])
def test_invalid_specs_raise_alike(kw):
    with pytest.raises(ValueError) as t_err:
        tpolicy.PolicySpec(**kw)
    with pytest.raises(ValueError) as j_err:
        jpolicy.PolicySpec(**kw)
    assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# sim/distributions.py and sim/simulator.py
# ---------------------------------------------------------------------------


def test_distributions_equal():
    assert sorted(tdist.DISTRIBUTIONS) == sorted(jdist.DISTRIBUTIONS)
    for name in tdist.DISTRIBUTIONS:
        assert_same_array(tdist.DISTRIBUTIONS[name], jdist.DISTRIBUTIONS[name])
        assert tdist.mean_mem_demand(name) == jdist.mean_mem_demand(name)
        assert_same_array(
            tdist.sample_profiles(name, 50, np.random.default_rng(3)),
            jdist.sample_profiles(name, 50, np.random.default_rng(3)),
        )
    mix = {"a100-80": "skew-big", "a100-40gb": "skew-small"}
    for fleet in ("mixed", "four"):
        assert_same_array(
            tdist.resolve_probs("uniform", tmig.ClusterSpec.parse(FLEETS[fleet]), mix),
            jdist.resolve_probs("uniform", jmig.ClusterSpec.parse(FLEETS[fleet]), mix),
        )


@pytest.mark.parametrize("kw", [
    dict(num_gpus=6, offered_load=0.9),
    dict(num_gpus=100, offered_load=1.0, distribution="bimodal"),
    dict(fleet="mixed", offered_load=1.0),
    dict(fleet="four", offered_load=0.85, model_distributions={"h100-96": "skew-big"}),
    dict(fleet="h200", offered_load=1.2, warmup_horizons=1, measure_horizons=1),
])
def test_sim_config_and_steady_params_equal(kw):
    t, j = twin_configs(**kw)
    t_fields = [(f.name, f.default) for f in dataclasses.fields(t)]
    j_fields = [(f.name, f.default) for f in dataclasses.fields(j)]
    assert t_fields == j_fields
    assert tsim.steady_params(t) == jsim.steady_params(j)
    assert_same_array(tsim.request_probs(t), jsim.request_probs(j))
    assert tsim.SAMPLE_EVERY == jsim.SAMPLE_EVERY


# ---------------------------------------------------------------------------
# core/cluster.py and the engine's stacked tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_device_tables_and_frag_scores_equal(name):
    t_model, j_model = tmig.DEVICE_MODELS[name], jmig.DEVICE_MODELS[name]
    for a in (None, 12):
        for got, want in zip(tcluster._np_profile_tables(t_model, a),
                             jcluster._np_profile_tables(j_model, a)):
            assert_same_array(got, want)
    tt = tcluster.tables_for(t_model, device="cpu")
    jt = jax.device_get(jcluster.tables_for(j_model))
    for got, want in zip(tt, jt):
        assert_same_array(got.numpy(), want)
    rng = np.random.default_rng(len(name))
    occ = (rng.random((37, t_model.num_mem_slices)) < 0.4).astype(np.int32)
    for metric in ("blocked", "partial"):
        assert_same_array(
            tcluster.frag_scores(torch.as_tensor(occ), metric, tt).numpy(),
            jax.device_get(jcluster.frag_scores(occ, metric, jcluster.tables_for(j_model))),
        )


@pytest.mark.parametrize("fleet", MODEL_NAMES + sorted(FLEETS))
def test_spec_tables_equal(fleet):
    text = FLEETS.get(fleet, f"{fleet}:4")
    t = tb.spec_tables(tmig.ClusterSpec.parse(text), "cpu")
    j = jax.device_get(jb.spec_tables(jmig.ClusterSpec.parse(text)))._asdict()
    for name in tb.SpecTables._fields:
        assert_same_array(getattr(t, name).numpy(), j[name])
    carried = tb.tables_from_numpy(j, "cpu")
    for got, want in zip(carried, t):
        assert torch.equal(got, want)


def test_spec_tables_refuse_windows_the_migrate_kernel_cannot_sum():
    """The migrate kernel sums windows as bit sets of their sizes, so the
    tables carry only window sizes of 0 to 32 whole slices."""
    wide = dataclasses.replace(
        tmig.A100_80GB, name="wide", num_mem_slices=40,
        profiles=tmig.PROFILES[:-1] + (tmig.MIGProfile("33s", compute=1, mem=33, anchors=(0,)),))
    with pytest.raises(ValueError, match="whole slices"):
        tb.spec_tables(tmig.ClusterSpec.homogeneous(wide, 2), "cpu")


# ---------------------------------------------------------------------------
# Host presampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,runs", GOLDEN_CONFIGS)
def test_presampled_streams_are_byte_identical(kw, runs):
    t_cfg, j_cfg = twin_configs(**kw)
    t_ev, t_meta, t_rows, t_cols = tb.presample_arrivals(t_cfg, runs)
    j_ev, j_meta, j_rows, j_cols = jb.presample_arrivals(j_cfg, runs)
    assert (t_rows, t_cols) == (j_rows, j_cols)
    for name in tb.EventStream._fields:
        got, want = getattr(t_ev, name), getattr(j_ev, name)
        assert (got is None) == (want is None), name
        if want is None:  # a field of the queued protocol
            continue
        assert_same_array(got, want)
        assert got.tobytes() == np.ascontiguousarray(want).tobytes()
    for got, want in zip(t_meta, j_meta):
        assert_same_array(got, want)


def test_non_steady_protocols_are_not_ported_yet():
    """None is left: the cumulative, queued and faulted protocols resolve
    (a descriptor passes through as it is, as in the reference)."""
    for name in ("cumulative", "steady-queued", "steady-faulted"):
        assert tb.resolve_protocol(name) == tb.PROTOCOLS[name]
    proto = dataclasses.replace(tb.PROTOCOLS["steady-faulted"], fault_retries=0)
    assert tb.resolve_protocol(proto) is proto
    assert proto.faulted and proto.queued and not tb.PROTOCOLS["steady-queued"].faulted
    with pytest.raises(ValueError, match="unknown protocol"):
        tb.resolve_protocol("bursty")
    assert tb.resolve_protocol("steady") == tb.PROTOCOLS["steady"]
    assert {k: dataclasses.astuple(v) for k, v in tb.PROTOCOLS.items()} == {
        k: dataclasses.astuple(v) for k, v in jb.PROTOCOLS.items()}


# ---------------------------------------------------------------------------
# Import hygiene
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro(\.| ))", re.M)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in (REPO / "src" / "repro_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_port_imports_neither_jax_nor_the_reference(path):
    assert not _FORBIDDEN.findall((REPO / path).read_text())
