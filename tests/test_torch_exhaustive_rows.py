"""The plain versions of ``mfi_delta`` and ``delta_from_base`` equal the
reference's Pallas kernels in interpret mode exactly on every occupancy
pattern of every device model: all 2^S rows (256 for S = 8, 4096 for the
H200-141GB), every demand class, both metrics, ``1e30`` sentinel included.

These are the rows whose bit-set paths the CUDA kernels take on the card,
where ``chip_smoke.py`` holds each kernel to its plain version on the same
patterns.  ``delta_from_base`` takes the patterns' window counts
(``base = occ · Wᵀ``, ``free = S − used``, ``f = F(occ)``) on a homogeneous
fleet of each model and on a four-model fleet, one replica per class.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.kernels.fragscore import fragscore as jk
from repro.sim import batched as jb

from repro_torch.core import cluster as tcluster
from repro_torch.core import mig as tmig
from repro_torch.kernels.fragscore import ref
from repro_torch.sim import batched as tb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODEL_NAMES = sorted({m.name for m in tmig.DEVICE_MODELS.values()})
FOUR_MODEL = ("a100-80gb", "a100-40gb", "h100-96gb", "h100-80gb")


def patterns(s: int) -> np.ndarray:
    """Every 0/1 occupancy row of ``s`` slices, ``(2^s, s)`` int32."""
    return ((np.arange(1 << s)[:, None] >> np.arange(s)) & 1).astype(np.int32)


@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_mfi_delta_plain_equals_pallas_on_every_pattern(name, metric):
    model = tmig.DEVICE_MODELS[name]
    occ = patterns(model.num_mem_slices)
    t = tcluster.tables_for(model, device="cpu")
    w, v = t.placement_masks, t.placement_mem
    for pid in range(tmig.NUM_PROFILES):
        pm = t.profile_masks[pid].to(torch.float32)
        pv = t.profile_valid[pid].to(torch.float32)
        got = ref.mfi_delta_ref(torch.as_tensor(occ), w, v, pm, pv, metric).numpy()
        want = np.asarray(jk.mfi_delta(
            jnp.asarray(occ), *(jnp.asarray(x.numpy()) for x in (w, v, pm, pv)),
            metric=metric, interpret=True))
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want), (name, metric, pid)


def pattern_fleet(names):
    """The fleet holding, for each model in ``names``, one GPU per occupancy
    pattern of that model, and the patterns' window-count state
    (``base``, ``free``, ``f`` per metric) of one replica."""
    text = ",".join(f"{n}:{1 << tmig.DEVICE_MODELS[n].num_mem_slices}" for n in names)
    spec = tmig.ClusterSpec.parse(text)
    occ = np.zeros((spec.num_gpus, spec.num_mem_slices), np.int32)
    g = 0
    for n in names:
        pats = patterns(tmig.DEVICE_MODELS[n].num_mem_slices)
        occ[g:g + len(pats), :pats.shape[1]] = pats
        g += len(pats)
    t = tb._spec_tables_np(spec)
    midx = spec.model_index
    base = np.einsum("ms,mns->mn", occ.astype(np.float32), t["W"][midx])
    free = (t["slices"][midx] - occ.sum(axis=1)).astype(np.int32)
    return text, spec, base, free, midx, t["V"][midx]


@pytest.mark.parametrize("metric", ["blocked", "partial"])
@pytest.mark.parametrize("names", [(n,) for n in MODEL_NAMES] + [FOUR_MODEL],
                         ids=lambda names: "+".join(names))
def test_delta_from_base_plain_equals_pallas_on_every_pattern(names, metric):
    text, spec, base, free, midx, vrows = pattern_fleet(names)
    f = tb._frag_from_base(torch.as_tensor(base), torch.as_tensor(free), metric,
                           torch.as_tensor(vrows)).numpy()
    p = tmig.NUM_PROFILES
    t = tb.spec_tables(spec, "cpu")
    got = ref.delta_from_base_ref(
        torch.as_tensor(np.broadcast_to(base, (p,) + base.shape).copy()),
        torch.as_tensor(np.broadcast_to(free, (p,) + free.shape).copy()),
        torch.as_tensor(np.broadcast_to(f, (p,) + f.shape).copy()),
        torch.arange(p, dtype=torch.int32), torch.as_tensor(midx), t.V, t.maskwin,
        t.profile_mem, metric).numpy()
    delta_fn = jb.make_delta_fn(jmig.ClusterSpec.parse(text), metric, interpret=True)
    for pid in range(p):
        want = np.asarray(delta_fn(jnp.asarray(base), jnp.asarray(free), jnp.asarray(f), pid))
        assert got[pid].dtype == np.float32 and got[pid].shape == want.shape
        assert np.array_equal(got[pid], want), (text, metric, pid)
