"""The port's ``ServingEngine`` serves exactly what the reference's serves.

Both engines get the same requests and the same parameters (the
reference's ``init_params`` tree carried over with ``params_from_numpy``)
and run on the CPU (``device="cpu"``).  Every request's ``output``,
``admitted``, ``rejected`` and ``finished`` and the returned stats must be
equal — the tokens are greedy argmaxes of float32 logits that agree to
1e-4 (``tests/test_torch_model.py``), and admission is exact.
"""

import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine

from repro_torch.configs import SMOKES
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_params(J_SMOKES[ARCH], jax.random.PRNGKey(0))
    tp = tmodel.params_from_numpy(jax.tree.map(np.asarray, jp), SMOKES[ARCH], device="cpu")
    return jp, tp


def make_requests(cls, specs, seed, plen=12):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, SMOKES[ARCH].vocab, plen).astype(np.int32), *spec[:2],
                **spec[2] if len(spec) > 2 else {})
            for i, spec in enumerate(specs)]


def serve_both(params, specs, seed, engine_kwargs, hook=None):
    """Serve ``specs`` through both engines; ``hook(engine, wave_number)``
    runs before each wave (fault injection)."""
    jp, tp = params
    out = []
    for cls, engine_cls, p, extra in ((JRequest, JEngine, jp, {}),
                                      (TRequest, TEngine, tp, {"device": "cpu"})):
        reqs = make_requests(cls, specs, seed)
        engine = engine_cls(SMOKES[ARCH] if engine_cls is TEngine else J_SMOKES[ARCH], p,
                            **engine_kwargs, **extra)
        if hook is not None:
            serve = engine._serve_wave
            waves = [0]

            def wave(w, engine=engine, serve=serve, waves=waves):
                waves[0] += 1
                hook(engine, waves[0])
                serve(w)

            engine._serve_wave = wave
        stats = engine.run(reqs)
        out.append((stats, [(r.request_id, r.output, r.admitted, r.rejected, r.finished)
                            for r in reqs], engine))
    (jstats, jreqs, jengine), (tstats, treqs, tengine) = out
    assert treqs == jreqs
    assert tstats == jstats
    assert np.array_equal(tengine.admission.cluster.occupancy_matrix(),
                          jengine.admission.cluster.occupancy_matrix())
    return tstats, treqs, tengine


def test_plain_stream(params):
    """Mixed profiles and lengths (0 new tokens, short, long) over waves
    of three slots on two GPUs."""
    specs = [(4, "1g.10gb"), (0, "2g.20gb"), (6, "3g.40gb"), (2, "1g.20gb"),
             (5, "1g.10gb"), (3, "4g.40gb"), (1, "1g.10gb")]
    stats, reqs, engine = serve_both(params, specs, 0, dict(num_slots=3, max_len=24, num_gpus=2))
    assert stats["accepted"] == 7 and stats["waves"] == 3
    assert engine.admission.cluster.used_mem_slices == 0
    assert [len(r[1]) for r in reqs] == [4, 0, 6, 2, 5, 3, 1]


def test_oversubscription_and_max_len(params):
    """7g requests on one GPU (later ones reject), and outputs cut at
    ``max_len``."""
    specs = [(30, "7g.80gb")] * 4
    stats, reqs, _ = serve_both(params, specs, 1, dict(num_slots=2, max_len=20, num_gpus=1))
    assert stats["rejected"] > 0
    assert all(len(r[1]) == 20 - 12 - 1 for r in reqs if r[2])


def test_queued_stream(params):
    """Patient requests of several tenants and priorities queue across
    waves instead of dropping; one has too little patience."""
    specs = [(2, "7g.80gb", dict(patience=8, tenant="a")),
             (3, "7g.80gb", dict(patience=8, tenant="b", priority=1)),
             (2, "7g.80gb", dict(patience=8, tenant="b", priority=0)),
             (1, "4g.40gb", dict(patience=1, tenant="a")),
             (2, "3g.40gb", dict(patience=6, tenant="c"))]
    stats, reqs, _ = serve_both(params, specs, 2, dict(num_slots=3, max_len=20, num_gpus=1))
    assert stats["wait_p99"] > 0 and stats["waves"] >= 3


def test_fail_and_recover_stream(params):
    """A GPU fails before the second wave (its running workloads evict and
    re-queue) and comes back before the fourth.  As in the reference, an
    evicted request that finished its wave and re-admits later is skipped
    at drain and keeps its slices, so the end occupancy (equal in both
    packages) is not empty."""
    def hook(engine, wave):
        if wave == 2:
            engine.fail_gpu(0)
        elif wave == 4:
            engine.recover_gpu(0)

    specs = [(2, "3g.40gb", dict(patience=6)) for _ in range(5)] + [
        (3, "1g.10gb", dict(patience=6)) for _ in range(4)]
    stats, _, _ = serve_both(params, specs, 3, dict(num_slots=2, max_len=18, num_gpus=2),
                             hook=hook)
    assert stats["evictions"] > 0 and stats["recovered_fraction"] > 0


def test_serve_entry_point_matches_reference(params, monkeypatch, capsys):
    """``launch/serve.py`` with the same flags: the same served and token
    counts and the same scheduler stats (admission does not depend on the
    random weights, which differ between the packages)."""
    argv = ["--requests", "6", "--prompt-len", "8", "--new-tokens", "3", "--gpus", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    want = capsys.readouterr().out
    tserve.main(argv, device="cpu")
    got = capsys.readouterr().out

    def parts(text):
        served = re.search(r"served=(\S+) tokens=(\d+)", text).groups()
        return served, text.splitlines()[-1]

    assert parts(got) == parts(want)


def test_device_none_means_cuda_and_never_falls_back(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    _, tp = params
    cfg = SMOKES[ARCH]
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(cfg, tp)
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main([])
    with pytest.raises(ValueError, match="params lie on"):
        TEngine(cfg, tmodel.init_params(cfg, None, device="meta"), device="cpu")
