"""Each per-layer reader on a canned trace, and the trace reductions."""

import json
from pathlib import Path

import pytest

from portbench import profile
from portbench.kernels import PEAKS, bound_s, fragscore, select_from_base
from portbench.run import _reader

KIND = "NVIDIA H100 80GB HBM3"
GEOM = dict(R=1000, M=100, N=18, S=8, A=7, K=1, P=6, L=3, ring_cols=16, C_live=800,
            queued=False, defrag=False)


def canned(events=2):
    """Two steady mfi events: per event a torch op, the drain's and the
    commit's fragscore, one select_from_base."""
    kernels = []
    for e in range(events):
        kernels += [("void at::native::index_elementwise_kernel<...>", 0, 40e-6),
                    ("fragscore_kernel(int const*, float const*, ...)", 0, 10e-6),
                    ("select_from_base_kernel(float const*, ...)", 0, 30e-6),
                    ("fragscore_kernel(int const*, float const*, ...)", 0, 2e-6)]
    return dict(kernels=kernels, events=events, window_s=1e-3, busy_s=2.5e-4,
                stats={"h2d_seconds": 1e-4, "d2h_seconds": 2e-4}, geometry=GEOM,
                device_kind=KIND,
                own_kernels=["fragscore_kernel", "select_from_base_kernel",
                             "migrate_refine_kernel"])


def test_driver_and_device_readers():
    ctx = canned()
    assert _reader("driver.d2h_wait_frac")(ctx) == pytest.approx(0.2)
    assert _reader("driver.h2d_stage_frac")(ctx) == pytest.approx(0.1)
    assert _reader("device.idle_frac")(ctx) == pytest.approx(0.75)
    assert _reader("loop.launches_per_event")(ctx) == pytest.approx(4.0)
    assert _reader("stages.torch_ops_frac")(ctx) == pytest.approx(80 / 164)


def test_roofline_readers():
    ctx = canned()
    h = PEAKS[KIND]
    want = sum(bound_s(*fragscore.work(**s), h) for s in fragscore.per_event(GEOM))
    assert _reader("fragscore_roofline")(ctx) == pytest.approx(100 * 2 * want / 24e-6)
    want = bound_s(*select_from_base.work(R=1000, M=100, N=18, A=7, K=1, P=6, L=3), h)
    assert _reader("select_from_base_roofline")(ctx) == pytest.approx(100 * want / 30e-6)
    assert _reader("migrate_refine_roofline")(ctx) is None     # no such launch
    ctx["kernels"] = ctx["kernels"][:-1]                        # launches off the pattern
    assert _reader("fragscore_roofline")(ctx) is None
    assert _reader("fragscore_roofline")(dict(canned(), device_kind="cpu")) is None


def test_every_per_layer_metric_has_a_reader():
    bench = json.loads((Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(_reader(m["name"]))


def test_busy_gaps_and_top_ops():
    dev = [("k1", 0, 10), ("k2", 5, 10), ("Memcpy HtoD", 30, 5), ("k1", 50, 10)]
    host = [("aten::index", 14, 20), ("cudaLaunchKernel", 21, 3)]
    assert profile.busy_ns(dev, 0, 100) == 15 + 5 + 10
    gaps = profile.idle_gaps(dev, host, 0, 100)
    assert gaps[0] == ["host: none recorded", 40e-9]          # 60..100
    assert ["cudaLaunchKernel", 15e-9] in gaps                 # 15..30, innermost at 22
    assert profile.top_device_ops(dev)[0] == ["k1", 20e-9]
