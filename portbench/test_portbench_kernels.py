"""The kernels' work counts at the shapes of the repository's recorded
kernel table (H100 80GB HBM3 bounds: bytes over 3.35 TB/s)."""

import pytest

from portbench.kernels import PEAKS, bound_s, fragscore, migrate_refine, select_from_base

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def test_select_from_base_at_r500_m100():
    flops, nbytes = select_from_base.work(R=500, M=100, N=18, A=7, K=1, P=6, L=3)
    assert nbytes == pytest.approx(4.01e6, rel=2e-3)
    assert bound_s(flops, nbytes, H100) * 1e6 == pytest.approx(1.20, abs=0.005)


def test_fragscore_at_6000_rows():
    flops, nbytes = fragscore.work(rows=6000, windows=18, slices=8)
    assert bound_s(flops, nbytes, H100) * 1e6 == pytest.approx(0.065, abs=0.0005)


def test_migrate_refine_at_r500_c800():
    flops, nbytes = migrate_refine.work(R=500, M=100, C=800, N=18, A=7, K=1, P=6, L=3)
    assert nbytes / 1e6 == pytest.approx(47.7, abs=0.05)
    assert bound_s(flops, nbytes, H100) * 1e6 == pytest.approx(14.25, abs=0.01)


def test_per_event_launches():
    g = dict(R=10, M=100, N=18, S=8, A=7, K=1, P=6, L=3, ring_cols=16, C_live=800,
             queued=False, defrag=False)
    assert [s["rows"] for s in fragscore.per_event(g)] == [160, 10]
    assert len(select_from_base.per_event(g)) == 1 and migrate_refine.per_event(g) == []
    q = dict(g, queued=True)
    assert [s["rows"] for s in fragscore.per_event(q)] == [160, 10, 10]
    assert len(select_from_base.per_event(q)) == 2
    d = dict(g, defrag=True)
    assert [s["rows"] for s in fragscore.per_event(d)] == [160, 10, 10]
    assert migrate_refine.per_event(d)[0]["C"] == 800
