"""The control (the reference in the program's place, its tie-break
broken) comes out not correct: at a small size on the CPU, and at the
cell's own size on the card."""

import pytest
import torch

from portbench import cell as cellmod, control
from portbench.run import CHECKED, _checked_replicas

CELLS = ["steady-mfi.load085.r64k", "queued-mfi.load110.r64k", "steady-defrag.load100.r4k"]


def _readings(name, seed, device, overrides=None):
    cell = cellmod.load(name, overrides)
    st = cell.module("protocols").make_stream(cell, seed, torch.device(device))
    replicas = _checked_replicas(seed, st.n_events, CHECKED)
    return control.readings(cell, st.fields, replicas, st.shape[0], (st.ring_rows, st.ring_cols),
                            torch.device(device))


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_small(name):
    out = _readings(name, 2**31 + 5, "cpu", dict(replicas=4))
    assert out["correct"] is False
    assert out["checks"]["trace_mismatch"]["value"] > 0
    assert out["checks"]["lane_mismatch"]["value"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's stream is made on the card")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        out = _readings(name, seed, "cuda:0")
        assert out["correct"] is False
        assert min(c["value"] for c in out["checks"].values()) >= 0
        assert out["checks"]["trace_mismatch"]["value"] > 0
        assert out["checks"]["lane_mismatch"]["value"] > 0
