"""mfi-defrag at the paper's full width (M = 100 A100-80GB, offered load
1.0) against the reference package (tolerance 0), and the reference's
defrag trace hashes that ``chip_smoke.py`` pins.
"""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sim import simulator as jsim

from repro_torch.sim import batched as tb

from test_torch_defrag_engine import (
    H200_MIX, assert_traces_equal, port_run, reference_run, twin_configs,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps torch's idle worker threads from competing
    with the other test processes for the CPU when files run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]


def trace_hash(trace) -> str:
    """SHA-256 over the trace's fields that exist, in field order."""
    h = hashlib.sha256()
    for name in tb.EventTrace._fields:
        a = getattr(trace, name)
        if a is not None:
            h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def test_defrag_hashes_pinned_in_chip_smoke_are_the_reference():
    text = (REPO / "chip_smoke.py").read_text()
    pinned = {name: re.search(rf'^{name} = "([0-9a-f]{{64}})"', text, re.M).group(1)
              for name in ("DEFRAG_FULL_WIDTH_HASH", "DEFRAG_MIXED_HASH")}
    fleet = re.search(r'^DEFRAG_MIXED_FLEET = "([^"]+)"', text, re.M).group(1)
    assert fleet == H200_MIX
    for name, jcfg, runs in (
        ("DEFRAG_FULL_WIDTH_HASH", jsim.SimConfig(num_gpus=100, offered_load=1.0, seed=0), 8),
        ("DEFRAG_MIXED_HASH", twin_configs(fleet, offered_load=1.0, seed=3)[1], 4),
    ):
        trace = reference_run(jcfg, runs)[-1]
        assert trace_hash(trace) == pinned[name], name


def test_full_width_defrag_equals_reference():
    """The paper's fleet, M = 100 A100-80GB at offered load 1.0: the
    kernel-dispatch trace at runs = 4 equals the reference's."""
    tcfg, jcfg = twin_configs(num_gpus=100, offered_load=1.0, seed=0)
    _, rows, _, _, want = reference_run(jcfg, 4)
    assert np.asarray(want.mig).sum() > 0
    got, _ = port_run("mfi-defrag", tcfg, 4, True, rows)
    assert_traces_equal(got, want)
