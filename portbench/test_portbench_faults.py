"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program's event step, and the whole run
(window, checks) is driven on the CPU at a small size.  The cell runs on
one card, so there is no exchange between cards to leave out.
"""

import json

import pytest
import torch

from portbench import run

CELLS = ["steady-mfi.load085.r64k", "queued-mfi.load110.r64k", "steady-defrag.load100.r4k"]
SMALL = dict(replicas=4, chunk_size=32, chunks_per_call=4)


def _unchanged(orig):
    def step(self, st, x):
        saved = [None if t is None else t.clone() for t in st]
        row = orig(self, st, x)
        for t, s in zip(st, saved):
            if t is not None:
                t.copy_(s)
        return row
    return step


def _half(orig):
    def step(self, st, x):
        half = st.free.shape[0] // 2
        saved = [None if t is None else t[half:].clone() for t in st]
        row = orig(self, st, x)
        for t, s in zip(st, saved):
            if t is not None:
                t[half:] = s
        return row
    return step


def _altered(orig):
    def step(self, st, x):
        row = orig(self, st, x)
        gpu = row.gpu.clone()
        gpu[0] = torch.where(row.ok[0], (gpu[0] + 1) % st.free.shape[1], gpu[0])
        return row._replace(gpu=gpu)
    return step


def _altered_lane(lane):
    def fault(orig):
        def step(self, st, x):
            row = orig(self, st, x)
            gpu = row.gpu.clone()
            gpu[lane] = torch.where(row.ok[lane], (gpu[lane] + 1) % st.free.shape[1], gpu[lane])
            return row._replace(gpu=gpu)
        return step
    return fault


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch, capsys):
    from repro_torch.sim import batched

    monkeypatch.setattr(batched.EngineCore, "step", fault(batched.EngineCore.step))
    assert run.main(["--workload", name, "--seed", "12345", "--seconds", "1", "--trace", "0"],
                    overrides=SMALL, device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is False
    assert out["checks"]["trace_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_an_unchecked_replica_is_not_correct(name, monkeypatch, capsys):
    """A decision altered in one replica that the NumPy reference does not
    replay: only the all-lane comparison sees it."""
    from portbench import cell as cellmod
    from repro_torch.sim import batched

    seed, size = 12346, dict(SMALL, replicas=run.CHECKED + 4)
    cell = cellmod.load(name, size)
    st = cell.module("protocols").make_stream(cell, seed, torch.device("cpu"))
    checked = set(run._checked_replicas(seed, st.n_events, run.CHECKED).tolist())
    lane = min(set(range(size["replicas"])) - checked)
    monkeypatch.setattr(batched.EngineCore, "step", _altered_lane(lane)(batched.EngineCore.step))
    assert run.main(["--workload", name, "--seed", str(seed), "--seconds", "1", "--trace", "0"],
                    overrides=size, device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is False
    assert out["checks"]["trace_mismatch"]["value"] == 0
    assert out["checks"]["lane_mismatch"]["value"] > 0
    assert out["failed"] > 0
