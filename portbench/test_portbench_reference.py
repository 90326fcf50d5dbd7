"""The plain reference against the program's engine on the CPU: on the
program's own streams, and through a whole run of each cell at a small
size (the window, the checks and the aggregates)."""

import importlib
import json

import numpy as np
import pytest

from portbench import cell as cellmod, run

CELLS = ["steady-mfi.load085.r64k", "queued-mfi.load110.r64k", "steady-defrag.load100.r4k"]
SMALL = dict(replicas=4, chunk_size=32, chunks_per_call=4)


def run_small(name, capsys, seed=2**31 + 11, seconds=1.5):
    assert run.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", "0"], overrides=SMALL, device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_engine_on_its_own_stream(name):
    from repro_torch.sim import batched
    from repro_torch.sim.simulator import SimConfig

    cell = cellmod.load(name)
    proto = cell.config["protocol"]
    queued = "wait_slots" in proto
    cfg = SimConfig(num_gpus=100, offered_load=cell.mix["offered_load"], protocol=proto["name"],
                    seed=17)
    ev, _, rows, cols = batched.presample_arrivals(cfg, 2, queued=queued)
    st, tr = batched.simulate_chunked(
        ev, chunk_size=512, policy=cell.scheduler, metric="blocked", num_gpus=100,
        ring_rows=rows, ring_cols=cols, use_kernel=True, protocol=proto["name"],
        wait_slots=proto.get("wait_slots", 0), wait_patience=proto.get("wait_patience", 0),
        device="cpu")
    ref = importlib.import_module(f"portbench.reference.{proto['name']}")
    e_max = ev.pid.shape[0]
    for r in range(2):
        cols_r = {k: np.asarray(v)[:, r] for k, v in ev._asdict().items() if v is not None}
        want, state = ref.run(cols_r, e_max, cell, snapshot_at=e_max)
        for k, a in want.items():
            assert np.array_equal(np.asarray(getattr(tr, k))[:, r], a), k
        occ = st.occ[r].numpy().astype(np.int64)
        assert np.array_equal((occ << np.arange(8)).sum(-1), state["bits"])


@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_is_correct(name, capsys):
    out = run_small(name, capsys)
    assert out["correct"] is True
    assert out["window"]["checked_rows"] > 0
    assert list(out)[-1] == "checks"
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    assert set(out["metrics"]) == want
    assert {m.split(".")[0] for m in want} == {"replica_events_per_s", "peak_mem_gib", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_every_lane_replay_equals_the_reference(name):
    """The all-lane replay (``reference/lanes.py``) against the one-replica
    reference over a whole pass of the benchmark's own stream, where the
    queue admits and parks and the migration search moves workloads."""
    import torch

    from portbench.reference import lanes

    cell = cellmod.load(name, dict(replicas=2))
    st = cell.module("protocols").make_stream(cell, 2**31 + 21, torch.device("cpu"))
    ref = cell.module("reference")
    e_max, runs = st.shape
    trace, bits, waiting = {}, [], []
    for r in range(runs):
        cols = {k: a[:, r] for k, a in st.fields.items() if a is not None}
        tr, state = ref.run(cols, e_max, cell, snapshot_at=e_max)
        for k, a in tr.items():
            trace.setdefault(k, np.zeros((e_max, runs), a.dtype))[:, r] = a
        bits.append(state["bits"])
        waiting.append(state.get("waiting"))
    if "mig" in trace:
        assert trace["mig"].sum() > 0
    if "parked" in trace:
        assert trace["parked"].sum() > 0 and (trace["wadm_eidx"] >= 0).sum() > 0
    state = dict(bits=torch.as_tensor(np.stack(bits), dtype=torch.int32))
    state["f"] = torch.as_tensor(cell.rules.F[np.stack(bits)], dtype=torch.float32)
    state["free"] = torch.as_tensor(8 - cell.rules.popcount[np.stack(bits)], dtype=torch.int32)
    if "parked" in trace:
        w = np.full((runs, cell.config["protocol"]["wait_slots"]), -1, np.int32)
        for r, ws in enumerate(waiting):
            w[r, :len(ws)] = ws
        state["waiting"] = torch.as_tensor(w)
    half = e_max // 2
    calls = [(0, half, {k: a[:half] for k, a in trace.items()}),
             (half, e_max, {k: a[half:] for k, a in trace.items()})]
    out = lanes.compare(cell, st.fields, (st.ring_rows, st.ring_cols), calls,
                        np.arange(runs), "cpu", program_state=state)
    assert (out["trace_bad"], out["state_bad"], out["bad_rows"]) == (0, 0, 0)
    wrong = dict(trace, gpu=trace["gpu"].copy())
    moved = trace["mig"][:, 1] if "mig" in trace else np.zeros(e_max, bool)
    at = np.flatnonzero(trace["ok"][:, 1] & ~moved)[-1]  # the state follows the replay's own
    wrong["gpu"][at, 1] = (wrong["gpu"][at, 1] + 1) % 100
    out = lanes.compare(cell, st.fields, (st.ring_rows, st.ring_cols), [(0, e_max, wrong)],
                        np.arange(runs), "cpu")
    assert out["trace_bad"] == 1 and out["masks"][0][:, 1].sum() == 1


@pytest.mark.parametrize("name", CELLS)
def test_a_small_traced_run_reads_its_cells_metrics(name, capsys):
    """``--trace 1`` on the CPU: correct, and only the per-layer metrics
    listed for the cell, each read by its own reader or its base's."""
    assert run.main(["--workload", name, "--seed", str(2**31 + 13), "--seconds", "0.1",
                     "--trace", "1"], overrides=dict(SMALL, chunks_per_call=6), device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"] if name in m.get("workloads", [name])}
    assert out["correct"] is True
    assert out["metrics"] and set(out["metrics"]) <= listed
    assert {"window_s", "busy_s"} <= set(out["device"])
    assert out["window"]["calls"] == 3        # one untraced call, the metrics call, the labels call
