"""The benchmark's stream generator against the program's own
``presample_arrivals``: the same format and invariants, and the law."""

import numpy as np
import pytest
import torch

from portbench import cell as cellmod
from portbench.reference.common import decode_slots

CELLS = ["steady-mfi.load085.r64k", "queued-mfi.load110.r64k", "steady-defrag.load100.r4k"]


def _ours(name, replicas=24, seed=2**31 + 7):
    cell = cellmod.load(name, dict(replicas=replicas))
    return cell, cell.module("protocols").make_stream(cell, seed, torch.device("cpu"))


def _port(cell, replicas=24):
    from repro_torch.sim import batched
    from repro_torch.sim.simulator import SimConfig

    proto = cell.config["protocol"]
    cfg = SimConfig(num_gpus=cell.fleet.num_gpus, offered_load=cell.mix["offered_load"],
                    protocol=proto["name"], seed=3, num_tenants=proto.get("tenants", 4),
                    num_priorities=proto.get("priorities", 2))
    ev, _, rows, cols = batched.presample_arrivals(cfg, replicas, queued="tenants" in proto)
    return {k: np.ascontiguousarray(getattr(ev, k)) for k in ev._fields
            if getattr(ev, k) is not None}, rows, cols


def _invariants(fields, cell, ring_k):
    """The format's rules, replica by replica."""
    slots = cell.warm + cell.meas
    pid, new_slot = fields["pid"], fields["new_slot"]
    e_max, runs = pid.shape
    for r in range(runs):
        t = decode_slots(new_slot[:, r])
        assert new_slot[0, r] and t[-1] == slots          # every slot, then one sentinel
        assert new_slot[:, r].sum() == slots + 1
        last = int(np.flatnonzero(new_slot[:, r])[-1])    # the sentinel
        assert (pid[last:, r] == -1).all() and not new_slot[last + 1:, r].any()
        per = np.bincount(t[:last], minlength=slots)
        assert (per >= 1).all()                           # a heartbeat where none arrive
        arr = pid[:, r] >= 0
        assert ((pid[:, r][arr] >= 0) & (pid[:, r][arr] < cell.fleet.classes)).all()
        assert (fields["exp_row"][~arr, r] == ring_k + 1).all()
        end = t[arr] + (fields["exp_row"][arr, r] - t[arr]) % ring_k
        assert ((end - t[arr] >= 1) & (end - t[arr] <= cell.T)).all()
        cells = end * 1000 + fields["exp_col"][arr, r]
        assert np.unique(cells).size == cells.size         # ring columns collision-free
        assert (fields["drain_row"][:, r] == np.minimum(t, slots) % ring_k).all()
        assert (fields["measuring"][:, r] == (arr & (t >= cell.warm))).all()
        if fields.get("end") is not None:
            assert (fields["end"][arr, r] == end).all()
            assert (fields["wlive"][:, r] == (np.arange(e_max) < last)).all()


@pytest.mark.parametrize("name", CELLS)
def test_format_matches_the_program(name):
    cell, ours = _ours(name)
    port, rows, _ = _port(cell)
    assert ours.ring_rows == rows
    assert set(k for k, v in ours.fields.items() if v is not None) == set(port)
    for k, a in port.items():
        assert ours.fields[k].dtype == a.dtype, k
        assert ours.fields[k].flags["C_CONTIGUOUS"]
    _invariants(port, cell, rows - 2)          # the rules hold for the program's stream
    _invariants(ours.fields, cell, rows - 2)   # and for ours


@pytest.mark.parametrize("name", CELLS)
def test_law(name):
    cell, st = _ours(name, replicas=400)
    f = st.fields
    arr = f["pid"] >= 0
    n_arr = arr.sum()
    slots = (cell.warm + cell.meas) * arr.shape[1]
    sigma = np.sqrt(cell.rate / slots)
    assert abs(n_arr / slots - cell.rate) < 5 * sigma
    share = np.bincount(f["pid"][arr], minlength=cell.fleet.classes) / n_arr
    p = np.asarray(cell.mix["class_shares"])
    assert (np.abs(share - p) < 5 * np.sqrt(p * (1 - p) / n_arr)).all()
    if f["tenant"] is not None:
        proto = cell.config["protocol"]
        assert set(np.unique(f["tenant"][arr])) == set(range(proto["tenants"]))
        assert set(np.unique(f["prio"][arr])) == set(range(proto["priorities"]))


def test_same_seed_same_stream_and_seed_changes_it():
    _, a = _ours(CELLS[1], replicas=8, seed=2**33 + 1)
    _, b = _ours(CELLS[1], replicas=8, seed=2**33 + 1)
    _, c = _ours(CELLS[1], replicas=8, seed=2**33 + 2)
    for k, v in a.fields.items():
        if v is not None:
            assert np.array_equal(v, b.fields[k])
    assert not np.array_equal(a.fields["pid"][:100], c.fields["pid"][:100])


def test_steady_params_match_the_program():
    from repro_torch.sim.simulator import SimConfig, steady_params

    for name in CELLS:
        cell = cellmod.load(name)
        cfg = SimConfig(num_gpus=100, offered_load=cell.mix["offered_load"])
        assert (cell.T, cell.warm, cell.meas) == steady_params(cfg)[:3]
        assert cell.rate == pytest.approx(steady_params(cfg)[3], rel=1e-15)
