#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's event stream from ``--seed`` on the card, builds
the program's engine (``repro_torch.sim.batched``) with its CUDA kernels
and warms it with one call on that stream.  The window then drives
``simulate_chunked`` over the stream in calls of a fixed number of chunks,
a fresh carry at the start of every pass, until ``--seconds`` have passed
at a call's end.  ``--trace 1`` profiles a fixed run of calls inside the
window and reports the per-layer metrics instead of the end-to-end ones.
After the window the checked replicas (drawn from the seed, the longest
stream among them) are replayed by the plain NumPy reference of
``portbench/reference/``, and every replica by its plain PyTorch replay
(``reference/lanes.py``), and compared with what the window produced.

The last line of standard output is the result's JSON; the last lines of
standard error give each compared number beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402

from portbench import cell as cellmod  # noqa: E402
from portbench import check  # noqa: E402

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: replicas the NumPy reference replays (every replica is replayed by the
#: all-lane reference too)
CHECKED = 16
#: chunks in the traced run's profiled call, at most
TRACED_CHUNKS = 4


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _reader(name: str):
    """``metrics/<name>.py``'s ``read``; a metric ``<base>.<group>`` that
    has no file of its own (the same reading, split by the end-to-end
    metric its cells report) reads with ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _checked_replicas(seed: int, n_events: np.ndarray, count: int) -> np.ndarray:
    """``count`` replicas drawn from the seed, the longest stream among them."""
    rng = np.random.default_rng(seed)
    longest = int(np.argmax(n_events))
    others = np.setdiff1d(np.arange(n_events.shape[0]), [longest])
    pick = rng.choice(others, size=min(count - 1, others.shape[0]), replace=False)
    return np.sort(np.concatenate([[longest], pick]).astype(np.int64))


def real_events(n_events: np.ndarray, lo: int, hi: int) -> int:
    """Replica-events of stream rows ``lo:hi`` that are not padding: a
    replica's events and its closing sentinel, rows ``0 .. n_events``."""
    return int((np.clip(n_events.astype(np.int64) + 1, lo, hi) - lo).sum())


def measure(cell, seed: int, seconds: float, traced: bool, dev) -> dict:
    import torch

    from repro_torch.sim import batched

    proto = cell.module("protocols")
    mix = cell.mix
    cuda = dev.type == "cuda"
    setup = {}

    def mark(name, since):
        now = time.perf_counter()
        setup[name] = now - since
        return now

    t = mark("import_s", T0)
    if cuda:
        from repro_torch.kernels.fragscore import fragscore as kernels

        kernels._lib()  # built into build/repro_torch/ by the first run, loaded after
        torch.cuda.init()
    t = mark("kernel_load_s", t)
    st = proto.make_stream(cell, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t = mark("stream_s", t)

    spec = proto.program_spec(cell)
    runs = st.shape[1]
    e_max = st.shape[0]
    common = dict(
        policy=cell.scheduler, metric=cell.config["metric"], num_gpus=spec.num_gpus,
        ring_rows=st.ring_rows, ring_cols=st.ring_cols, use_kernel=True,
        kernel_spec=spec, tables=batched.spec_tables(spec, dev),
        midx=torch.as_tensor(spec.model_index, device=dev), device=dev,
        **proto.engine_kwargs(cell))
    chunk = int(mix["chunk_size"])
    per_call = chunk * int(mix["chunks_per_call"])
    fields = {k: st.fields.get(k) for k in batched.EventStream._fields}

    def call(carry, lo, hi, stats):
        sub = batched.EventStream(**{k: None if a is None else a[:hi] for k, a in fields.items()})
        with torch.profiler.record_function("portbench.call"):
            return batched.simulate_chunked(sub, chunk_size=chunk, carry=carry, start=lo,
                                            stream=True, stats=stats, **common)

    carry = batched.init_carry(runs, **common)
    call(carry, 0, min(chunk, e_max), {})  # one chunk warms every shape an event uses
    del carry
    if cuda:
        torch.cuda.synchronize(dev)
    t = mark("warm_call_s", t)

    replicas = _checked_replicas(seed, st.n_events, CHECKED)
    got = []          # per pass: {field: (E, Q)} of the checked replicas
    covered = []      # per pass: rows stepped
    # --trace 1: call 1 is profiled on the device's timeline alone (the
    # per-layer metrics, at a profiler cost of ~1 us a launch), over at most
    # TRACED_CHUNKS chunks; call 2, of one chunk, on the host's too, only to
    # name the idle gaps (the host's records cost several us an operator
    # and slow the host some 2x)
    metrics_call, labels_call = (1, 2) if traced else (-1, -1)
    sizes = {metrics_call: min(per_call, TRACED_CHUNKS * chunk), labels_call: chunk}
    profs = {}
    traced_stats, traced_events, traced_s = {}, 0, 0.0
    call_s, call_stats = [], []
    calls = []        # (lo, hi, trace of all lanes) of every call, for the all-lane check
    carry, last, lo, n_call = None, None, 0, 0
    t_window = time.perf_counter()
    setup_s = t_window - T0
    while True:
        if carry is None:
            last = None
            with torch.profiler.record_function("portbench.new_pass"):
                carry = batched.init_carry(runs, **common)
            lo = 0
            got.append(None)
            covered.append(0)
        hi = min(lo + sizes.get(n_call, per_call), e_max)
        stats = {}
        if n_call in (metrics_call, labels_call):
            acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
            if n_call == labels_call or not cuda:
                acts.append(torch.profiler.ProfilerActivity.CPU)
            prof = profs[n_call] = torch.profiler.profile(activities=acts)
            prof.start()
            t_call = time.perf_counter()
            with torch.profiler.record_function("portbench.window"):
                carry, trace = call(carry, lo, hi, stats)
            dt = time.perf_counter() - t_call
            prof.stop()
            if n_call == metrics_call:
                traced_stats, traced_events, traced_s = stats, hi - lo, dt
        else:
            t_call = time.perf_counter()
            carry, trace = call(carry, lo, hi, stats)
        call_s.append(time.perf_counter() - t_call)
        call_stats.append(dict(h2d_s=stats.get("h2d_seconds"), d2h_s=stats.get("d2h_seconds")))
        with torch.profiler.record_function("portbench.keep_checked_rows"):
            rows = {name: np.asarray(a)[:, replicas] for name, a in trace._asdict().items()
                    if a is not None}
            if got[-1] is None:
                got[-1] = {name: np.zeros((e_max, len(replicas)), a.dtype)
                           for name, a in rows.items()}
            for name, a in rows.items():
                got[-1][name][lo:hi] = a
            calls.append((lo, hi, {name: np.asarray(a) for name, a in trace._asdict().items()
                                   if a is not None}))
            del trace, rows
        covered[-1] = hi
        n_call += 1
        lo = hi
        last = carry
        if hi == e_max:
            carry = None
        done_tracing = n_call > labels_call
        if time.perf_counter() - t_window >= seconds and done_tracing:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t_window
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    stepped = sum(real_events(st.n_events, lo, hi) for lo, hi, _ in calls)
    port_states = proto.port_state(last, replicas)
    lane_state = proto.port_lanes(last)
    last_hi = covered[-1]
    del carry, last, common
    if cuda:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that no run may hold: {found}")

    t_check = time.perf_counter()
    verdict = check.compare(cell, st.fields, replicas, got, covered, port_states, last_hi, proto,
                            window=dict(calls=calls, ring=(st.ring_rows, st.ring_cols),
                                        device=dev, state=lane_state))
    check_s = time.perf_counter() - t_check
    del calls, lane_state

    device = dict(platform="gpu" if cuda else "cpu",
                  kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                  count=1, memory_peak_bytes=int(peak))
    if cuda:
        device["power_limit_w"] = _power_limit()
    result = dict(correct=verdict["correct"], attempted=int(stepped),
                  failed=int(verdict["failed_rows"]), metrics={}, device=device)
    if traced:
        result["metrics"], result["breakdown"], busy_s, window_s = per_layer(
            cell, profs[metrics_call], profs[labels_call], traced_events, traced_s,
            traced_stats, st, device["kind"])
        device.update(busy_s=busy_s, window_s=window_s)
    else:
        # an end-to-end metric ``<quantity>.<group>`` is the quantity in its
        # group's cells, with a bound of its own
        values = dict(replica_events_per_s=stepped / elapsed, peak_mem_gib=peak / 2**30,
                      setup_s=setup_s)
        for m in _bench()["end_to_end"]:
            if "workloads" not in m or cell.name in m["workloads"]:
                result["metrics"][m["name"]] = {"value": values[m["name"].split(".")[0]],
                                                "unit": m["unit"]}
    result["setup"] = setup
    result["window"] = dict(seconds=elapsed, calls=n_call, call_s=call_s, call_stats=call_stats,
                            check_s=check_s, passes=len(covered),
                            events_per_pass=e_max, replicas=runs, ring_cols=st.ring_cols,
                            checked_replicas=[int(r) for r in replicas],
                            checked_rows=int(verdict["rows"]))
    result["checks"] = verdict["checks"]
    return result


def geometry(cell, st) -> dict:
    """The shapes the kernels' work counts read, from the configuration
    (one device model: Table I's placement rows and anchors) and the
    stream."""
    from portbench.kernels import KEYS

    fleet = cell.fleet
    m, s = fleet.num_gpus, fleet.slices
    ring = st.ring_rows * st.ring_cols
    return dict(R=st.shape[1], M=m, N=sum(len(a) for a in fleet.anchors), S=s,
                A=max(len(a) for a in fleet.anchors), K=1, P=fleet.classes,
                L=KEYS, ring_cols=st.ring_cols, C_live=min(ring, m * s),
                queued=cell.module("protocols").QUEUED, defrag=cell.defrag)


def per_layer(cell, prof, labels, events, window_s, stats, st, kind):
    """The cell's per-layer metrics from the device records of the metrics
    call (``prof``, ``window_s`` of host clock) and the breakdown, whose
    idle gaps are named from the host records of the labels call."""
    from portbench import profile

    rec = profile.records(prof)
    busy_s = profile.busy_ns(rec["device"], 0, 2**63 - 1) / 1e9
    own = []
    for path in sorted((HERE / "kernels").glob("*.py")):
        if path.stem != "__init__":
            own.append(importlib.import_module(f"portbench.kernels.{path.stem}").NAME)
    ctx = dict(kernels=[(n, s, d / 1e9) for n, s, d in rec["kernels"]], events=events,
               window_s=window_s, busy_s=busy_s, stats=stats,
               geometry=geometry(cell, st), device_kind=kind, own_kernels=own)
    metrics = {}
    for m in _bench()["per_layer"]:
        if "workloads" in m and cell.name not in m["workloads"]:
            continue
        value = _reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lab = profile.records(labels)
    lo, hi = lab["window"]
    breakdown = dict(device_ops=profile.top_device_ops(rec["device"]),
                     idle_gaps=profile.idle_gaps(lab["device"], lab["host"], lo, hi))
    return metrics, breakdown, busy_s, window_s


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, overrides=None, device=None) -> int:
    """Run the cell; ``device`` (tests only) skips the look for a card and
    runs there, ``overrides`` replaces mix entries."""
    args = parse(argv)
    cell = cellmod.load(args.workload, overrides)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"the cell needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device(device))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
