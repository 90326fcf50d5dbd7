"""Time the port's test files on two checkouts side by side.

    python tests/time_torch_files.py PARENT_CHECKOUT THIS_CHECKOUT [--jobs 6] [--files F ...]

Each ``tests/test_torch_*.py`` of either checkout runs in its own pytest
process (``PYTHONPATH=src``, JAX on the CPU); the two runs of a file are
queued one after the other, ``--jobs`` processes at a time, so both see
the same load.  Prints each file's wall seconds and CPU seconds (user +
sys of the process and its children, from ``os.wait4``) on both sides,
then the totals.  ``--files`` times only the named files (e.g.
``test_torch_mesh.py``).  Not a test: pytest collects only ``test_*.py``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("tree", type=Path)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--files", nargs="*", default=None)
    args = ap.parse_args()
    roots = {"parent": args.parent.resolve(), "tree": args.tree.resolve()}
    files = sorted({p.name for root in roots.values()
                    for p in (root / "tests").glob("test_torch_*.py")
                    if args.files is None or p.name in args.files})
    jobs = [(side, f) for f in files for side in roots if (roots[side] / "tests" / f).exists()]
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    running, results = {}, {}
    while jobs or running:
        while jobs and len(running) < args.jobs:
            side, f = jobs.pop(0)
            proc = subprocess.Popen(
                [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                 "-p", "no:randomly", f"tests/{f}"],
                cwd=roots[side], env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            running[proc.pid] = (side, f, time.perf_counter())
        pid, status, usage = os.wait4(-1, 0)
        if pid in running:
            side, f, t0 = running.pop(pid)
            results[side, f] = (time.perf_counter() - t0, usage.ru_utime + usage.ru_stime,
                                os.waitstatus_to_exitcode(status))
    for f in files:
        cells = []
        for side in roots:
            r = results.get((side, f))
            cells.append(f"{r[0]:.1f} s wall, {r[1]:.1f} s CPU (rc {r[2]})" if r else "-")
        print(f"{f}: parent {cells[0]} -> tree {cells[1]}")
    for side in roots:
        got = [v for k, v in results.items() if k[0] == side]
        print(f"{side}: {len(got)} files, {sum(v[1] for v in got):.1f} s CPU, "
              f"{sum(v[0] for v in got):.1f} s wall")


if __name__ == "__main__":
    main()
