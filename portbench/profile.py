"""Reading the profiler's trace of a traced window.

The device's records (kernels, copies, fills) come from CUPTI through
``torch.profiler``; the host's (torch operators, CUDA runtime calls and
the benchmark's own ``portbench.*`` ranges) from its CPU activity.  Both
carry nanoseconds on one clock.  The benchmark's ranges are mirrored on
the device's timeline as annotations; they are not device work.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Record = Tuple[str, int, int]  # (name, start ns, duration ns)

WINDOW = "portbench.window"


def records(prof) -> Dict[str, list]:
    """``kernels``, ``device`` (kernels, copies and fills) and ``host``
    records of a finished profile, and the traced window ``(start, end)``
    in ns from its ``portbench.window`` range."""
    kernels: List[Record] = []
    device: List[Record] = []
    host: List[Record] = []
    window = None
    for ev in prof.profiler.kineto_results.events():
        name, start, dur = ev.name(), ev.start_ns(), ev.duration_ns()
        if name.startswith("portbench.") and ev.device_type().name == "CUDA":
            continue  # the benchmark's own ranges, mirrored on the device's timeline
        if ev.device_type().name == "CUDA":
            device.append((name, start, dur))
            if not name.startswith(("Memcpy", "Memset")) and "memcpy" not in name.lower() \
                    and "memset" not in name.lower():
                kernels.append((name, start, dur))
        else:
            host.append((name, start, dur))
            if name == WINDOW:
                window = (start, start + dur)
    return dict(kernels=kernels, device=device, host=host, window=window)


def busy_ns(device: List[Record], lo: int, hi: int) -> int:
    """Length of the union of the device records' intervals within ``[lo, hi)``."""
    total, cur_s, cur_e = 0, None, None
    for _, s, d in sorted(device, key=lambda r: r[1]):
        s, e = max(s, lo), min(s + d, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def top_device_ops(device: List[Record], n: int = 10) -> List[list]:
    """The ``n`` device operations that took the most time, by name: ``[[name, s]]``."""
    by: Dict[str, int] = {}
    for name, _, d in device:
        by[name] = by.get(name, 0) + d
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[_short(name), d / 1e9] for name, d in top]


def idle_gaps(device: List[Record], host: List[Record], lo: int, hi: int,
              n: int = 10) -> List[list]:
    """The ``n`` longest stretches of ``[lo, hi)`` with nothing on the
    device, each named by the innermost host record running at its middle:
    ``[[name, s]]``."""
    gaps, cursor = [], lo
    for _, s, d in sorted(device, key=lambda r: r[1]):
        if s > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, s + d)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:n]
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        inner = [r for r in host if r[1] <= mid < r[1] + r[2] and r[0] != WINDOW]
        label = max(inner, key=lambda r: r[1])[0] if inner else "host: none recorded"
        out.append([_short(label), (b - a) / 1e9])
    return out


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."
