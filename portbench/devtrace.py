"""The traced run's reading of a torch.profiler trace: kernel seconds by
name, the device's busy seconds, its idle gaps and what the host was
doing in them.

Only the time inside the benchmark's job spans counts: the harness's own
work between jobs is outside the window.  A device operation is a kernel,
a copy or a fill on the card ("kernel", "gpu_memcpy" and "gpu_memset"
events of the Chrome trace that torch.profiler exports).  Spans are the
benchmark's record_function ranges ("user_annotation" events) named
portbench.<name>.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
SPAN_PREFIX = "portbench."
JOB = "portbench.job"


class Trace(NamedTuple):
    """A reading of one traced window (seconds)."""

    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]   # all device ops by name, summed
    gaps: List[Tuple[str, float]]         # every idle gap, by open span
    kernels: Dict[str, float]             # full kernel name -> seconds


def _clip(a: float, b: float, spans: List[Tuple[float, float]]):
    """Pieces of [a, b) inside the sorted, disjoint spans."""
    out = []
    for s, e in spans:
        if e <= a:
            continue
        if s >= b:
            break
        out.append((max(a, s), min(b, e)))
    return out


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: 'void ka_kernel<23>(long*, ...)' -> 'ka_kernel'."""
    s = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    return s.split()[-1] if s else name


def read_events(events: list) -> Trace:
    """Reduce Chrome-trace events to a Trace."""
    jobs, spans, dev, kernels = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        a = float(e.get("ts", 0.0))
        b = a + float(e.get("dur", 0.0))
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            dev.append((a, b))
            kernels.append((name, a, b, cat == "kernel"))
        elif name.startswith(SPAN_PREFIX):
            (jobs if name == JOB else spans).append((a, b, name))
    window = _union([(a, b) for a, b, _ in jobs])
    busy = _union([p for a, b in dev for p in _clip(a, b, window)])
    by_kernel: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    for name, a, b, is_kernel in kernels:
        t = sum(e - s for s, e in _clip(a, b, window))
        if t <= 0:
            continue
        if is_kernel:
            by_kernel[name] = by_kernel.get(name, 0.0) + t
        key = short_name(name) if is_kernel else name
        ops[key] = ops.get(key, 0.0) + t
    gaps = []
    spans.sort()
    for s, e in window:
        at = s
        for a, b in [p for p in busy if p[0] < e and p[1] > s] + [(e, e)]:
            if a > at:
                mid = (at + a) / 2
                open_ = [n for x, y, n in spans if x <= mid < y]
                label = open_[-1][len(SPAN_PREFIX):] if open_ else "job"
                gaps.append((label, (a - at) * 1e-6))
            at = max(at, b)
    w = sum(b - a for a, b in window) * 1e-6
    return Trace(w, sum(b - a for a, b in busy) * 1e-6,
                 sorted(((k, v * 1e-6) for k, v in ops.items()),
                        key=lambda x: -x[1]),
                 gaps, {k: v * 1e-6 for k, v in by_kernel.items()})


def read_file(path: str) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return read_events(events)


def kernel_seconds(trace: Optional[Trace], patterns: List[str]) -> Optional[float]:
    """Seconds of the kernels whose names match any pattern (a regular
    expression searched in the full name); None without a trace or where
    no such kernel ran."""
    if trace is None:
        return None
    rx = [re.compile(p) for p in patterns]
    t = sum(v for k, v in trace.kernels.items() if any(r.search(k) for r in rx))
    return t if t > 0 else None


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The result line's breakdown: the device operations that took most
    time and the longest idle gaps, each named by the benchmark's span
    that was open in it (count, correct, trim; job between them)."""
    gaps = sorted(trace.gaps, key=lambda g: -g[1])[:top]
    return {"device_ops": [[k, v] for k, v in trace.device_ops[:top]],
            "idle_gaps": [[k, v] for k, v in gaps]}
