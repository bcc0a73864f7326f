"""Reduction of a `torch.profiler` trace to what the per-layer metrics and
the result line read: device time by kernel name, kernel launches, the
seconds in which the device ran anything, and the longest idle gaps by
what the host was doing."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple


def profile(run: Callable[[], None], torch) -> Dict[str, Any]:
    """``run()`` (which ends synchronised) under the profiler, CPU and CUDA
    activities; returns `summarise` of its events."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if card else [])
    if card:
        torch.cuda.synchronize()
    with _profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        if card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return summarise(prof.events(), window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarise(events, window_s: float) -> Dict[str, Any]:
    """``kernels`` {name: [launches, device seconds]}, ``launches``,
    ``busy_s`` (the union of the device's operations), ``window_s``,
    ``device_ops`` and ``idle_gaps`` (at most 10 each, [name, seconds],
    largest first; a gap is named by the innermost host operation running
    when it starts)."""
    from torch.autograd import DeviceType
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    device: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, int, str]] = []
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            k = kernels[ev.name]
            k[0] += 1
            k[1] += (e - s) / 1e6
            device.append((s, e))
        elif ev.device_type == DeviceType.CPU:
            host.append((s, e, -(e - s), ev.name))
    busy = _union(device)
    busy_s = sum(e - s for s, e in busy) / 1e6
    # idle gaps between the device's busy spans, each named by the
    # innermost host event open at its start: a sweep over the host
    # events in order of start, keeping the open ones on a stack
    host.sort()
    gaps: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[float, float, int, str]] = []
    i = 0
    for (_s0, e0), (s1, _e1) in zip(busy, busy[1:]):
        if s1 <= e0:
            continue
        while i < len(host) and host[i][0] <= e0:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= e0:
            stack.pop()
        gaps[stack[-1][3] if stack else "host idle"] += (s1 - e0) / 1e6
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "kernels": {k: list(v) for k, v in kernels.items()},
        "launches": int(sum(v[0] for v in kernels.values())),
        "busy_s": busy_s,
        "window_s": window_s,
        "device_ops": [[k[:120], v[1]] for k, v in ranked[:10]],
        "idle_gaps": [[k[:120], v] for k, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


def kernel_seconds(summary: Dict[str, Any], part: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``part``."""
    n, s = 0, 0.0
    for name, (calls, secs) in summary["kernels"].items():
        if part in name:
            n += calls
            s += secs
    return n, s
