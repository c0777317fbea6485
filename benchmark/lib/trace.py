"""Clocks and the reduction of a profiler trace to what the per-layer
metrics read.

`process_start()` is the moment this process was created (from
/proc/self/stat), the start of `setup_s`. `Profile` wraps torch.profiler
over a traced window (CPU and CUDA activity) and reduces its raw events
to: the union of device activity (`busy_s`, the way
lsm_tpu_torch/tools' and chip_smoke.py's `union_us` takes it, copied
here), device seconds by operation name, and the device's idle gaps, each
attributed to the innermost host operation that was running at the gap's
middle. The loops name their own steps with `span` (the harness's spans
around the calls into the program), so a gap in the program's Python
shows under the call it fell in.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


def process_start() -> float:
    """time.time() at which this process started."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])                      # starttime, field 22 of stat(5)
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _gaps(intervals, lo: float, hi: float):
    """The idle (start, end) stretches between lo and hi."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class Profile:
    """torch.profiler over the traced window; `reduce()` after it closed."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            import torch

            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def reduce(self, window_s: float) -> dict:
        """busy_s, window_s, device seconds by name, the 10 device
        operations with the most time, and the idle device time summed by
        the innermost host operation of the main thread running at each
        gap's middle ("python" where none was: the interpreter between
        operations)."""
        from torch.autograd import DeviceType

        dev, host = [], defaultdict(list)
        for e in self.prof.profiler.kineto_results.events():
            start, end = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():       # a span's shadow on the GPU timeline
                    dev.append((start, end, e.name()))
            elif e.device_type() == DeviceType.CPU and e.duration_ns() > 0:
                host[e.start_thread_id()].append((start, end, e.name()))
        by_name = defaultdict(float)
        for a, b, name in dev:
            by_name[name] += b - a
        busy = union_s((a, b) for a, b, _ in dev)
        idle = defaultdict(float)
        main = max(host.values(), key=len) if host else []
        if dev and main:
            main.sort()
            gaps = _gaps([(a, b) for a, b, _ in dev], main[0][0], max(b for _, b, _ in main))
            stack, i = [], 0
            for a, b in gaps:                            # gaps come in time order
                mid = 0.5 * (a + b)
                while i < len(main) and main[i][0] <= mid:
                    stack.append(main[i])
                    i += 1
                while stack and stack[-1][1] < mid:      # nested spans: pop the finished
                    stack.pop()
                idle[stack[-1][2] if stack else "python"] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": window_s, "device_s_by_name": dict(by_name),
                "device_ops": [[k[:200], v] for k, v in top],
                "idle_gaps": [[k[:200], v] for k, v in gaps]}


def span(name: str, enabled: bool):
    """A named host span in the trace (record_function), or nothing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class HostEvent:
    """torch.cuda.Event's record/elapsed_time on the host clock, for runs
    without a card (the CPU tests)."""

    def __init__(self, **_):
        self.t = None

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


def kernel_seconds(trace: dict, names) -> float:
    """Device seconds of the operations whose names contain any of `names`."""
    return sum(s for k, s in trace["device_s_by_name"].items() if any(n in k for n in names))
