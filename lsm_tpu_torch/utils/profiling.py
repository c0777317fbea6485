"""Stage timers and traces (port of lsm_tpu/utils/profiling.py).

`Profiler.stage` wraps a block in a `torch.profiler.record_function` span
(it shows in a trace) and times it on the host clock; `device_timer`
synchronizes the card on both sides of the block, so the time covers the
device work it enqueued; `perfetto_trace` records the block with
`torch.profiler` and writes a Chrome/Perfetto trace file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, Optional

import torch


@dataclasses.dataclass
class StageTiming:
    name: str
    seconds: float
    items: Optional[int] = None

    @property
    def rate(self) -> Optional[float]:
        if self.items is None or self.seconds <= 0:
            return None
        return self.items / self.seconds


class Profiler:
    """Collects named stage timings, each a record_function span."""

    def __init__(self) -> None:
        self.timings: Dict[str, StageTiming] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: Optional[int] = None) -> Iterator[None]:
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.timings[name] = StageTiming(name, dt, items)

    def report(self) -> str:
        lines = []
        for t in self.timings.values():
            rate = f" ({t.rate:.1f}/s)" if t.rate else ""
            lines.append(f"{t.name}: {t.seconds:.3f}s{rate}")
        return "\n".join(lines)


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(device: torch.device | str = "cuda") -> Iterator[Dict[str, float]]:
    """Times a block on the host clock, synchronizing `device` before and
    after (a CPU device needs no sync). Yields a dict that holds "seconds"
    after the block."""
    dev = torch.device(device)
    out: Dict[str, float] = {}
    _sync(dev)
    t0 = time.perf_counter()
    yield out
    _sync(dev)
    out["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def perfetto_trace(path: str) -> Iterator[torch.profiler.profile]:
    """Record the enclosed block (host ops, and the card's kernels where
    CUDA is available) and write it to `path` as a Chrome/Perfetto JSON
    trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
