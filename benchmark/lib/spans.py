"""The program's own spans in a traced window (lsm_tpu_torch/utils/
profiling.py's `span`: `record_function` ranges named `lsm.*`), reduced
from the same kineto events that `trace.Profile.reduce` walks.

Per span name, over the spans of the main thread (the thread that holds
the most of them), where a moment belongs to the innermost `lsm.` span
open then:

  count     the spans of that name;
  dev_s     device seconds of every operation whose launching runtime call
            (matched by correlation id) ran while that span was the
            innermost, wherever on the device's timeline the operation ran;
  idle_s    device-idle seconds while that span was the innermost: every
            idle stretch is split at span boundaries, not put down whole;
  launches  kernel launches, copies and sets (`cudaLaunchKernel*`,
            `cuLaunchKernel*`, `cudaMemcpy*`, `cudaMemset*`) issued while
            that span was the innermost;

and the last three under `*_total` for the span with everything nested in
it. Beside them: `outside_dev_s` (device time launched outside every span,
or by a call the window does not hold), `early` (operations that started
before the span that launched them did) and `lead_s` (the most that an
operation's start precedes its own launching call's: both 0 where the
host's and the device's timelines share one clock), and `device` (False
where the window holds no device activity, as on the CPU).

`of_run(run)` reduces the window that the run's `trace.Profile` recorded,
once per run, and keeps the result in `run["trace"]["spans"]`. The readers
in metrics/ divide by the run's hops (serve) or steps (batch), each
checked against the count of the span that opens it.
"""

from __future__ import annotations

import bisect
import gc
from collections import defaultdict

from benchmark.lib import trace

LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
FIELDS = ("dev_s", "idle_s", "launches")
UNIT_SPAN = {"serve": ("lsm.kws.step", "hops"), "batch": ("lsm.frontend", "steps")}


def events_of(kineto_results) -> dict:
    """Kineto events as plain tuples: `spans` (start, end, name, thread),
    `calls` (start, name, correlation id) of the CUDA runtime and driver,
    `device` (start, end, correlation id); seconds."""
    from torch.autograd import DeviceType

    spans, calls, device = [], [], []
    for e in kineto_results.events():
        start = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():       # a span's shadow on the GPU timeline
                device.append((start * 1e-9, (start + e.duration_ns()) * 1e-9,
                               e.correlation_id()))
            continue
        name = e.name()
        if name.startswith("lsm."):
            spans.append((start * 1e-9, (start + e.duration_ns()) * 1e-9, name,
                          e.start_thread_id()))
        elif name.startswith("cu") and "::" not in name:
            calls.append((start * 1e-9, name, e.correlation_id()))
    return {"spans": spans, "calls": calls, "device": device}


def innermost(spans) -> list:
    """Properly nested (start, end, name) spans of one thread -> the
    stretches that cover them, in time order: (start, end, start of the
    innermost span, names of the open spans, innermost first)."""
    out, stack, pos = [], [], None

    def stretch_to(t):
        if stack and t > pos:
            out.append((pos, t, stack[-1][0], tuple(s[2] for s in reversed(stack))))

    def close_until(t):
        nonlocal pos
        while stack and stack[-1][1] <= t:
            stretch_to(stack[-1][1])
            pos = max(pos, stack.pop()[1])

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        stretch_to(a)
        pos = a
        stack.append((a, b, name))
    close_until(float("inf"))
    return out


def reduce(ev: dict) -> dict:
    """The reduction of `events_of`'s tuples (module docstring)."""
    by_thread = defaultdict(list)
    for a, b, name, tid in ev["spans"]:
        by_thread[tid].append((a, b, name))
    main = max(by_thread.values(), key=len) if by_thread else []
    stretches = innermost(main)
    starts = [s[0] for s in stretches]

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        return stretches[i] if i >= 0 and t < stretches[i][1] else None

    out = defaultdict(lambda: dict.fromkeys(
        ("count",) + FIELDS + tuple(f"{f}_total" for f in FIELDS), 0))

    def add(stretch, field, value):
        names = stretch[3]
        out[names[0]][field] += value
        for name in set(names):
            out[name][f"{field}_total"] += value

    for _, _, name in main:
        out[name]["count"] += 1

    launcher = {}
    for t, name, corr in ev["calls"]:
        s = at(t)
        launcher[corr] = (s, t)
        if s is not None and name.startswith(LAUNCH_PREFIXES):
            add(s, "launches", 1)

    outside, early, lead = 0.0, 0, 0.0
    for a, b, corr in ev["device"]:
        s, t = launcher.get(corr, (None, None))
        if s is None:
            outside += b - a
            continue
        add(s, "dev_s", b - a)
        early += a < s[2]
        lead = max(lead, t - a)

    busy = [(a, b) for a, b, _ in ev["device"]]
    if busy and stretches:
        gaps = trace._gaps(busy, stretches[0][0], stretches[-1][1])
        i = 0
        for s in stretches:                      # both in time order
            while i < len(gaps) and gaps[i][1] <= s[0]:
                i += 1
            j = i
            while j < len(gaps) and gaps[j][0] < s[1]:
                add(s, "idle_s", min(gaps[j][1], s[1]) - max(gaps[j][0], s[0]))
                j += 1
    return {"spans": {k: dict(v) for k, v in out.items()}, "outside_dev_s": outside,
            "early": early, "lead_s": lead, "device": bool(ev["device"])}


def _profile() -> "trace.Profile | None":
    """The harness's Profile that recorded last (the run's traced window).
    The readers get the run's reduced trace alone, which holds no events;
    the Profile that recorded them lives on until the run has printed its
    line."""
    gc.collect()
    done = [o for o in gc.get_objects() if type(o) is trace.Profile and o.prof is not None]
    if not done:
        return None
    return max(done, key=lambda p: p.prof.profiler.kineto_results.trace_start_ns())


def of_run(run: dict) -> dict | None:
    """The reduction of the run's traced window, kept in its trace."""
    tr = run["trace"]
    if "spans" not in tr:
        prof = _profile()
        tr["spans"] = None if prof is None else reduce(events_of(prof.prof.profiler.kineto_results))
    return tr["spans"]


def per_unit(run: dict, name: str, field: str, scale: float = 1e3):
    """`field` of span `name` per hop (serve) or step (batch), times
    `scale`: None where the program opens no spans (its unit span never
    shows) or the window holds no device activity (`dev_s`, `idle_s` and
    `launches` are the card's). A unit span whose count is not the run's
    hops or steps fails loudly."""
    red = of_run(run)
    unit, key = UNIT_SPAN[run["cell_kind"]]
    if red is None or unit not in red["spans"]:
        return None
    if red["spans"][unit]["count"] != run[key]:
        raise RuntimeError(f"{red['spans'][unit]['count']} {unit} spans in the traced window, "
                           f"but the run made {run[key]} {key}")
    if not red["device"]:
        return None
    return scale * red["spans"].get(name, {}).get(field, 0.0) / run[key]
