"""Shares of the card's peak: a kernel's roofline and the whole step's.

A piece of work's least time is the largest of its tensor-core flops at
the bf16 tensor-core peak, its float32 flops at the float32 peak and its
bytes at the memory rate (counts/peaks.json). Its share is that least time
over the device time it took, so it cannot pass 100 % unless the counts
claim work that was not done. Each kernel's counts are counts/<kernel>.py:
`KERNELS`, the names its device functions carry, and `work(run)`, the
counted work of the traced window, or None where the cell does not run it.
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.lib import load_module
from benchmark.lib.trace import kernel_seconds

COUNTS = Path(__file__).resolve().parent.parent / "counts"


def peaks() -> dict:
    return json.loads((COUNTS / "peaks.json").read_text())


def least_s(work: dict) -> float:
    p = peaks()
    return max(work["tc"] / p["bf16_tensor_flops"], work["f32"] / p["f32_flops"],
               work["bytes"] / p["hbm_bytes_per_s"])


def counts(kernel: str):
    return load_module(COUNTS / f"{kernel}.py")


def share(run: dict, kernel: str):
    """A kernel's share of its roofline in %, or None where the cell does
    not run it or the trace holds none of its time."""
    mod = counts(kernel)
    work = mod.work(run)
    seconds = kernel_seconds(run["trace"], mod.KERNELS)
    if work is None or seconds <= 0.0:
        return None
    return 100.0 * least_s(work) / seconds


def step_share(run: dict, kernels, kind: str):
    """The whole step's share of the card's peak over the traced window, in
    %: the counted kernels' flops plus the readout's (the scaler's 2 and
    the product's 2 K flops per feature and row, float32), against the
    bytes the step must move: its input, its weights, its carried state in
    and out, its output."""
    if run["cell_kind"] != kind:
        return None
    works = [w for w in (counts(k).work(run) for k in kernels) if w is not None]
    if not works:
        return None
    sh = run["shape"]
    if kind == "batch":
        rows, times = run["utterances"], run["steps"]
        io = rows * run["samples"] * 4.0 + rows * 8.0
    else:
        rows, times = run["streams"] * run["hops"], run["hops"]
        io = rows * (run["chunk_len"] * 2.0 + 2 * sh["state_bytes_per_stream"]
                     + sh["classes"] * 4.0)
    readout = rows * sh["features"] * (2.0 + 2.0 * sh["classes"])
    readout_bytes = sh["features"] * (sh["classes"] + 2) * 4.0
    total = {"tc": sum(w["tc"] for w in works), "f32": sum(w["f32"] for w in works) + readout,
             "bytes": io + times * (sh["weight_bytes"] + readout_bytes)}
    return 100.0 * least_s(total) / run["trace"]["window_s"]
