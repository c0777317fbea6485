"""Closed-loop continuous serving: `streams` streams, one `chunk_len`
wire chunk each a hop, hop after hop, the logits of every hop on the host
before the next hop's chunk is cut. The engine is warmed up, then reset,
so the window starts from fresh streams.

Checked, each from the program's own state before the hop (the reservoir
is chaotic, benchmark/lib/check.py): the window's first hop (from a fresh
state, which the reference makes itself: the start), one hop drawn from
the seed past the first full analysis window, and the window's last hop.
The states of those hops are kept by reference, no copy: the engine
replaces its state every hop, and warm-up holds more.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.lib import check, corpus, model, trace
from benchmark.reference import engines

WARMUP_HELD = 8


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n, chunk_len, decay = tr["streams"], tr["chunk_len"], tr["norm_decay_db_per_bin"]
    with corpus.Pool(tr["corpus"], tr["pool_parts"], tr["per_class"], cfg["classes"],
                     ctx.seed, ctx.workers) as pool:
        weights = model.make(cfg, ctx.seed, dev)
        ctx.sync()
        t_weights = time.time() - ctx.started
        prog = ctx.program("serve", cfg, weights, streams=n, chunk_len=chunk_len, decay=decay)
        wire = corpus.to_wire(pool.result())
    print(f"set-up: weights at {t_weights:.2f} s, program and pool at "
          f"{time.time() - ctx.started:.2f} s of the process", file=sys.stderr)
    sched = corpus.StreamSchedule(wire, n, chunk_len, tr["cycle_hops"], ctx.seed)
    rng = np.random.default_rng(corpus.part_seed(ctx.seed, 1 << 22))
    k_check = int(rng.integers(tr["check_from"], tr["check_from"] + tr["check_range"]))

    # Warm-up: every shape, and more states alive at once than the window
    # keeps (the checked hops' and the last), so that the allocator has
    # cached the blocks the window asks for and calls no cudaMalloc there.
    held = []
    for h in range(tr["warmup_hops"]):
        prog.step(sched.chunk(h))
        held = (held + [prog.state()])[-WARMUP_HELD:]
    del held
    prog.reset()
    ctx.sync()
    ctx.reset_peak()

    setup_s = time.time() - ctx.started
    walls, kept = [], {}
    last = None
    mallocs = ctx.device_allocations()
    with ctx.profile as prof:
        t0 = time.perf_counter()
        h = 0
        while True:
            with trace.span("harness: cut the hop's chunk", ctx.trace):
                chunk = sched.chunk(h)
            before = prog.state()
            t = time.perf_counter()
            logits = prog.step(chunk)
            walls.append(time.perf_counter() - t)
            if h in (0, k_check):
                kept[h] = (before, prog.state(), logits)
            last = (h, before, logits)
            h += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    memory = ctx.memory_peak()
    print(f"device allocations (cudaMalloc) in the window: "
          f"{ctx.device_allocations() - mallocs}", file=sys.stderr)
    kept[last[0]] = (last[1], prog.state(), last[2])
    del prog, last, before
    walls_ms = np.asarray(walls) * 1e3
    p95 = float(np.percentile(walls_ms, 95))
    print(f"hops {h}, hop wall median {float(np.median(walls_ms))!r} ms, p95 {p95!r} ms, "
          f"window {window_s!r} s", flush=True)
    result = {"attempted": h * n, "failed": 0, "setup_s": setup_s, "memory_peak_bytes": memory,
              "e2e": {"stream_chunks_per_s": h * n / window_s, "hop_ms_p95": p95}}

    ref = engines.Stream(cfg, weights, dev, chunk_len, decay)
    readings, rec_rows, in_rows = [], 0.0, 0.0
    for hop, (before, after, logits) in sorted(kept.items()):
        start = ref.init_state(n) if hop == 0 else before
        ref_after, ref_logits, rec, inp = ref.hop(start, torch.as_tensor(sched.chunk(hop)).to(dev))
        readings.append(check.hop_numbers(after, logits, ref_after, ref_logits,
                                          cfg["reservoir"]["membrane_threshold"]))
        rec_rows, in_rows = rec_rows + rec, in_rows + inp
        del ref_after, ref_logits
    result["numbers"] = check.worst(readings)
    if ctx.trace:
        from benchmark.loops.batch import shape

        f = cfg["frontend"]
        st = ref.init_state(1)
        state_bytes = sum(t.numel() * t.element_size() for k, t in st.items() if k != "segs")
        state_bytes += sum(t.numel() * t.element_size() for t in st["segs"].values())
        result["run"] = {
            "trace": prof.reduce(window_s), "cell_kind": "serve", "hops": h, "streams": n,
            "hop_walls_s": float(np.sum(walls)), "chunk_len": chunk_len,
            "t_c": ref.t_c, "n_new_win": ref.n_new_win, "n_sub": chunk_len // ref.frontend.g,
            "shape": {**shape(cfg, weights), "state_bytes_per_stream": state_bytes},
            "rec_rows_per_stream_hop": rec_rows / (n * len(kept)),
            "in_rows_per_stream_hop": in_rows / (n * len(kept)),
            "channels": f["n_filters"],
        }
    return result
