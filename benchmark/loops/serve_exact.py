"""Closed-loop exact serving: `streams` streams, one `chunk_len` int16 wire
chunk each a hop, hop after hop, through the program's exact engine
(lsm_tpu_torch's StreamingKWS): every hop shifts each stream's trailing
window of num_samples samples and classifies the whole window again with
the batch path, so each hop's decision is the batch classifier's on the
stream's last second. The logits of every hop reach the host before the
next hop's chunk is cut. Warm-up plays `warmup_hops` hops (at least a
window's worth, so every window is full) and the timed window goes on
from there, with no reset.

Checked, each from the program's own window before the hop: the window's
first hop, one hop drawn from the seed in [check_from, check_from +
check_range), and its last hop. Their windows are kept by reference, no
copy: the engine makes a new window every hop. After the timed window
closes, the program's own stages (featurize_batch, extract_features, the
readout) run again on the program's window after each checked hop:

  window_mismatch     the program's window after the hop against the
                      reference's shift of the window before it and the
                      chunk (exact);
  spike_flips         the program's spikes against the reference's on
                      that window;
  feature_gap_median  the program's features against the reference
                      reservoir's on the program's spikes;
  pred_mismatch       the argmax of the logits the timed step returned
                      against the reference readout of the program's
                      features (exact);
  logit_gap_median    the same logits against the same readout: it also
                      fails if the stages run again did not reproduce
                      the hop.

Under --control the reference's exact hop one precision below the
configuration's (reference/exact.py `Control`) takes the program's place.
The run dict is a serving run's (`cell_kind` "serve", per hop) that also
carries the batch counts (`utterances` = hops x streams windows, `steps`
= hops, `samples`, `n_sub`, fired rows per window from the reference's
spikes on the checked windows), which counts/b1.py and counts/b2.py read.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.lib import check, corpus, model, spans, trace
from benchmark.loops import port
from benchmark.loops.batch import shape
from benchmark.loops.serve import WARMUP_HELD
from benchmark.reference import engines, exact
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models.frontend import featurize_batch
from lsm_tpu_torch.models.streaming import StreamingKWS
from lsm_tpu_torch.readout import scaler


class Port:
    """The program's exact engine over the benchmark's weights."""

    def __init__(self, config: dict, w: dict, streams: int, trace_on: bool = False):
        ro, sc = port.readout(w)
        self.kws = StreamingKWS(port.reservoir(config, w), ro, sc, port.frontend_config(config),
                                config["feature_set"], n_streams=streams)
        self.trace = trace_on

    def step(self, chunk):
        with trace.span("StreamingKWS.step", self.trace):
            return self.kws.step(chunk)

    def window(self) -> torch.Tensor:
        return self.kws.buffer

    def stages(self, window: torch.Tensor) -> dict:
        """The program's batch stages on `window`, as its hop runs them."""
        k = self.kws
        sp = featurize_batch(window, k.fcfg)
        f = res.extract_features(k.reservoir, sp, k.keys)
        return {"spikes": sp, "features": f, "logits": k.readout(scaler.transform(k.scaler_state, f))}


def program(ctx, config: dict, weights: dict, streams: int):
    if ctx.control:
        return exact.Control(config, weights, ctx.device, streams)
    if ctx.device.type == "cuda":
        port.build_kernels()
    return Port(config, weights, streams, ctx.trace)


def hop_numbers(before, after, chunk, logits, mine: dict, ref) -> tuple:
    """One checked hop's numbers, and the reference's spikes on the
    program's window."""
    ref_spikes = ref.spikes(after)
    ref_logits = ref.logits(mine["features"])
    timed = torch.as_tensor(logits, device=ref_logits.device)
    nums = check.batch_numbers(
        {**mine, "preds": torch.argmax(timed, dim=-1)}, ref_spikes, ref.features(mine["spikes"]),
        ref_logits, torch.argmax(ref.logits(ref.features(ref_spikes)), dim=-1))
    lg = check.rel_rows(timed, ref_logits)
    nums.update(
        window_mismatch=check.share_differ(after, exact.shift(before, chunk)),
        logit_gap_median=check.quantile(lg, 0.5), logit_gap_max=float(lg.max()),
        rerun_logit_gap_max=float(check.rel_rows(mine["logits"], timed).max()))
    return nums, ref_spikes


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n, chunk_len, warm = tr["streams"], tr["chunk_len"], tr["warmup_hops"]
    with corpus.Pool(tr["corpus"], tr["pool_parts"], tr["per_class"], cfg["classes"],
                     ctx.seed, ctx.workers) as pool:
        weights = model.make(cfg, ctx.seed, dev)
        ctx.sync()
        t_weights = time.time() - ctx.started
        prog = program(ctx, cfg, weights, n)
        wire = corpus.to_wire(pool.result())
    print(f"set-up: weights at {t_weights:.2f} s, program and pool at "
          f"{time.time() - ctx.started:.2f} s of the process", file=sys.stderr)
    sched = corpus.StreamSchedule(wire, n, chunk_len, tr["cycle_hops"], ctx.seed)
    rng = np.random.default_rng(corpus.part_seed(ctx.seed, 1 << 22))
    k_check = int(rng.integers(tr["check_from"], tr["check_from"] + tr["check_range"]))

    # Warm-up: every shape, full windows, and more windows alive at once
    # than the timed window keeps, so that the allocator calls no
    # cudaMalloc there.
    held = []
    for h in range(warm):
        prog.step(sched.chunk(h))
        held = (held + [prog.window()])[-WARMUP_HELD:]
    del held
    ctx.sync()
    ctx.reset_peak()

    setup_s = time.time() - ctx.started
    walls, kept = [], {}
    mallocs = ctx.device_allocations()
    with ctx.profile as prof:
        t0 = time.perf_counter()
        h = 0
        while True:
            with trace.span("harness: cut the hop's chunk", ctx.trace):
                chunk = sched.chunk(warm + h)
            before = prog.window()
            t = time.perf_counter()
            logits = prog.step(chunk)
            walls.append(time.perf_counter() - t)
            if h in (0, k_check):
                kept[h] = (before, prog.window(), logits)
            last = (h, before, logits)
            h += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    memory = ctx.memory_peak()
    print(f"device allocations (cudaMalloc) in the window: "
          f"{ctx.device_allocations() - mallocs}", file=sys.stderr)
    kept[last[0]] = (last[1], prog.window(), last[2])
    del last, before
    walls_ms = np.asarray(walls) * 1e3
    p95 = float(np.percentile(walls_ms, 95))
    print(f"hops {h}, hop wall median {float(np.median(walls_ms))!r} ms, p95 {p95!r} ms, "
          f"window {window_s!r} s", flush=True)
    result = {"attempted": h * n, "failed": 0, "setup_s": setup_s, "memory_peak_bytes": memory,
              "e2e": {"stream_chunks_per_s": h * n / window_s, "hop_ms_p95": p95}}

    ref = engines.Batch(cfg, weights, dev)
    readings, fired = [], []
    for hop, (before, after, logits) in sorted(kept.items()):
        chunk = torch.as_tensor(sched.chunk(warm + hop)).to(dev)
        nums, ref_spikes = hop_numbers(before, after, chunk, logits, prog.stages(after), ref)
        readings.append(nums)
        if ctx.trace:
            fired.append(ref.fired(ref_spikes))
        del ref_spikes
    del prog, kept
    result["numbers"] = check.worst(readings)
    if ctx.trace:
        f = cfg["frontend"]
        n_samples = int(f["sample_rate"] * f["duration"])
        n_sub = -(-n_samples // ref.frontend.g)
        result["run"] = run_dict = {
            "trace": prof.reduce(window_s), "cell_kind": "serve", "hops": h, "streams": n,
            "hop_walls_s": float(np.sum(walls)), "chunk_len": chunk_len,
            "shape": {**shape(cfg, weights), "state_bytes_per_stream": n_samples * 4},
            "utterances": h * n, "steps": h, "samples": n_sub * ref.frontend.g, "n_sub": n_sub,
            "rec_rows_per_utt": sum(r for r, _ in fired) / (n * len(fired)),
            "in_rows_per_utt": sum(i for _, i in fired) / (n * len(fired)),
        }
        print_coverage(run_dict)
    return result


def print_coverage(run_dict: dict) -> None:
    """The hop's stages' device time against the traced busy time (stderr),
    where the program opens the spans and the window holds device time."""
    red = spans.of_run(run_dict)
    step = (red or {}).get("spans", {}).get("lsm.kws.step")
    if step is None or not red["device"]:
        return
    busy = run_dict["trace"]["busy_s"]
    stages = {k: red["spans"].get(k, {}).get("dev_s_total", 0.0) for k in (
        "lsm.kws.ingest", "lsm.kws.window", "lsm.frontend", "lsm.reservoir", "lsm.kws.readout",
        "lsm.kws.egress")}
    print(f"span coverage: {step['count']} lsm.kws.step; the stages' device time "
          f"{sum(stages.values())!r} s, the step's own {step['dev_s']!r} s, outside every span "
          f"{red['outside_dev_s']!r} s, against busy {busy!r} s "
          f"({100.0 * sum(stages.values()) / busy:.2f} %); by stage (s): {stages}", file=sys.stderr)
