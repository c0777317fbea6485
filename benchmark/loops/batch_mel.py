"""Closed-loop batch classification through the mel front end: loops/
batch.py's loop (step after step, each classifying `utterances_per_step`
utterances of a pool staged on the device in set-up, the predictions of
every step on the host before the next starts) checked against
reference/mel.py in place of engines.Batch. Under --control the program's
place goes to that reference's own control.

The program counts the frames its STFT transformed (lsm_tpu_torch.ops.
stft.counts): the run fails unless the window's count is steps x
utterances x frames an utterance, and fails at once on a program that
keeps no such count.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.lib import check, corpus, model, trace
from benchmark.loops.batch import shape
from benchmark.reference import mel


def frame_counter():
    """The program's STFT counter (a Counter with `frames`); raises on a
    program that keeps none."""
    from lsm_tpu_torch.ops import stft

    counts = getattr(stft, "counts", None)
    if counts is None:
        raise RuntimeError("the program counts no STFT frames (lsm_tpu_torch.ops.stft.counts)")
    return counts


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    rows = tr["utterances_per_step"]
    counter = None if ctx.control else frame_counter()
    with corpus.Pool(tr["corpus"], tr["pool_parts"], tr["per_class"], cfg["classes"],
                     ctx.seed, ctx.workers) as pool:
        weights = model.make(cfg, ctx.seed, dev)
        ctx.sync()
        t_weights = time.time() - ctx.started
        if ctx.control:
            prog = mel.Batch(cfg, weights, dev, lower=True)
        else:
            prog = ctx.program("batch", cfg, weights)
        audio = torch.as_tensor(pool.result()).to(dev)
    print(f"set-up: weights at {t_weights:.2f} s, program and pool at "
          f"{time.time() - ctx.started:.2f} s of the process", file=sys.stderr)
    n_slices = audio.shape[0] // rows
    slices = [audio[i * rows:(i + 1) * rows] for i in range(n_slices)]
    k_check = int(np.random.default_rng(corpus.part_seed(ctx.seed, 1 << 21))
                  .integers(0, tr["check_range"]))

    held = []
    for i in range(tr["warmup_steps"]):   # every shape; all held, more than the window keeps
        out = prog.step(slices[i % n_slices])
        out["preds"].cpu()
        held.append(out)
    del held, out
    ctx.sync()
    ctx.reset_peak()
    events = None
    if ctx.trace:
        make = torch.cuda.Event if dev.type == "cuda" else trace.HostEvent
        events = [[make(enable_timing=True) for _ in range(4)]
                  for _ in range(tr["max_traced_steps"])]

    setup_s = time.time() - ctx.started
    steps, kept, last, host_preds = 0, {}, None, []
    mallocs = ctx.device_allocations()
    frames_before = counter["frames"] if counter is not None else 0
    with ctx.profile as prof:
        t0 = time.perf_counter()
        while True:
            ev = events[steps] if events and steps < len(events) else None
            out = prog.step(slices[steps % n_slices], ev)
            host_preds.append(out["preds"].cpu())
            if steps == k_check:
                kept[steps] = out
            last = out
            steps += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    memory = ctx.memory_peak()
    print(f"device allocations (cudaMalloc) in the window: "
          f"{ctx.device_allocations() - mallocs}", file=sys.stderr)
    kept[steps - 1] = last
    del last, out, prog
    result = {"attempted": steps * rows, "failed": 0, "setup_s": setup_s,
              "memory_peak_bytes": memory, "e2e": {"utt_per_s": steps * rows / window_s}}

    ref = mel.Batch(cfg, weights, dev)
    n_frames = ref.frontend.n_frames
    if counter is not None:
        frames = counter["frames"] - frames_before
        print(f"STFT frames in the window: {frames}", file=sys.stderr)
        if frames != steps * rows * n_frames:
            raise RuntimeError(f"the program transformed {frames} STFT frames in the window, "
                               f"not {steps} steps x {rows} x {n_frames}")
    readings, fired = [], []
    for s, out in sorted(kept.items()):
        a = slices[s % n_slices]
        ref_spikes = ref.spikes(a)
        ref_feats = ref.features(ref_spikes)
        readings.append(check.batch_numbers(
            {**out, "preds": host_preds[s]}, ref_spikes, ref.features(out["spikes"]),
            ref.logits(out["features"]), torch.argmax(ref.logits(ref_feats), dim=-1)))
        if ctx.trace:
            fired.append(ref.fired(ref_spikes))
        del ref_spikes, ref_feats
    result["numbers"] = check.worst(readings)
    if ctx.trace:
        ctx.sync()
        n_ev = min(steps, len(events))
        stage = np.array([[e[i].elapsed_time(e[i + 1]) for i in range(3)] for e in events[:n_ev]])
        f = cfg["frontend"]
        result["run"] = {
            "trace": prof.reduce(window_s), "cell_kind": "batch", "steps": steps,
            "utterances": steps * rows,
            "stage_ms": dict(zip(("frontend", "reservoir", "readout"), stage.mean(axis=0))),
            "shape": {**shape(cfg, weights), "filterbank": f["filterbank"],
                      "n_fft": f["n_fft"], "frames": n_frames, "mel_taps": ref.frontend.taps()},
            "rec_rows_per_utt": sum(r for r, _ in fired) / (rows * len(fired)),
            "in_rows_per_utt": sum(i for _, i in fired) / (rows * len(fired)),
            "samples": ref.frontend.n_samples,
        }
    return result
