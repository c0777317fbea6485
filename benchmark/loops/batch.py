"""Closed-loop batch classification: step after step, each classifies
`utterances_per_step` utterances of a pool staged on the device in
set-up, cycling through the pool; the predictions of every step reach the
host before the next starts.

Checked: the step drawn from the seed among the first `check_range` and
the window's last step, their spikes, features and predictions held from
the window (the last step's are always held, so every step after the
first finds the allocator as warm-up left it).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.lib import check, corpus, model, trace
from benchmark.reference import engines


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    rows = tr["utterances_per_step"]
    with corpus.Pool(tr["corpus"], tr["pool_parts"], tr["per_class"], cfg["classes"],
                     ctx.seed, ctx.workers) as pool:
        weights = model.make(cfg, ctx.seed, dev)
        ctx.sync()
        t_weights = time.time() - ctx.started
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

    ref = engines.Batch(cfg, weights, dev)
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
            "shape": shape(cfg, weights),
            "rec_rows_per_utt": sum(r for r, _ in fired) / (rows * len(fired)),
            "in_rows_per_utt": sum(i for _, i in fired) / (rows * len(fired)),
            "samples": -(-int(f["sample_rate"] * f["duration"]) // ref.frontend.g)
            * ref.frontend.g,
            "n_sub": -(-int(f["sample_rate"] * f["duration"]) // ref.frontend.g),
        }
    return result


def shape(cfg: dict, w: dict) -> dict:
    """The sizes the counts read, from the configuration and the
    benchmark's weights."""
    r, f = cfg["reservoir"], cfg["frontend"]
    out = {"channels": f["n_filters"], "in_channels": f["n_filters"] * f["redundancy_factor"],
           "steps": f["time_bins"] * len(f["spike_thresholds"]), "neurons": r["num_neurons"],
           "outputs": r["num_output_neurons"], "classes": cfg["classes"],
           "features": len(cfg["feature_keys"]) * r["num_output_neurons"],
           "width": int(w["leak"].shape[0]), "c_pad": int(w["w_in"].shape[0])}
    if "w_blocks" in w:
        out["weight_bytes"] = w["w_blocks"].numel() * 2 + w["src_idx"].numel() * 4
        out["out_degree"] = float((w["w_blocks"] != 0).sum()) / r["num_neurons"]
    else:
        out["weight_bytes"] = w["w_rec"].numel() * 2
    out["weight_bytes"] += w["w_in"].numel() * 2 + w["leak"].numel() * 4
    out["in_fanout"] = float((w["w_in"] != 0).sum()) / out["in_channels"]
    return out
