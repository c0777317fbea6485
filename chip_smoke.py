#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lsm_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   - compile the CUDA kernels from lsm_tpu_torch/csrc with nvcc;
               print the build time and the card's name and power limit.
  2. kernels - each kernel against its plain PyTorch twin on the card at
               main-path shapes (B1: 256 x 1 s of audio; B2: B=256, C=128,
               N=1000, T=400), with CUDA-event times after warm-up. B2's
               statistics must be bit-equal on dyadic weights; B1 is held
               at rtol 5e-3 / atol 1e-6, and against the float64 cascade
               (the twin's block form in float64): on the sub-block
               energies at >= 1e-4 of their (row, channel) peak its largest
               relative error must stay <= 1e-3 in every channel and its
               worst channel no worse than the twin's.
  3. slice   - lsm_tpu_torch.pipeline.run_pipeline_arrays on the frozen hard
               corpus (30 x 12, seed 42, batch 64): regime EDGE OF CHAOS,
               accuracy inside the band (0.76, 0.90), and both kernels'
               launch counters > 0 for this run.
  4. hot     - the inference path at 2400 synthetic utterances with the
               audio already on the card: featurize, extract, scale,
               predict; utterances/s beside the card's name and power limit.
  5. chunk kernels - B3 and B4 against their plain twins at serving shapes
               (1024 streams, one 100 ms hop from a carried state, flagship
               config): B3 at rtol 5e-3 / atol 1e-6 (its state, which
               passes through zero, at atol 1e-5) and against float64 as
               B1 is, and ten chained B3 hops bit-equal to one whole-second
               B3 call and to B1; B1 and B3 at the sub-block lengths g = 40
               (FrontendConfig(sample_rate=8000)) and g = 160
               (gt_window_time=0.03): featurize_batch on the card against
               the CPU path, B1 and B3 against their twins, B3's chained
               hops bit-equal; B4 bit-equal on dyadic weights. CUDA-event
               times; B1/B3's bound counts Slaney's cascade.
  6. continuous slice - the band protocol of tests/test_continuous_band.py
               through the port: run_pipeline_arrays on the hard corpus
               (20 x 12, seed 42, batch 64) for the exact accuracy, then
               fit_continuous_readout and carry-in serving of the test split
               through ContinuousKWS in 100 ms chunks: matched accuracy
               >= 0.60 and exact - matched <= 0.15; B3 and B4 launched.
  7. serving - ContinuousKWS.step at 1024 streams (flagship reservoir of
               phase 6), int16 wire, after one 1 s window of warm-up, state
               carried: host wall per hop (median, min), stream-chunks/s,
               real-time factor, CUDA-event stage split, device busy share
               and top device ops from torch.profiler, peak memory; B4's
               time and bound at the serving weights from the carried
               state (the kernels line takes these).
  8. sparse kernels - BASELINE configs[3] width (N=10240, k=2048, R=4,
               C=128, T=400), weights calibrated at multiplier 1.6 on the
               phase-2 spikes: B5 bit-equal to its twin on the dyadic copy
               at B=32 and B=70 (a ragged stream tile), timed at B=256 on
               the calibrated weights, where its spikes a row-step and
               its participation must stay within 1e-3 of the twin's (the
               tensor cores may sum in another order, so the bits may
               part); B6 over three chained chunks of 64,
               70 and 390 streams (64- and 128-stream tiles, ragged),
               bit-equal on the dyadic copy; the dense B2 and B4 at N=2048
               (past one thread a neuron) bit-equal on dyadic weights; dense
               B2/B4 with more input channels than padded neurons (C = 256
               at 100 neurons, C = 2048 at 1000: redundancy 16), and the
               block body (B5, B6, dense B2/B4 at 2048) at refractory 300,
               past its 8-bit counter, all bit-equal on dyadic weights.
               B5 and B6 also report the tensor-core bound: the stream-
               tiled design's own block products at the 989 TFLOP/s bf16
               dense peak, beside the function's bound.
  9. sparse slice - the N=1024 dense/sparse parity oracle of
               tests/test_sparse_reservoir.py (both EDGE OF CHAOS, accuracy
               in [0.66, 0.95], within 0.15), then run_pipeline_arrays at
               configs[3] full width, multiplier 1.6, on the hard corpus
               (30 x 12): diagnostics, accuracy and wall recorded (the
               regime is not gated: the port draws its own weights);
               finite features, B1 and B5 launched.
 10. sparse serving - phase 7 with the phase-9 reservoir: 1024 streams at
               10240 neurons, B3 and B6 launched; B6's time and bound at
               the serving weights from the carried state, its tensor-core
               bound, and the share of a call the card idles between its
               kernels (profiled device time against the CUDA-event time).
               In phases 7 and 10 the chunk kernel's totals of carried
               spikes and output spike counts must stay within 1e-3 of
               the twin's on every hop of the cycle.

Each phase prints its seconds ("[time] ..."). A "[record] {...}" line
holds every number of the run as JSON. The
second-to-last stdout line is a JSON object with each kernel's launches
(from the phase that drives its path), error against its twin, times and
bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import torch

ACC_BAND = (0.76, 0.90)       # tests/test_accuracy_band.py, frozen
CONT_MIN_ACC, CONT_MAX_DELTA = 0.60, 0.15   # tests/test_continuous_band.py, frozen
CHUNK = 1600                  # 100 ms hops
N_SERVE = 1024                # serving streams
# Published H100 SXM peaks (NVIDIA data sheet) for the bounds: float32 on
# the CUDA cores, HBM3 bandwidth, and bf16 on the tensor cores (dense).
F32_FLOPS, HBM_BYTES_S, BF16_TC_FLOPS = 67e12, 3.35e12, 989e12
# BASELINE.json configs[3], the scaled block-sparse reservoir: 10240
# neurons, k = 0.1 N * 2, at the multiplier docs/VALIDATION.md's configs[3]
# sweep found at the edge of chaos (lsm_tpu's draws).
N_10K, K_10K, MULT_10K = 10240, 2048, 1.6
SPARSE_ACC_RANGE, SPARSE_MAX_DELTA = (0.66, 0.95), 0.15   # tests/test_sparse_reservoir.py
# On weights that are not dyadic a kernel may sum a drive in another order
# than its twin, so their bits may part; their spike totals (and B5's
# participation, a fraction of the neurons) may not move apart by more.
SPIKE_REL = 1e-3
# B1/B3 against the float64 cascade: the largest relative error of a
# channel's sub-block energies at >= 1e-4 of their peak.
F64_REL = 1e-3
# The device functions of one B5/B6 call (csrc/sparse_lif.cu), as the
# profiler names them.
SPARSE_LIF_KERNELS = ("block_step_kernel", "transpose_blocks_kernel", "pack_input_kernel",
                      "load_state_kernel", "store_state_kernel", "stats_kernel")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_no_reference() -> None:
    """The port runs alone: neither jax nor the JAX package lsm_tpu may have
    been loaded into this process."""
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "lsm_tpu"))
    if loaded:
        fail(f"the reference stack was imported: {loaded[:8]}")


def bound(flops: float, n_bytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the f32 peak and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, n_bytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": n_bytes}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def gtgram_flops(batch: int, channels: int, samples: int) -> float:
    """B1/B3's function, Slaney's four-section cascade, per (row, channel,
    sample): a section is y = n0 x + s1 (1 FMA), s1' = n1 x - b1 y + s2
    (2 FMAs) and s2' = -b2 y (1 multiply), then 1 FMA for the energy: 17
    float32 instructions, each taking one FMA slot (2 flops of the peak)."""
    return 2.0 * 17 * batch * channels * samples


def gtgram_bound(wave, fb, *outs) -> dict:
    batch, samples = wave.shape
    return bound(gtgram_flops(batch, fb.coeffs.shape[0], samples),
                 nbytes(wave, fb.coeffs, *outs))


def float64_errors(e, e64, s=None, s64=None, twin=None) -> dict:
    """A gtgram kernel's (and its twin's) largest relative error against
    the float64 cascade, per channel, over the sub-block energies (n_sub,
    B, C) at >= 1e-4 of their (row, channel) peak; with s, s64 also the
    largest absolute error of the final state (B, 8, C). Fails when a
    channel of the kernel's exceeds 1e-3 or its worst channel is worse
    than the twin's."""
    keep = e64 >= 1e-4 * e64.amax(dim=0, keepdim=True)

    def per_channel(x):
        rel = (x.double() - e64).abs() / e64.clamp_min(1e-300)
        return torch.where(keep, rel, 0.0).amax(dim=(0, 1))

    k, t = per_channel(e), per_channel(twin)
    rec = {"kernel_worst": float(k.max()), "kernel_worst_channel": int(k.argmax()),
           "twin_worst": float(t.max()), "twin_worst_channel": int(t.argmax()),
           "kernel_by_channel": k.tolist(), "twin_by_channel": t.tolist()}
    if s is not None:
        rec["state_max_abs_err"] = float((s.double() - s64).abs().max())
    if rec["kernel_worst"] > F64_REL or rec["kernel_worst"] > rec["twin_worst"]:
        fail(f"against float64 the kernel's worst channel reads {rec['kernel_worst']:.3e} "
             f"(channel {rec['kernel_worst_channel']}; limit {F64_REL}, twin "
             f"{rec['twin_worst']:.3e})")
    return rec


def lif_flops(source_rows: float, batch: int, steps: int, n_neurons: int) -> float:
    """B2/B4: one add per (fired source row, neuron) for the drive, and the
    membrane update's multiply and add per (row, step, neuron), over the
    real neurons (not the padding)."""
    return float(source_rows) * n_neurons + 2.0 * batch * steps * n_neurons


def sparse_flops(rec_rows: float, in_rows: float, fanout: float, per_row: float,
                 batch: int, steps: int, n_neurons: int) -> float:
    """B5/B6: one add per recurrent edge of a neuron that fired (`per_row`:
    the true out-degree, ~k/2, or S * 128 for the stored block form), one
    per input edge of a channel that fired (`fanout`), and the membrane
    update's multiply and add per (row, step, neuron)."""
    return (float(rec_rows) * per_row + float(in_rows) * fanout
            + 2.0 * batch * steps * n_neurons)


def tensor_core_bound(batch: int, steps: int, n_neurons: int, slots: int,
                      channels: int) -> dict:
    """B5/B6's own work in the stream-tiled design: per (stream, step,
    destination block) a 128 x 128 block product for each of the S slots
    and each 128 input channels, at the bf16 tensor-core peak. A second
    figure beside the function's bound."""
    k_slices = slots + -(-channels // 128)
    flops = 2.0 * batch * steps * n_neurons * 128 * k_slices
    return {"tensor_core_flops": flops, "tensor_core_bound_ms": flops / BF16_TC_FLOPS * 1e3}


def sparse_degrees(sr) -> tuple:
    """(recurrent edges per source neuron, input edges per channel) of a
    SparseReservoir, counted from its nonzero weights."""
    return (float((sr.w_blocks != 0).sum()) / sr.n_neurons,
            float((sr.w_in != 0).sum()) / sr.n_channels)


def chunk_measure(hops, ops, kw, kernel, plain, flops) -> dict:
    """A chunk kernel (B4 or B6) against its plain twin over `hops`, a list
    of (x, (v, refrac, s_prev)) inputs: CUDA-event times and the bound, each
    the mean per hop, the bound from these hops' spikes. flops(rec_rows,
    in_rows, batch, steps): rec_rows are the carried spikes and every spike
    of steps 0..T-2 of the whole reservoir (the twin run with every neuron
    as an output counts them), in_rows every input spike. Also the largest
    relative gap, over the hops, between the kernel's and the twin's totals
    of the spikes carried out and of the output neurons' spike counts."""
    n_state = ops[-1].shape[0]
    n_flops = n_bytes = rows = spikes = gap = 0.0
    for x, carried in hops:
        out = kernel(x, *ops, *carried, **kw)
        all_n = plain(x, *ops, *carried, **{**kw, "n_outputs": n_state})
        no = out[3].shape[-1]
        for k, p in ((out[2].sum(), all_n[2].sum()),
                     (out[3][0].sum(), all_n[3][0][:, :no].sum())):
            gap = max(gap, abs(float(k) - float(p)) / max(float(p), 1.0))
        rec = float(carried[2].sum() + all_n[3][0].sum() - all_n[2].sum())
        rows += rec + float(x.sum())
        spikes += float(all_n[3][0].sum()) / (x.shape[0] * x.shape[-1])
        n_flops += flops(rec, float(x.sum()), x.shape[0], x.shape[-1])
        n_bytes += nbytes(x, *ops, *carried, *out)
    n = len(hops)

    def run(fn):
        return lambda: [fn(x, *ops, *carried, **kw) for x, carried in hops]

    return {
        "hops": n,
        "ms": cuda_ms(run(kernel), reps=max(1, 20 // n)) / n,
        "plain_ms": cuda_ms(run(plain), reps=1 if n > 1 else 3) / n,
        "source_rows": rows / n, "spikes_per_step": spikes / n,
        "spike_total_rel_gap": gap,
        **bound(n_flops / n, n_bytes / n),
    }


def chunk_kernel_of(reservoir) -> tuple:
    """(name, kernel, plain twin, flops(rec_rows, in_rows, batch, steps)) of
    the chunk kernel that serves `reservoir`: B4 dense, B6 block-sparse."""
    from lsm_tpu_torch.models.sparse import SparseReservoir
    from lsm_tpu_torch.ops.kernels import lif as klif
    from lsm_tpu_torch.ops.kernels import sparse_lif as ksp

    n = reservoir.n_neurons
    if isinstance(reservoir, SparseReservoir):
        edges, fan = sparse_degrees(reservoir)
        return ("B6", ksp.sparse_lif_chunk, ksp.sparse_lif_chunk_plain,
                lambda rec, inp, b, t: sparse_flops(rec, inp, fan, edges, b, t, n))
    return ("B4", klif.lif_chunk, klif.lif_chunk_plain,
            lambda rec, inp, b, t: lif_flops(rec + inp, b, t, n))


def union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def device_profile(run, calls: int, trace: str | None = None) -> dict:
    """torch.profiler over `calls` calls of run(): host wall, device-busy
    time (the union of the CUDA events' intervals) and its share of the
    wall, device events, and device time per kernel name (the top 15, and
    all of them in `device_us_by_name`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy = union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "calls": calls, "profiled_wall_s": wall, "n_device_events": len(dev),
        "device_busy_us": busy,
        "device_span_us": (max(b for _, b in spans) - min(a for a, _ in spans)) if spans else 0.0,
        "busy_share_of_wall": busy / (wall * 1e6),
        "device_us_total": sum(v[1] for v in by_name.values()),
        "top_device": [{"name": k[:120], "count": c, "us": us} for k, (c, us) in top],
        "device_us_by_name": {k: us for k, (_, us) in by_name.items()},
    }


def reset_launches() -> None:
    from lsm_tpu_torch.ops.kernels import gtgram as kgt
    from lsm_tpu_torch.ops.kernels import lif as klif
    from lsm_tpu_torch.ops.kernels import sparse_lif as ksp

    kgt.launches = kgt.chunk_launches = klif.launches = klif.chunk_launches = 0
    ksp.launches = ksp.chunk_launches = 0


def read_launches() -> dict:
    from lsm_tpu_torch.ops.kernels import gtgram as kgt
    from lsm_tpu_torch.ops.kernels import lif as klif
    from lsm_tpu_torch.ops.kernels import sparse_lif as ksp

    return {"B1": kgt.launches, "B2": klif.launches,
            "B3": kgt.chunk_launches, "B4": klif.chunk_launches,
            "B5": ksp.launches, "B6": ksp.chunk_launches}


def finite_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| where both are finite (first/last spike times hold
    +inf / -1 for silent neurons)."""
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float(torch.where(ok, (a.float() - b.float()).abs(), 0.0).max())


class Laps:
    """Seconds per phase, printed as each phase ends."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
        print(f"[time] phase {name}: {self.seconds[name]:.1f} s")


def hot_path(dev: torch.device) -> SimpleNamespace:
    """The 2400-utterance inference path (bench.py's hot row) at the
    flagship config: synthetic audio already on the card, a reservoir
    calibrated on it, a scaler and a logistic readout fitted on its
    features. `run()` featurizes, extracts, scales and predicts, and
    returns (predictions, features, spikes)."""
    from lsm_tpu_torch.config import FEATURE_SETS, PipelineConfig
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.models.calibration import calibrate_weight
    from lsm_tpu_torch.models.frontend import featurize_batch
    from lsm_tpu_torch.readout import logistic, scaler

    pcfg = PipelineConfig()
    fcfg, rcfg = pcfg.frontend, pcfg.reservoir
    keys = tuple(FEATURE_SETS[pcfg.feature_set])
    audio_np, labels_np = dataset.synthetic_audio_batch(n_per_class=200, n_classes=12, seed=42)
    audio = torch.as_tensor(audio_np).to(dev)
    labels = torch.as_tensor(labels_np, dtype=torch.int64).to(dev)
    spikes = featurize_batch(audio, fcfg)
    _, mw = calibrate_weight(rcfg, spikes, pcfg.multiplier)
    reservoir = res.init_reservoir(rcfg, fcfg.n_filters, mean_weight=mw, device=dev)
    feats = res.extract_features(reservoir, spikes, keys)
    sc = scaler.fit_scaler(feats)
    ro, _ = logistic.fit_logistic(scaler.transform(sc, feats), labels, len(pcfg.commands))

    def run():
        sp = featurize_batch(audio, fcfg)
        f = res.extract_features(reservoir, sp, keys)
        return logistic.predict(ro, scaler.transform(sc, f)), f, sp

    return SimpleNamespace(n=audio.shape[0], audio=audio, labels=labels, spikes=spikes,
                           reservoir=reservoir, scaler=sc, readout=ro, keys=keys, run=run)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        from lsm_tpu_torch.config import FEATURE_SETS, PipelineConfig
        from lsm_tpu_torch.io import dataset
        from lsm_tpu_torch.device import resolve_device
        from lsm_tpu_torch.ops import _build
        from lsm_tpu_torch.ops import gammatone as gt
        from lsm_tpu_torch.ops.kernels import gtgram as kgt
        from lsm_tpu_torch.ops.kernels import lif as klif
        from lsm_tpu_torch.models import reservoir as res
        from lsm_tpu_torch.models.calibration import calibrate_weight
        from lsm_tpu_torch.models.frontend import featurize_batch
        from lsm_tpu_torch.readout import logistic, scaler
        from lsm_tpu_torch import pipeline
    except ImportError as exc:
        fail(f"cannot import the port ({exc}); run from the repository root")
    check_no_reference()

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    print(card)

    # ---- 1. build ------------------------------------------------------
    laps = Laps()
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    record["build_s"] = time.perf_counter() - t0
    print(f"[build] {info['path']} nvcc {info['seconds']:.2f} s "
          f"(load {record['build_s']:.2f} s)")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}")

    pcfg = PipelineConfig()
    fcfg, rcfg = pcfg.frontend, pcfg.reservoir
    keys = tuple(FEATURE_SETS[pcfg.feature_set])
    laps("1 build")

    # ---- 2. kernels vs plain twins -------------------------------------
    audio_np, _ = dataset.synthetic_audio_batch_hard(22, 12, seed=7)
    audio = torch.as_tensor(audio_np[:256]).to(dev)               # (256, 16000)
    hop_time = fcfg.num_samples / (fcfg.sample_rate * fcfg.time_bins)
    nwin, hop, _ = gt.gtgram_strides(fcfg.sample_rate, fcfg.gt_window_time,
                                     hop_time, fcfg.num_samples)
    g = int(np.gcd(nwin, hop))
    fb = gt.filterbank(fcfg.sample_rate, fcfg.n_filters, fcfg.gt_f_min, g, dev)
    fb64 = gt.filterbank(fcfg.sample_rate, fcfg.n_filters, fcfg.gt_f_min, g, dev, torch.float64)
    e_k = kgt.sub_energy(audio, fb)
    e_p = kgt.sub_energy_plain(audio, fb)
    e_64 = kgt.sub_energy_plain(audio.double(), fb64)
    torch.cuda.synchronize()
    if not torch.isfinite(e_k).all():
        fail("B1 produced non-finite energies")
    b1_err = (e_k - e_p).abs()
    b1_rel = (b1_err / e_p.abs().clamp_min(1e-30)).flatten()
    b1 = {
        "max_abs_err": float(b1_err.max()),
        "p99_rel_err": float(torch.quantile(b1_rel[:: max(1, b1_rel.numel() // 2**24)], 0.99)),
        "allclose": bool(torch.allclose(e_k, e_p, rtol=5e-3, atol=1e-6)),
        "ms": cuda_ms(lambda: kgt.sub_energy(audio, fb), reps=10),
        "plain_ms": cuda_ms(lambda: kgt.sub_energy_plain(audio, fb), reps=3),
        **gtgram_bound(audio, fb, e_k),
    }
    print(f"[B1 gtgram] B=256 S=16000 C={fcfg.n_filters}: max_abs_err "
          f"{b1['max_abs_err']:.3e} p99_rel_err {b1['p99_rel_err']:.3e} "
          f"kernel {b1['ms']:.3f} ms plain {b1['plain_ms']:.3f} ms bound "
          f"{b1['bound_ms']:.3f} ms ({b1['bound_by']}) ({card})")
    if not b1["allclose"]:
        fail("B1 disagrees with its plain twin beyond rtol 5e-3 / atol 1e-6")
    b1["float64"] = f64 = float64_errors(e_k, e_64, twin=e_p)
    print(f"[B1 gtgram] against float64 at >= 1e-4 of each (row, channel) peak: kernel "
          f"worst {f64['kernel_worst']:.3e} (channel {f64['kernel_worst_channel']}), twin "
          f"worst {f64['twin_worst']:.3e} (channel {f64['twin_worst_channel']}); channels "
          "0-3 kernel " + " ".join(f"{v:.2e}" for v in f64["kernel_by_channel"][:4])
          + " twin " + " ".join(f"{v:.2e}" for v in f64["twin_by_channel"][:4]))
    del e_64

    spikes = featurize_batch(audio, fcfg)                          # (256, 128, 400)
    _, mw = calibrate_weight(rcfg, spikes, pcfg.multiplier)
    r_rand = res.init_reservoir(rcfg, fcfg.n_filters, mean_weight=mw, device=dev)
    ops, kw = r_rand.dyadic().kernel_operands()
    s_k, a_k = klif.lif_stats(spikes, *ops, **kw)
    s_p, a_p = klif.lif_stats_plain(spikes, *ops, **kw)
    torch.cuda.synchronize()
    equal = torch.equal(s_k, s_p) and torch.equal(a_k, a_p)
    finite = torch.isfinite(s_p) & torch.isfinite(s_k)
    b2_abs = float(torch.where(finite, (s_k - s_p).abs(), 0.0).max())
    b2_abs = max(b2_abs, float((a_k - a_p).abs().max()))
    ops_r, kw_r = r_rand.kernel_operands()
    f_k = res.features_from_stats(
        dict(zip(klif.STAT_KEYS, klif.lif_stats(spikes, *ops_r, **kw_r)[0].unbind(0)),
             n_win_used=float(rcfg.n_rate_windows)), keys)
    f_p = res.features_from_stats(
        dict(zip(klif.STAT_KEYS, klif.lif_stats_plain(spikes, *ops_r, **kw_r)[0].unbind(0)),
             n_win_used=float(rcfg.n_rate_windows)), keys)
    rand_rel = float(((f_k - f_p).abs() / f_p.abs().clamp_min(1e-6)).max())
    b2 = {
        "bit_equal_dyadic": bool(equal),
        "max_abs_err": b2_abs,
        "random_weight_feature_max_rel_err": rand_rel,
        "spikes_per_step": float(a_p.sum() / (256 * spikes.shape[-1])),
        "ms": cuda_ms(lambda: klif.lif_stats(spikes, *ops, **kw), reps=5),
        "plain_ms": cuda_ms(lambda: klif.lif_stats_plain(spikes, *ops, **kw), reps=2),
        # Source rows: every reservoir spike (the last step's, <= 1/T of
        # them, included) and every input spike.
        **bound(lif_flops(float(a_p.sum() + spikes.sum()), spikes.shape[0], spikes.shape[-1],
                          r_rand.n_neurons),
                nbytes(spikes, *ops, s_k, a_k)),
    }
    print(f"[B2 lif] B=256 C=128 N=1000 T=400 dyadic: bit_equal {equal} "
          f"max_abs_err {b2_abs:.3e}; random weights feature max rel err "
          f"{rand_rel:.3e}; kernel {b2['ms']:.3f} ms plain {b2['plain_ms']:.3f} ms ({card})")
    if not equal:
        fail("B2 statistics are not bit-equal to the plain twin on dyadic weights")
    record["B1"], record["B2"] = b1, b2
    laps("2 kernels")

    # ---- 3. the slice ---------------------------------------------------
    audio_h, labels_h = dataset.synthetic_audio_batch_hard(30, 12, seed=42)
    reset_launches()
    t0 = time.perf_counter()
    result, ext = pipeline.run_pipeline_arrays(
        PipelineConfig(batch_size=64), audio_h, labels_h, dev
    )
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if k in ("B1", "B2")}
    record["slice"] = {
        "seconds": slice_s, "accuracy": result.accuracy,
        "regime": ext.diagnostics.regime,
        "avg_participation": ext.diagnostics.avg_participation,
        "mean_weight": ext.mean_weight, "lbfgs_iters": result.n_iters,
        "launches": launches,
    }
    print(ext.diagnostics.render())
    print(result.report.render())
    print(f"[slice] hard corpus 360 utt: accuracy {result.accuracy:.4f} regime "
          f"{ext.diagnostics.regime} lbfgs_iters {result.n_iters} launches "
          f"{launches} wall {slice_s:.2f} s")
    if ext.diagnostics.regime != "EDGE OF CHAOS":
        fail(f"regime {ext.diagnostics.regime}")
    if not ACC_BAND[0] <= result.accuracy <= ACC_BAND[1]:
        fail(f"accuracy {result.accuracy:.4f} outside {ACC_BAND}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path was not launched: {launches}")
    laps("3 slice")

    # ---- 4. hot inference path at 2400 utterances ------------------------
    hp = hot_path(dev)
    n, audio, labels, spikes0, r_hot, hot = hp.n, hp.audio, hp.labels, hp.spikes, hp.reservoir, hp.run
    ro, sc = hp.readout, hp.scaler
    ops_h, kw_h = r_hot.kernel_operands()

    preds, feats, sp = hot()
    torch.cuda.synchronize()
    if tuple(feats.shape) != (n, len(keys) * rcfg.num_output_neurons) or \
            not torch.isfinite(feats).all() or tuple(sp.shape) != (n, 128, 400):
        fail(f"hot path output shapes {tuple(sp.shape)} {tuple(feats.shape)} or non-finite")
    fit_acc = float((preds == labels).float().mean())
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hot()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    sp = featurize_batch(audio, fcfg)
    ev[1].record()
    f = res.extract_features(r_hot, sp, keys)
    ev[2].record()
    logistic.predict(ro, scaler.transform(sc, f))
    ev[3].record()
    torch.cuda.synchronize()
    stages = {
        "featurize_ms": ev[0].elapsed_time(ev[1]),
        "extract_ms": ev[1].elapsed_time(ev[2]),
        "readout_ms": ev[2].elapsed_time(ev[3]),
    }
    hot_rec = {
        "n": n, "wall_s_min": min(walls), "wall_s_median": statistics.median(walls),
        "utt_per_s": n / min(walls), "utt_per_s_median": n / statistics.median(walls),
        "fit_accuracy": fit_acc, "stages": stages,
        "B1_ms_2400": cuda_ms(lambda: kgt.sub_energy(audio, fb), reps=3),
        "B2_ms_2400": cuda_ms(lambda: klif.lif_stats(spikes0, *ops_h, **kw_h), reps=3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    e_h = kgt.sub_energy(audio, fb)
    s_h, a_h = klif.lif_stats(spikes0, *ops_h, **kw_h)
    hot_rec["B1_bound_2400"] = gtgram_bound(audio, fb, e_h)
    hot_rec["B2_bound_2400"] = bound(
        lif_flops(float(a_h.sum() + spikes0.sum()), n, spikes0.shape[-1], r_hot.n_neurons),
        nbytes(spikes0, *ops_h, s_h, a_h))
    record["hot"] = hot_rec
    print(f"[hot] {n} utt audio-on-card -> predictions: {hot_rec['utt_per_s']:.1f} utt/s "
          f"(min of 5 walls {min(walls) * 1e3:.2f} ms, median "
          f"{statistics.median(walls) * 1e3:.2f} ms); stages "
          + " ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; B1 {hot_rec['B1_ms_2400']:.2f} ms B2 {hot_rec['B2_ms_2400']:.2f} ms "
          f"at B={n}; fit accuracy {fit_acc:.3f} ({card})")

    laps("4 hot")

    # ---- 5-7. the continuous engine --------------------------------------
    b3, b4 = chunk_kernels(dev, fb, fb64, r_rand.dyadic(), card)
    record["B3"], record["B4"] = b3, b4
    laps("5 chunk kernels")
    cont = continuous_slice(dev, card)
    record["continuous_slice"] = {k: v for k, v in cont.items() if k not in ("engine_args",)}
    laps("6 continuous slice")
    record["serving"] = serving(dev, *cont["engine_args"], card)
    laps("7 serving")
    timed = ("ms", "plain_ms", "bound_ms", "bound_by")
    b4_line = {**b4, **{k: record["serving"]["B4"][k] for k in timed}}

    # ---- 8-10. the block-sparse reservoir at configs[3] width ------------
    sk = sparse_kernels(dev, spikes, card)
    record["sparse_kernels"] = sk
    laps("8 sparse kernels")
    record["sparse_slice"], engine_10k = sparse_slice(dev, card)
    laps("9 sparse slice")
    record["sparse_serving"] = sserve = serving(dev, *engine_10k, card)
    laps("10 sparse serving")
    if min(sserve["launches"]["B3"], sserve["launches"]["B6"]) <= 0:
        fail(f"a kernel of the sparse serving path was not launched: {sserve['launches']}")
    b6_line = {**sk["B6"], **{k: sserve["B6"][k] for k in timed}}

    def row(name, key, source, replaces, rec, launches_):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_[key], "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None}

    # No single PyTorch call computes the IIR block scan or the spike-driven
    # LIF recurrence, so library_ms is null for all six.
    kernels = {"kernels": [
        row("gtgram_sub_energy", "B1", "lsm_tpu_torch/csrc/gtgram.cu",
            "lsm_tpu/ops/pallas/gtgram_kernel.py:70", b1, launches),
        row("lif_stats", "B2", "lsm_tpu_torch/csrc/lif.cu",
            "lsm_tpu/ops/pallas/lif_kernel.py:46", b2, launches),
        row("gtgram_chunk", "B3", "lsm_tpu_torch/csrc/gtgram.cu",
            "lsm_tpu/ops/pallas/gtgram_kernel.py:205", b3, cont["launches"]),
        row("lif_chunk", "B4", "lsm_tpu_torch/csrc/lif.cu",
            "lsm_tpu/ops/pallas/lif_chunk_kernel.py:39", b4_line, cont["launches"]),
        row("sparse_lif_stats", "B5", "lsm_tpu_torch/csrc/sparse_lif.cu",
            "lsm_tpu/ops/pallas/sparse_lif_kernel.py:54", sk["B5"],
            record["sparse_slice"]["launches"]),
        row("sparse_lif_chunk", "B6", "lsm_tpu_torch/csrc/sparse_lif.cu",
            "lsm_tpu/ops/pallas/sparse_lif_chunk_kernel.py:36", b6_line, sserve["launches"]),
    ]}
    record["phase_seconds"] = laps.seconds
    check_no_reference()
    print("[record] " + json.dumps(record))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def _dummy_readout(reservoir, keys, n_classes: int = 12):
    from lsm_tpu_torch.readout import logistic, scaler

    d = len(keys) * reservoir.n_outputs
    return (logistic.LogisticReadout(torch.zeros(d, n_classes), torch.zeros(n_classes)),
            scaler.Scaler(torch.zeros(d), torch.ones(d)))


def chunk_kernels(dev, fb, fb64, r_dy, card):
    """Phase 5: B3 and B4 against their plain twins at serving shapes, from
    the carried state of a flagship engine (dyadic weights) that has run a
    few hops of 1024 streams; B3 also against float64, and B1/B3 at the
    sub-block lengths 40 and 160 (`gtgram_other_g`)."""
    from lsm_tpu_torch.config import FEATURE_SETS, FrontendConfig
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.models.continuous import ContinuousKWS
    from lsm_tpu_torch.ops.kernels import gtgram as kgt
    from lsm_tpu_torch.ops.kernels import lif as klif

    fcfg = FrontendConfig()
    audio_np, _ = dataset.synthetic_audio_batch_hard(86, 12, seed=7)
    audio = torch.as_tensor(audio_np[:N_SERVE]).to(dev)             # (1024, 16000)
    C = fcfg.n_filters

    # B3 chaining: ten hops threading the state == one whole-second call,
    # whose energies are also B1's (another layout).
    zero = torch.zeros(N_SERVE, 8, C, device=dev)
    s_whole, e_whole = kgt.chunk(audio, fb, zero)
    st, parts, states = zero, [], []
    for c in range(10):
        st, e = kgt.chunk(audio[:, c * CHUNK:(c + 1) * CHUNK].contiguous(), fb, st)
        parts.append(e)
        states.append(st)
    e_b1 = kgt.sub_energy(audio, fb)
    torch.cuda.synchronize()
    chained = torch.equal(torch.cat(parts), e_whole) and torch.equal(st, s_whole)
    as_b1 = torch.equal(e_whole, e_b1)

    # B3 against its twin and float64 on one hop from a carried state.
    hop = audio[:, 3 * CHUNK:4 * CHUNK].contiguous()
    st3 = states[2]
    s_k, e_k = kgt.chunk(hop, fb, st3)
    s_p, e_p = kgt.chunk_plain(hop, fb, st3)
    s_64, e_64 = kgt.chunk_plain(hop.double(), fb64, st3.double())
    torch.cuda.synchronize()
    err = max(float((e_k - e_p).abs().max()), float((s_k - s_p).abs().max()))
    # Energies at B1's tolerance; the state passes through zero, so its
    # floor is 1e-5 against magnitudes ~0.4.
    close = bool(torch.allclose(e_k, e_p, rtol=5e-3, atol=1e-6)
                 and torch.allclose(s_k, s_p, rtol=5e-3, atol=1e-5))
    b3 = {
        "chained_bit_equal": bool(chained), "whole_equals_B1": bool(as_b1),
        "allclose": close, "max_abs_err": err,
        "ms": cuda_ms(lambda: kgt.chunk(hop, fb, st3), reps=20),
        "plain_ms": cuda_ms(lambda: kgt.chunk_plain(hop, fb, st3), reps=3),
        **gtgram_bound(hop, fb, st3, s_k, e_k),
        "float64": float64_errors(e_k, e_64, s_k, s_64, twin=e_p),
    }
    b3["float64"]["twin_state_max_abs_err"] = float((s_p.double() - s_64).abs().max())
    print(f"[B3 gtgram_chunk] B={N_SERVE} hop {CHUNK} C={C}: ten chained hops bit-equal "
          f"{chained}, = B1 {as_b1}; vs twin max_abs_err {err:.3e} allclose {close}; "
          f"kernel {b3['ms']:.3f} ms plain {b3['plain_ms']:.3f} ms bound "
          f"{b3['bound_ms']:.3f} ms ({b3['bound_by']}) ({card})")
    if not (chained and as_b1):
        fail("B3's chained hops are not bit-equal to the whole-second call / B1")
    if not close:
        fail("B3 disagrees with its plain twin beyond rtol 5e-3 / atol 1e-6 (state 1e-5)")
    f64 = b3["float64"]
    print(f"[B3 gtgram_chunk] against float64 at >= 1e-4 of each (row, channel) peak: "
          f"kernel worst {f64['kernel_worst']:.3e} (channel {f64['kernel_worst_channel']}), "
          f"twin worst {f64['twin_worst']:.3e} (channel {f64['twin_worst_channel']}); final "
          f"state max abs err kernel {f64['state_max_abs_err']:.3e} twin "
          f"{f64['twin_state_max_abs_err']:.3e}")
    b3["other_g"] = gtgram_other_g(dev, audio)

    # B4 on the spikes and LIF state of hop 6 of a warmed engine.
    keys = tuple(FEATURE_SETS["original"])
    kws = ContinuousKWS(r_dy, *_dummy_readout(r_dy, keys), fcfg, "original", N_SERVE)
    for c in range(5):
        kws._step_device(audio[:, c * CHUNK:(c + 1) * CHUNK].contiguous())
    state = kws.state
    x = kws._featurize(audio[:, 5 * CHUNK:6 * CHUNK].contiguous(), state)[0].contiguous()
    ops, kw = r_dy.kernel_operands()
    del kw["n_win"]
    kw.update(win_len=kws._win_len, n_new_win=kws._n_new_win)
    carried = (state.v, state.refrac, state.s_prev)
    out_k = klif.lif_chunk(x, *ops, *carried, **kw)
    out_p = klif.lif_chunk_plain(x, *ops, *carried, **kw)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    err = max(float(torch.where(torch.isfinite(b), (a.float() - b.float()).abs(), 0.0).max())
              for a, b in zip(out_k, out_p))
    # The dyadic copy fires far more than the serving weights do; the
    # kernels line takes B4's time and bound from phase 7's serving state.
    b4 = {"bit_equal_dyadic": bool(equal), "max_abs_err": err,
          "carried_spikes": float(state.s_prev.sum()),
          "dyadic": chunk_measure([(x, carried)], ops, kw, *chunk_kernel_of(r_dy)[1:])}
    dy = b4["dyadic"]
    print(f"[B4 lif_chunk] B={N_SERVE} T_c={x.shape[-1]} N=1000 dyadic, carried spikes "
          f"{b4['carried_spikes']:.0f}: bit_equal {equal} max_abs_err {err:.3e}; kernel "
          f"{dy['ms']:.3f} ms plain {dy['plain_ms']:.3f} ms bound {dy['bound_ms']:.4f} ms "
          f"({dy['bound_by']}) ({card})")
    if not equal:
        fail("B4 is not bit-equal to its plain twin on dyadic weights")
    if b4["carried_spikes"] <= 0:
        fail("B4's check carried no spike vector")
    return b3, b4


def gtgram_other_g(dev, audio) -> dict:
    """B1 and B3 at the sub-block lengths two FrontendConfigs give, g = 40
    (sample_rate 8000) and g = 160 (gt_window_time 0.03): featurize_batch
    (B1) on the card against the CPU path, B1 and B3 against their twins,
    and B3's ten chained hops bit-equal to one whole-second call and to
    B1. `audio` (1024, 16000) at 16 kHz; every other sample is the 8 kHz
    signal."""
    from lsm_tpu_torch.config import FrontendConfig
    from lsm_tpu_torch.models.frontend import featurize_batch
    from lsm_tpu_torch.ops import gammatone as gt
    from lsm_tpu_torch.ops.kernels import gtgram as kgt

    out = {}
    for fcfg in (FrontendConfig(sample_rate=8000), FrontendConfig(gt_window_time=0.03)):
        n = fcfg.num_samples
        wave = (audio[:, ::2] if fcfg.sample_rate == 8000 else audio)[:64].contiguous()
        nwin, hop, _ = gt.gtgram_strides(fcfg.sample_rate, fcfg.gt_window_time,
                                         n / (fcfg.sample_rate * fcfg.time_bins), n)
        g = int(np.gcd(nwin, hop))
        fb = gt.filterbank(fcfg.sample_rate, fcfg.n_filters, fcfg.gt_f_min, g, dev)
        before = kgt.launches
        on_card = featurize_batch(wave, fcfg).cpu()
        launched = kgt.launches - before
        on_cpu = featurize_batch(wave.cpu(), fcfg)
        e1 = kgt.sub_energy(wave, fb)
        b1_close = bool(torch.allclose(e1, kgt.sub_energy_plain(wave, fb), rtol=5e-3, atol=1e-6))
        st = torch.zeros(wave.shape[0], 8, fcfg.n_filters, device=dev)
        s_whole, e_whole = kgt.chunk(wave, fb, st)
        parts = []
        for c in range(10):
            hop_c = wave[:, c * n // 10:(c + 1) * n // 10].contiguous()
            if c == 3:
                s_k, e_k = kgt.chunk(hop_c, fb, st)
                s_p, e_p = kgt.chunk_plain(hop_c, fb, st)
                b3_close = bool(torch.allclose(e_k, e_p, rtol=5e-3, atol=1e-6)
                                and torch.allclose(s_k, s_p, rtol=5e-3, atol=1e-5))
            st, e = kgt.chunk(hop_c, fb, st)
            parts.append(e)
        torch.cuda.synchronize()
        rec = {"g": g, "B1_launches": launched,
               "spike_mismatch": float((on_card != on_cpu).float().mean()),
               "B1_allclose": b1_close, "B3_allclose": b3_close,
               "B3_chained_bit_equal": bool(torch.equal(torch.cat(parts), e_whole)
                                            and torch.equal(st, s_whole)),
               "B3_whole_equals_B1": bool(torch.equal(e_whole, e1))}
        out[f"g{g}"] = rec
        print(f"[B1/B3 g={g}] fs {fcfg.sample_rate} window {fcfg.gt_window_time}: featurize "
              f"on the card vs CPU spikes differ at {rec['spike_mismatch']:.2e} (B1 launched "
              f"{launched}); B1 allclose {b1_close}, B3 allclose {b3_close}, ten chained B3 "
              f"hops bit-equal {rec['B3_chained_bit_equal']}, = B1 {rec['B3_whole_equals_B1']}")
        if not (launched > 0 and rec["spike_mismatch"] <= 1e-3 and b1_close and b3_close
                and rec["B3_chained_bit_equal"] and rec["B3_whole_equals_B1"]):
            fail(f"B1/B3 at g = {g}: {rec}")
    return out


def continuous_slice(dev, card) -> dict:
    """Phase 6: the matched-readout band protocol through the port."""
    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import PipelineConfig
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.models.continuous import ContinuousKWS, fit_continuous_readout

    cfg = PipelineConfig(batch_size=64)
    audio, labels = dataset.synthetic_audio_batch_hard(20, 12, seed=42)
    reset_launches()
    t0 = time.perf_counter()
    result, ext = pipeline.run_pipeline_arrays(cfg, audio, labels, dev)
    x_train, x_test, y_train, y_test = pipeline.stratified_split(
        audio, labels, cfg.test_size, cfg.split_seed)
    ro, sc = fit_continuous_readout(
        ext.reservoir, cfg.frontend, x_train, y_train, num_classes=12,
        feature_set=cfg.feature_set, chunk_len=CHUNK, norm_decay_db_per_bin=0.1,
        l2_c=cfg.readout.l2_c, max_iter=cfg.readout.max_iter, tol=cfg.readout.tol)
    n = x_test.shape[0]
    nc = cfg.frontend.num_samples // CHUNK
    kws = ContinuousKWS(ext.reservoir, ro, sc, cfg.frontend, cfg.feature_set,
                        n_streams=n, chunk_len=CHUNK, norm_decay_db_per_bin=0.1)
    prev = x_test[np.random.default_rng(12345).permutation(n)]
    for c in range(nc):
        kws.step(prev[:, c * CHUNK:(c + 1) * CHUNK])
    for c in range(nc):
        logits = kws.step(x_test[:, c * CHUNK:(c + 1) * CHUNK])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    acc = float((np.argmax(logits, -1) == y_test).mean())
    diag = kws.diagnostics()
    rec = {"exact_accuracy": result.accuracy, "matched_accuracy": acc,
           "delta": result.accuracy - acc, "n_test": n, "seconds": wall,
           "launches": launches, "serving_regime": diag.regime,
           "serving_participation": diag.avg_participation}
    print(diag.render())
    print(f"[continuous] hard corpus {len(labels)} utt: exact {result.accuracy:.4f} matched "
          f"continuous {acc:.4f} (delta {result.accuracy - acc:+.4f}) over {n} test streams, "
          f"launches {launches}, wall {wall:.2f} s ({card})")
    if logits.shape != (n, 12) or not np.isfinite(logits).all():
        fail(f"continuous logits {logits.shape} or non-finite")
    if acc < CONT_MIN_ACC or result.accuracy - acc > CONT_MAX_DELTA:
        fail(f"matched continuous accuracy {acc:.4f} outside the band (>= {CONT_MIN_ACC}, "
             f"within {CONT_MAX_DELTA} of exact {result.accuracy:.4f})")
    if min(launches["B3"], launches["B4"]) <= 0:
        fail(f"a kernel of the continuous path was not launched: {launches}")
    rec["engine_args"] = (ext.reservoir, ro, sc)
    return rec


def serving(dev, reservoir, ro, sc, card) -> dict:
    """Phases 7 and 10: the 1024-stream serving hop, int16 wire, state
    carried, after one 1 s window of warm-up; the launch counters cover the
    warm-up and the timed hops. Then the chunk kernel (B4 dense, B6 sparse)
    at the serving weights."""
    from lsm_tpu_torch.config import PipelineConfig
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.models.continuous import ContinuousKWS
    from lsm_tpu_torch.models.streaming import decode_pcm_device

    cfg = PipelineConfig()
    audio, _ = dataset.synthetic_audio_batch_hard(86, 12, seed=9)
    wire = np.clip(audio[:N_SERVE] * 32768.0, -32768.0, 32767.0).astype(np.int16)
    hops = [np.ascontiguousarray(wire[:, c * CHUNK:(c + 1) * CHUNK]) for c in range(10)]
    torch.cuda.reset_peak_memory_stats()
    kws = ContinuousKWS(reservoir, ro, sc, cfg.frontend, cfg.feature_set,
                        n_streams=N_SERVE, chunk_len=CHUNK)
    reset_launches()
    for h in hops:                                       # warm-up: one window
        kws.step(h)
    walls = []
    for i in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = kws.step(hops[i % 10])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = read_launches()
    if logits.shape != (N_SERVE, 12) or not np.isfinite(logits).all():
        fail(f"serving logits {logits.shape} or non-finite")
    diag = kws.diagnostics()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # The chunk kernel at the serving weights over one cycle of the ten
    # hops, each from the engine's carried state as serving reaches it
    # (after the peak-memory read: the inputs kept and the twin's
    # temporaries are no part of serving).
    name, kernel, plain, flops = chunk_kernel_of(kws.reservoir)
    ops, kw = kws.reservoir.kernel_operands()
    del kw["n_win"]
    kw.update(win_len=kws._win_len, n_new_win=kws._n_new_win)
    ck_hops = []
    for h in hops:
        st = kws.state
        x = kws._featurize(decode_pcm_device(torch.as_tensor(h).to(dev)), st)[0].contiguous()
        ck_hops.append((x, (st.v, st.refrac, st.s_prev)))
        kws.step(h)
    ck = chunk_measure(ck_hops, ops, kw, kernel, plain, flops)
    if ck["spike_total_rel_gap"] > SPIKE_REL:
        fail(f"{name} at serving weights: its spike totals part from the twin's by "
             f"{ck['spike_total_rel_gap']:.3e} (> {SPIKE_REL})")
    if name == "B6":
        b, c, t = ck_hops[0][0].shape
        ck.update(tensor_core_bound(b, t, kws.reservoir.n_neurons,
                                    kws.reservoir.src_idx.shape[1], c))
    del ck_hops
    dchunk = torch.as_tensor(hops[0]).to(dev)

    # CUDA-event split of one hop on a device-resident chunk (the stages
    # are pure in the state, so they are timed without advancing it).
    splits = []
    for _ in range(10):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        st = kws.state
        ev[0].record()
        feat = kws._featurize(decode_pcm_device(dchunk), st)
        ev[1].record()
        res_out = kws._reservoir_chunk(feat[0], st)
        ev[2].record()
        kws._evaluate(st, res_out[3], res_out[4])
        ev[3].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    split = {k: statistics.median(s[i] for s in splits)
             for i, k in enumerate(("featurize_ms", "reservoir_ms", "fold_features_readout_ms"))}
    next_hop = iter(hops)
    prof = device_profile(lambda: kws.step(next(next_hop)), calls=len(hops))
    if name == "B6":
        # B6's kernels (csrc/sparse_lif.cu) under the profiler against the
        # unprofiled CUDA-event time of a call: the share the card idles
        # between them (mostly the 40 step launches).
        per_hop = {k: us / 1e3 / prof["calls"] for k, us in prof["device_us_by_name"].items()
                   if any(f in k for f in SPARSE_LIF_KERNELS)}
        ck.update(device_ms_by_kernel=per_hop,
                  idle_share=1.0 - sum(per_hop.values()) / ck["ms"])
    med = statistics.median(walls)
    rec = {
        "streams": N_SERVE, "hops_timed": len(walls),
        "hop_wall_ms_median": med * 1e3, "hop_wall_ms_min": min(walls) * 1e3,
        "stream_chunks_per_s": N_SERVE / med, "stream_chunks_per_s_best": N_SERVE / min(walls),
        "real_time_factor": 0.1 / med, "stages": split,
        "device_busy_share": prof["busy_share_of_wall"],
        "device_busy_ms_per_hop": prof["device_busy_us"] / 1e3 / prof["calls"],
        "device_events_per_hop": prof["n_device_events"] / prof["calls"],
        "top_device": prof["top_device"][:8],
        "peak_mem_gb": peak_gb,
        "n_neurons": kws.reservoir.n_neurons, "launches": launches, name: ck,
        "regime": diag.regime, "output_participation": diag.avg_participation,
    }
    print(f"[serving] N={kws.reservoir.n_neurons}, {N_SERVE} streams, int16 wire, 100 ms hops: median hop wall "
          f"{rec['hop_wall_ms_median']:.3f} ms (min {rec['hop_wall_ms_min']:.3f}), "
          f"{rec['stream_chunks_per_s']:.1f} stream-chunks/s, real-time factor "
          f"{rec['real_time_factor']:.2f}; stages " + " ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; regime {diag.regime} ({diag.avg_participation:.1f} % of the outputs)"
          f"; device busy {100 * rec['device_busy_share']:.1f} % "
          f"({rec['device_busy_ms_per_hop']:.3f} ms/hop, {rec['device_events_per_hop']:.0f} "
          f"device events/hop); peak memory {rec['peak_mem_gb']:.2f} GB ({card})")
    tc = (f", tensor-core bound {ck['tensor_core_bound_ms']:.4f} ms, idle between its kernels "
          f"{100 * ck['idle_share']:.2f} %" if name == "B6" else "")
    print(f"[serving] {name} at serving weights, mean of {ck['hops']} hops: kernel {ck['ms']:.3f} ms "
          f"plain {ck['plain_ms']:.3f} ms bound {ck['bound_ms']:.4f} ms ({ck['bound_by']}){tc}, "
          f"{ck['spikes_per_step']:.1f} spikes a stream-step, spike totals within "
          f"{ck['spike_total_rel_gap']:.2e} of the twin's; launches {launches} ({card})")
    for k, ms in ck.get("device_ms_by_kernel", {}).items():
        print(f"[serving]   {name} {ms:8.4f} ms/hop  {k[:100]}")
    for t in rec["top_device"]:
        print(f"[serving]   {t['us'] / 1e3 / prof['calls']:8.3f} ms/hop x{t['count'] // prof['calls']:4d}"
              f"  {t['name']}")
    return rec


def chained_chunks_equal(kernel, plain, ops, kw, chunks, width: int) -> tuple:
    """Three (or more) chained chunks from a zero state through a chunk
    kernel and its twin: (every output bit-equal, max abs err, carried
    spikes that fed a later chunk)."""
    dev = chunks[0].device
    b = chunks[0].shape[0]
    st_k = st_p = (torch.zeros(b, width, device=dev),
                   torch.zeros(b, width, dtype=torch.int32, device=dev),
                   torch.zeros(b, width, device=dev))
    equal, err, carried = True, 0.0, 0.0
    for x in chunks:
        carried += float(st_k[2].sum())
        out_k = kernel(x, *ops, *st_k, **kw)
        out_p = plain(x, *ops, *st_p, **kw)
        torch.cuda.synchronize()
        equal = equal and all(torch.equal(a, p) for a, p in zip(out_k, out_p))
        err = max(err, *(finite_err(a, p) for a, p in zip(out_k, out_p)))
        st_k, st_p = out_k[:3], out_p[:3]
    return equal, err, carried


def sparse_kernels(dev, spikes, card) -> dict:
    """Phase 8: B5 and B6 at BASELINE configs[3] width (N = 10240, k = 2048,
    R = 4, C = 128, T = 400) on weights calibrated at multiplier 1.6 on
    featurized hard-corpus audio: B5 bit-equal to its twin on the dyadic
    copy at B = 32 and B = 70, timed at B = 256 on the calibrated weights
    (spikes a row-step and participation of kernel and twin within
    SPIKE_REL of each other: the tensor cores may sum in another order, so
    the bits may part there); B6 over three chained
    chunks of 64, 70 and 390 streams, bit-equal on the dyadic copy (B6's
    time comes from phase 10's serving state). Then the dense B2 and B4 at
    N = 2048, past one thread a neuron, bit-equal on dyadic weights."""
    from lsm_tpu_torch.config import ReservoirConfig
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.models import sparse
    from lsm_tpu_torch.models.calibration import calibrate_weight
    from lsm_tpu_torch.ops.kernels import sparse_lif as ksp

    B, C, T = spikes.shape
    rcfg = ReservoirConfig(num_neurons=N_10K, small_world_k=K_10K)
    t0 = time.perf_counter()
    _, mw = calibrate_weight(rcfg, spikes, MULT_10K)
    sr = sparse.init_reservoir_sparse(rcfg, C, mean_weight=mw, device=dev)
    init_s = time.perf_counter() - t0
    edges, fan = sparse_degrees(sr)
    S = sr.src_idx.shape[1]

    dy = sr.dyadic()
    ops, kw = dy.kernel_operands()
    equal, err, dy_spikes = {}, 0.0, 0.0
    for rows in (32, 70):
        x_r = spikes[:rows].contiguous()
        s_k, a_k = ksp.sparse_lif_stats(x_r, *ops, **kw)
        s_p, a_p = ksp.sparse_lif_stats_plain(x_r, *ops, **kw)
        torch.cuda.synchronize()
        equal[rows] = bool(torch.equal(s_k, s_p) and torch.equal(a_k, a_p))
        err = max(err, finite_err(s_k, s_p), finite_err(a_k, a_p))
        if rows == 32:
            dy_spikes = float(a_p.sum()) / (rows * T)

    ops_c, kw_c = sr.kernel_operands()
    s_c, a_c = ksp.sparse_lif_stats(spikes, *ops_c, **kw_c)
    a_cp = ksp.sparse_lif_stats_plain(spikes, *ops_c, **kw_c)[1]
    rec, inp = float(a_c.sum()), float(spikes.sum())
    block_flops = sparse_flops(rec, inp, fan, S * 128, B, T, N_10K)
    b5 = {
        "mean_weight": mw, "init_s": init_s, "S": S, "n_band": sr.n_band,
        "edges_per_row": edges, "fanout": fan,
        "bit_equal_dyadic": all(equal.values()), "bit_equal_dyadic_by_rows": equal,
        "max_abs_err": err, "dyadic_spikes_per_step": dy_spikes,
        "spikes_per_step": rec / (B * T), "plain_spikes_per_step": float(a_cp.sum()) / (B * T),
        "spikes_ratio_to_plain": rec / max(float(a_cp.sum()), 1.0),
        "participation": float((a_c > 0).float().mean()),
        "plain_participation": float((a_cp > 0).float().mean()),
        "ms": cuda_ms(lambda: ksp.sparse_lif_stats(spikes, *ops_c, **kw_c), reps=3),
        "plain_ms": cuda_ms(lambda: ksp.sparse_lif_stats_plain(spikes, *ops_c, **kw_c), reps=1),
        **bound(sparse_flops(rec, inp, fan, edges, B, T, N_10K),
                nbytes(spikes, *ops_c, s_c, a_c)),
        "block_form_flops": block_flops, "block_form_ms": block_flops / F32_FLOPS * 1e3,
        **tensor_core_bound(B, T, N_10K, S, C),
    }
    print(f"[B5 sparse_lif] N={N_10K} k={K_10K} S={S} C={C} T={T}, mean weight {mw:.6f} "
          f"(init {init_s:.1f} s): dyadic bit_equal {equal} max_abs_err {err:.3e}; "
          f"calibrated B={B}: {b5['spikes_per_step']:.4f} spikes a row-step (twin "
          f"{b5['plain_spikes_per_step']:.4f}, ratio {b5['spikes_ratio_to_plain']:.6f}), "
          f"participation {b5['participation']:.6f} (twin {b5['plain_participation']:.6f}), "
          f"kernel {b5['ms']:.3f} ms plain "
          f"{b5['plain_ms']:.3f} ms bound {b5['bound_ms']:.4f} ms ({b5['bound_by']}; block "
          f"form {b5['block_form_ms']:.4f} ms; tensor-core bound "
          f"{b5['tensor_core_bound_ms']:.4f} ms) ({card})")
    if not b5["bit_equal_dyadic"]:
        fail(f"B5 is not bit-equal to its plain twin on dyadic weights: {equal}")
    if abs(b5["spikes_ratio_to_plain"] - 1.0) > SPIKE_REL or \
            abs(b5["participation"] - b5["plain_participation"]) > SPIKE_REL:
        fail(f"B5 on calibrated weights parts from its twin by more than {SPIKE_REL}: spikes "
             f"ratio {b5['spikes_ratio_to_plain']:.6f}, participation {b5['participation']:.6f} "
             f"against {b5['plain_participation']:.6f}")

    ckw = {k: v for k, v in kw.items() if k != "n_win"}
    ckw.update(win_len=40, n_new_win=1)
    # On a 132-SM H100 at 10240 neurons the body runs 64-stream tiles up to
    # 384 streams and 128-stream tiles above: 64 and 70 streams (a ragged
    # tile) on 64, 390 (past the 256 featurized rows: the rows again,
    # reversed) on ragged 128-stream tiles.
    x_all = torch.cat([spikes, spikes.flip(0)])
    b6 = {"bit_equal_dyadic": True, "max_abs_err": 0.0, "chains": {}}
    for width in (64, 70, 390):
        chunks = [x_all[:width, :, c * 40:(c + 1) * 40].contiguous() for c in range(3)]
        eq6, err6, carried6 = chained_chunks_equal(
            ksp.sparse_lif_chunk, ksp.sparse_lif_chunk_plain, ops, ckw, chunks, N_10K)
        b6["chains"][width] = {"bit_equal": bool(eq6), "carried_spikes": carried6}
        b6["bit_equal_dyadic"] = b6["bit_equal_dyadic"] and bool(eq6) and carried6 > 0
        b6["max_abs_err"] = max(b6["max_abs_err"], err6)
    print(f"[B6 sparse_lif_chunk] N={N_10K} three chained 40-step chunks, dyadic: "
          + "; ".join(f"{w} streams bit_equal {c['bit_equal']} carried spikes "
                      f"{c['carried_spikes']:.0f}"
                      for w, c in b6["chains"].items())
          + f"; max_abs_err {b6['max_abs_err']:.3e}")
    if not b6["bit_equal_dyadic"]:
        fail(f"B6 is not bit-equal to its plain twin over chained chunks (or carried "
             f"nothing): {b6['chains']}")
    chunks = [spikes[:64, :, c * 40:(c + 1) * 40].contiguous() for c in range(3)]
    x32 = spikes[:32].contiguous()

    # Dense B2/B4 past 1024 padded neurons, on the block body.
    rcfg2 = ReservoirConfig(num_neurons=2048, small_world_k=409)
    _, mw2 = calibrate_weight(rcfg2, spikes, 0.6)
    d2 = res.init_reservoir(rcfg2, C, mean_weight=mw2, device=dev).dyadic()
    ops2, kw2 = d2.kernel_operands()
    dense = dense_pair_equal(x32, chunks, ops2, kw2)
    print(f"[B2/B4 dense N=2048] dyadic: B2 B=32 bit_equal {dense['B2_bit_equal']} "
          f"({dense['B2_spikes']:.0f} spikes); B4 three chained chunks of 64 streams bit_equal "
          f"{dense['B4_bit_equal']} (carried {dense['B4_carried_spikes']:.0f})")
    if not dense_held(dense):
        fail("dense B2/B4 at N = 2048 are not bit-equal to their twins (or stayed silent)")

    # Dense B2/B4 with more input channels than padded neurons: the spikes
    # repeated as redundancy_factor repeats them (2 at 100 neurons, C = 256
    # > N_pad = 128; 16 at 1000 neurons, C = 2048 > N_pad = 1024).
    wide_c = {}
    for n_neurons, redundancy in ((100, 2), (1000, 16)):
        rc = ReservoirConfig(num_neurons=n_neurons, num_output_neurons=min(400, n_neurons),
                             small_world_k=int(0.2 * n_neurons), mean_weight=0.01)
        xr = x32.repeat_interleave(redundancy, dim=1)
        rr = res.init_reservoir(rc, xr.shape[1], device=dev).dyadic()
        wide_c[xr.shape[1]] = dense_pair_equal(
            xr, [xr[..., c * 40:(c + 1) * 40].contiguous() for c in range(3)],
            *rr.kernel_operands())
    # The block body past its 8-bit refractory counter: refractory 300.
    r300 = {"dense_2048": dense_pair_equal(x32, chunks, ops2, {**kw2, "refractory": 300})}
    s5k, a5k = ksp.sparse_lif_stats(x32, *ops, **{**kw, "refractory": 300})
    s5p, a5p = ksp.sparse_lif_stats_plain(x32, *ops, **{**kw, "refractory": 300})
    torch.cuda.synchronize()
    eq6, _, carried6 = chained_chunks_equal(ksp.sparse_lif_chunk, ksp.sparse_lif_chunk_plain, ops,
                                            {**ckw, "refractory": 300}, chunks, N_10K)
    r300.update(B5_bit_equal=bool(torch.equal(s5k, s5p) and torch.equal(a5k, a5p)),
                B5_spikes=float(a5p.sum()), B6_bit_equal=bool(eq6), B6_carried_spikes=carried6)
    print("[B2/B4 C > N_pad] dyadic, bit_equal: " + "; ".join(
        f"C={c} {v}" for c, v in wide_c.items()) + f"; [refractory 300] dyadic: {r300}")
    if not all(dense_held(v) for v in (*wide_c.values(), r300["dense_2048"])):
        fail(f"dense B2/B4 at C > N_pad or refractory 300 part from their twins: {wide_c} {r300}")
    if not (r300["B5_bit_equal"] and r300["B6_bit_equal"] and r300["B5_spikes"] > 0):
        fail(f"B5/B6 at refractory 300 part from their twins: {r300}")
    return {"B5": b5, "B6": b6, "dense_2048": dense, "dense_wide_channels": wide_c,
            "refractory_300": r300}


def dense_pair_equal(x, chunks, ops, kw) -> dict:
    """Dense B2 over x and B4 over `chunks` (40-step chunks chained from a
    zero state), each against its twin."""
    from lsm_tpu_torch.ops.kernels import lif as klif

    sk, ak = klif.lif_stats(x, *ops, **kw)
    sp, ap = klif.lif_stats_plain(x, *ops, **kw)
    torch.cuda.synchronize()
    ckw = {k: v for k, v in kw.items() if k != "n_win"}
    ckw.update(win_len=40, n_new_win=1)
    eq4, err4, carried = chained_chunks_equal(klif.lif_chunk, klif.lif_chunk_plain, ops, ckw,
                                              chunks, ops[0].shape[0])
    return {"B2_bit_equal": bool(torch.equal(sk, sp) and torch.equal(ak, ap)),
            "B2_spikes": float(ap.sum()), "B4_bit_equal": bool(eq4), "B4_carried_spikes": carried,
            "max_abs_err": max(finite_err(sk, sp), err4)}


def dense_held(rec) -> bool:
    """Both dense kernels bit-equal to their twins, and neither silent."""
    return (rec["B2_bit_equal"] and rec["B4_bit_equal"] and rec["B2_spikes"] > 0
            and rec["B4_carried_spikes"] > 0)


def sparse_slice(dev, card) -> tuple:
    """Phase 9: (a) the sparse-parity oracle of tests/test_sparse_reservoir.py
    at N = 1024, k = 204 on the hard corpus (dense and sparse EDGE OF CHAOS,
    accuracies in [0.66, 0.95], within 0.15); (b) run_pipeline_arrays at
    configs[3] full width and multiplier 1.6 on the same corpus, as
    `python -m lsm_tpu_torch --synthetic --hard --samples-per-class 30
    --num-neurons 10240 --multiplier 1.6` builds it. The regime of (b) is
    recorded, not gated: the port draws its own weights."""
    import dataclasses

    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import PipelineConfig, ReservoirConfig
    from lsm_tpu_torch.io import artifacts, dataset
    from lsm_tpu_torch.models.sparse import SparseReservoir

    audio, labels = dataset.synthetic_audio_batch_hard(30, 12, seed=42)
    base = ReservoirConfig(num_neurons=1024, num_output_neurons=400, small_world_k=204)
    t0 = time.perf_counter()
    spikes = pipeline.featurize_audio_array(PipelineConfig(reservoir=base, batch_size=64),
                                            audio, dev)
    ds = artifacts.SpikeDataset(x_spikes=spikes, y_labels=labels)
    parity = {}
    for flag in (False, True):
        cfg = PipelineConfig(reservoir=dataclasses.replace(base, sparse=flag), batch_size=64)
        ext = pipeline.extract_lsm_features(cfg, ds, dev)
        if isinstance(ext.reservoir, SparseReservoir) != flag:
            fail(f"sparse={flag} built a {type(ext.reservoir).__name__}")
        result = pipeline.train_and_evaluate(cfg, ext.artifact, dev)
        parity["sparse" if flag else "dense"] = {
            "regime": ext.diagnostics.regime, "accuracy": result.accuracy,
            "participation": ext.diagnostics.avg_participation}
    torch.cuda.synchronize()
    parity["seconds"] = time.perf_counter() - t0
    dn, sp = parity["dense"], parity["sparse"]
    print(f"[sparse parity] N=1024 hard corpus: dense {dn['accuracy']:.4f} {dn['regime']} "
          f"({dn['participation']:.1f} %), sparse {sp['accuracy']:.4f} {sp['regime']} "
          f"({sp['participation']:.1f} %), wall {parity['seconds']:.2f} s ({card})")
    for name, r in (("dense", dn), ("sparse", sp)):
        if r["regime"] != "EDGE OF CHAOS" or not (
                SPARSE_ACC_RANGE[0] <= r["accuracy"] <= SPARSE_ACC_RANGE[1]):
            fail(f"sparse-parity oracle: {name} {r}")
    if abs(sp["accuracy"] - dn["accuracy"]) > SPARSE_MAX_DELTA:
        fail(f"sparse-parity oracle: |delta| > {SPARSE_MAX_DELTA}: {parity}")

    cfg = PipelineConfig(reservoir=ReservoirConfig(num_neurons=N_10K, small_world_k=K_10K),
                         multiplier=MULT_10K)
    reset_launches()
    t0 = time.perf_counter()
    result, ext = pipeline.run_pipeline_arrays(cfg, audio, labels, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    art = ext.artifact
    rec = {"parity_1024": parity, "seconds": wall, "accuracy": result.accuracy,
           "regime": ext.diagnostics.regime, "avg_participation": ext.diagnostics.avg_participation,
           "avg_spikes_per_neuron": float(np.mean(ext.diagnostics.avg_spikes_per_neuron)),
           "mean_weight": ext.mean_weight, "lbfgs_iters": result.n_iters,
           "batch_size": cfg.batch_size, "launches": launches}
    print(ext.diagnostics.render())
    print(f"[sparse slice] N={N_10K} k={K_10K} multiplier {MULT_10K}, hard corpus "
          f"{len(labels)} utt: accuracy {result.accuracy:.4f} regime {rec['regime']} "
          f"participation {rec['avg_participation']:.1f} % "
          f"({rec['avg_spikes_per_neuron']:.2f} spikes/neuron), launches {launches}, "
          f"wall {wall:.2f} s ({card})")
    if not isinstance(ext.reservoir, SparseReservoir):
        fail("the configs[3] slice did not build the block-sparse reservoir")
    if not (np.isfinite(art.x_train).all() and np.isfinite(art.x_test).all()) or \
            art.x_train.shape[1] != 5 * 400:
        fail(f"sparse slice features non-finite or shaped {art.x_train.shape}")
    if min(launches["B1"], launches["B5"]) <= 0:
        fail(f"a kernel of the sparse batch path was not launched: {launches}")
    return rec, (ext.reservoir, result.readout, ext.scaler)


if __name__ == "__main__":
    main()
