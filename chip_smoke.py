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
               at rtol 5e-3 / atol 1e-6.
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
               passes through zero, at atol 1e-5), and ten chained B3
               hops bit-equal to one whole-second B3 call and to B1; B4
               bit-equal on dyadic weights. CUDA-event times; B1/B3's bound
               counts the sequential cascade, the block form's own work
               stands beside it.
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
               at B=32 and timed at B=256 on the calibrated weights; B6
               over three chained chunks of 64 streams, bit-equal on the
               dyadic copy; the dense B2 and B4 at N=2048 (past one thread
               a neuron) bit-equal on dyadic weights.
  9. sparse slice - the N=1024 dense/sparse parity oracle of
               tests/test_sparse_reservoir.py (both EDGE OF CHAOS, accuracy
               in [0.66, 0.95], within 0.15), then run_pipeline_arrays at
               configs[3] full width, multiplier 1.6, on the hard corpus
               (30 x 12): diagnostics, accuracy and wall recorded (the
               regime is not gated: the port draws its own weights);
               finite features, B1 and B5 launched.
 10. sparse serving - phase 7 with the phase-9 reservoir: 1024 streams at
               10240 neurons, B3 and B6 launched; B6's time and bound at
               the serving weights from the carried state.

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
# the CUDA cores and HBM3 bandwidth.
F32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12
# BASELINE.json configs[3], the scaled block-sparse reservoir: 10240
# neurons, k = 0.1 N * 2, at the multiplier docs/VALIDATION.md's configs[3]
# sweep found at the edge of chaos (lsm_tpu's draws).
N_10K, K_10K, MULT_10K = 10240, 2048, 1.6
SPARSE_ACC_RANGE, SPARSE_MAX_DELTA = (0.66, 0.95), 0.15   # tests/test_sparse_reservoir.py


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


def block_form_flops(batch: int, channels: int, n_sub: int, g: int = 80) -> float:
    """The kernels' own algorithm, the exact block form: per (row, channel,
    sub-block) (g+8)^2 FMAs for the outputs and the new state plus g for
    the energy. A second figure beside the bound, which counts the cascade."""
    return 2.0 * batch * channels * n_sub * ((g + 8) ** 2 + g)


def gtgram_bound(wave, kmat, *outs, channels: int) -> dict:
    batch, samples = wave.shape
    b = bound(gtgram_flops(batch, channels, samples), nbytes(wave, kmat, *outs))
    bf = block_form_flops(batch, channels, samples // 80)
    return {**b, "block_form_flops": bf, "block_form_ms": bf / F32_FLOPS * 1e3}


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
    as an output counts them), in_rows every input spike."""
    n_state = ops[-1].shape[0]
    n_flops = n_bytes = rows = spikes = 0.0
    for x, carried in hops:
        out = kernel(x, *ops, *carried, **kw)
        all_n = plain(x, *ops, *carried, **{**kw, "n_outputs": n_state})
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
    wall, device events, and device time per kernel name."""
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
    kmat = gt.block_system_tensor(fcfg.sample_rate, fcfg.n_filters, fcfg.gt_f_min, g, dev)
    e_k = kgt.sub_energy(audio, kmat)
    e_p = kgt.sub_energy_plain(audio, kmat)
    torch.cuda.synchronize()
    if not torch.isfinite(e_k).all():
        fail("B1 produced non-finite energies")
    b1_err = (e_k - e_p).abs()
    b1_rel = (b1_err / e_p.abs().clamp_min(1e-30)).flatten()
    b1 = {
        "max_abs_err": float(b1_err.max()),
        "p99_rel_err": float(torch.quantile(b1_rel[:: max(1, b1_rel.numel() // 2**24)], 0.99)),
        "allclose": bool(torch.allclose(e_k, e_p, rtol=5e-3, atol=1e-6)),
        "ms": cuda_ms(lambda: kgt.sub_energy(audio, kmat), reps=10),
        "plain_ms": cuda_ms(lambda: kgt.sub_energy_plain(audio, kmat), reps=3),
        **gtgram_bound(audio, kmat, e_k, channels=fcfg.n_filters),
    }
    print(f"[B1 gtgram] B=256 S=16000 C={fcfg.n_filters}: max_abs_err "
          f"{b1['max_abs_err']:.3e} p99_rel_err {b1['p99_rel_err']:.3e} "
          f"kernel {b1['ms']:.3f} ms plain {b1['plain_ms']:.3f} ms ({card})")
    if not b1["allclose"]:
        fail("B1 disagrees with its plain twin beyond rtol 5e-3 / atol 1e-6")

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
        "B1_ms_2400": cuda_ms(lambda: kgt.sub_energy(audio, kmat), reps=3),
        "B2_ms_2400": cuda_ms(lambda: klif.lif_stats(spikes0, *ops_h, **kw_h), reps=3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    e_h = kgt.sub_energy(audio, kmat)
    s_h, a_h = klif.lif_stats(spikes0, *ops_h, **kw_h)
    hot_rec["B1_bound_2400"] = gtgram_bound(audio, kmat, e_h, channels=fcfg.n_filters)
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
    b3, b4 = chunk_kernels(dev, kmat, r_rand.dyadic(), card)
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


def chunk_kernels(dev, kmat, r_dy, card):
    """Phase 5: B3 and B4 against their plain twins at serving shapes, from
    the carried state of a flagship engine (dyadic weights) that has run a
    few hops of 1024 streams."""
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
    s_whole, e_whole = kgt.chunk(audio, kmat, zero)
    st, parts, states = zero, [], []
    for c in range(10):
        st, e = kgt.chunk(audio[:, c * CHUNK:(c + 1) * CHUNK].contiguous(), kmat, st)
        parts.append(e)
        states.append(st)
    e_b1 = kgt.sub_energy(audio, kmat)
    torch.cuda.synchronize()
    chained = torch.equal(torch.cat(parts), e_whole) and torch.equal(st, s_whole)
    as_b1 = torch.equal(e_whole.permute(0, 2, 1), e_b1)

    # B3 against its twin on one hop from a carried state.
    hop = audio[:, 3 * CHUNK:4 * CHUNK].contiguous()
    st3 = states[2]
    s_k, e_k = kgt.chunk(hop, kmat, st3)
    s_p, e_p = kgt.chunk_plain(hop, kmat, st3)
    torch.cuda.synchronize()
    err = max(float((e_k - e_p).abs().max()), float((s_k - s_p).abs().max()))
    # Energies at B1's tolerance; the state passes through zero, so its
    # floor is 1e-5 against magnitudes ~0.4.
    close = bool(torch.allclose(e_k, e_p, rtol=5e-3, atol=1e-6)
                 and torch.allclose(s_k, s_p, rtol=5e-3, atol=1e-5))
    b3 = {
        "chained_bit_equal": bool(chained), "whole_equals_B1": bool(as_b1),
        "allclose": close, "max_abs_err": err,
        "ms": cuda_ms(lambda: kgt.chunk(hop, kmat, st3), reps=20),
        "plain_ms": cuda_ms(lambda: kgt.chunk_plain(hop, kmat, st3), reps=3),
        **gtgram_bound(hop, kmat, st3, s_k, e_k, channels=C),
    }
    print(f"[B3 gtgram_chunk] B={N_SERVE} hop {CHUNK} C={C}: ten chained hops bit-equal "
          f"{chained}, = B1 {as_b1}; vs twin max_abs_err {err:.3e} allclose {close}; "
          f"kernel {b3['ms']:.3f} ms plain {b3['plain_ms']:.3f} ms bound "
          f"{b3['bound_ms']:.3f} ms ({b3['bound_by']}) ({card})")
    if not (chained and as_b1):
        fail("B3's chained hops are not bit-equal to the whole-second call / B1")
    if not close:
        fail("B3 disagrees with its plain twin beyond rtol 5e-3 / atol 1e-6 (state 1e-5)")

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
    print(f"[serving] {name} at serving weights, mean of {ck['hops']} hops: kernel {ck['ms']:.3f} ms "
          f"plain {ck['plain_ms']:.3f} ms bound {ck['bound_ms']:.4f} ms ({ck['bound_by']}), "
          f"{ck['spikes_per_step']:.1f} spikes a stream-step; launches {launches} ({card})")
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
    copy at B = 32 and timed at B = 256 on the calibrated weights; B6 over
    three chained chunks of 64 streams, bit-equal on the dyadic copy (B6's
    time comes from phase 10's serving state). Then the dense B2 and B4 at
    N = 2048, past one thread a neuron, bit-equal on dyadic weights."""
    from lsm_tpu_torch.config import ReservoirConfig
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.models import sparse
    from lsm_tpu_torch.models.calibration import calibrate_weight
    from lsm_tpu_torch.ops.kernels import lif as klif
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
    x32 = spikes[:32].contiguous()
    s_k, a_k = ksp.sparse_lif_stats(x32, *ops, **kw)
    s_p, a_p = ksp.sparse_lif_stats_plain(x32, *ops, **kw)
    torch.cuda.synchronize()
    equal = torch.equal(s_k, s_p) and torch.equal(a_k, a_p)
    err = max(finite_err(s_k, s_p), finite_err(a_k, a_p))

    ops_c, kw_c = sr.kernel_operands()
    s_c, a_c = ksp.sparse_lif_stats(spikes, *ops_c, **kw_c)
    rec, inp = float(a_c.sum()), float(spikes.sum())
    block_flops = sparse_flops(rec, inp, fan, S * 128, B, T, N_10K)
    b5 = {
        "mean_weight": mw, "init_s": init_s, "S": S, "n_band": sr.n_band,
        "edges_per_row": edges, "fanout": fan,
        "bit_equal_dyadic": bool(equal), "max_abs_err": err,
        "dyadic_spikes_per_step": float(a_p.sum()) / (32 * T),
        "spikes_per_step": rec / (B * T), "participation": float((a_c > 0).float().mean()),
        "ms": cuda_ms(lambda: ksp.sparse_lif_stats(spikes, *ops_c, **kw_c), reps=3),
        "plain_ms": cuda_ms(lambda: ksp.sparse_lif_stats_plain(spikes, *ops_c, **kw_c), reps=1),
        **bound(sparse_flops(rec, inp, fan, edges, B, T, N_10K),
                nbytes(spikes, *ops_c, s_c, a_c)),
        "block_form_flops": block_flops, "block_form_ms": block_flops / F32_FLOPS * 1e3,
    }
    print(f"[B5 sparse_lif] N={N_10K} k={K_10K} S={S} C={C} T={T}, mean weight {mw:.6f} "
          f"(init {init_s:.1f} s): dyadic B=32 bit_equal {equal} max_abs_err {err:.3e}; "
          f"calibrated B={B}: {b5['spikes_per_step']:.1f} spikes a row-step, kernel "
          f"{b5['ms']:.3f} ms plain {b5['plain_ms']:.3f} ms bound {b5['bound_ms']:.4f} ms "
          f"({b5['bound_by']}; block form {b5['block_form_ms']:.4f} ms) ({card})")
    if not equal:
        fail("B5 is not bit-equal to its plain twin on dyadic weights")

    ckw = {k: v for k, v in kw.items() if k != "n_win"}
    ckw.update(win_len=40, n_new_win=1)
    chunks = [spikes[:64, :, c * 40:(c + 1) * 40].contiguous() for c in range(3)]
    eq6, err6, carried6 = chained_chunks_equal(ksp.sparse_lif_chunk, ksp.sparse_lif_chunk_plain,
                                               ops, ckw, chunks, N_10K)
    b6 = {"bit_equal_dyadic": bool(eq6), "max_abs_err": err6, "carried_spikes": carried6}
    print(f"[B6 sparse_lif_chunk] N={N_10K} 64 streams, three chained 40-step chunks, "
          f"dyadic: bit_equal {eq6} max_abs_err {err6:.3e}, carried spikes {carried6:.0f}")
    if not eq6 or carried6 <= 0:
        fail("B6 is not bit-equal to its plain twin over chained chunks (or carried nothing)")

    # Dense B2/B4 past 1024 padded neurons, on the block body.
    rcfg2 = ReservoirConfig(num_neurons=2048, small_world_k=409)
    _, mw2 = calibrate_weight(rcfg2, spikes, 0.6)
    d2 = res.init_reservoir(rcfg2, C, mean_weight=mw2, device=dev).dyadic()
    ops2, kw2 = d2.kernel_operands()
    s2k, a2k = klif.lif_stats(x32, *ops2, **kw2)
    s2p, a2p = klif.lif_stats_plain(x32, *ops2, **kw2)
    torch.cuda.synchronize()
    eq2 = torch.equal(s2k, s2p) and torch.equal(a2k, a2p)
    ckw2 = {k: v for k, v in kw2.items() if k != "n_win"}
    ckw2.update(win_len=40, n_new_win=1)
    eq4, err4, carried4 = chained_chunks_equal(klif.lif_chunk, klif.lif_chunk_plain, ops2,
                                               ckw2, chunks, ops2[0].shape[0])
    dense = {"B2_bit_equal": bool(eq2), "B2_spikes": float(a2p.sum()),
             "B4_bit_equal": bool(eq4), "B4_carried_spikes": carried4,
             "max_abs_err": max(finite_err(s2k, s2p), err4)}
    print(f"[B2/B4 dense N=2048] dyadic: B2 B=32 bit_equal {eq2} ({dense['B2_spikes']:.0f} "
          f"spikes); B4 three chained chunks of 64 streams bit_equal {eq4} (carried "
          f"{carried4:.0f})")
    if not (eq2 and eq4) or dense["B2_spikes"] <= 0 or carried4 <= 0:
        fail("dense B2/B4 at N = 2048 are not bit-equal to their twins (or stayed silent)")
    return {"B5": b5, "B6": b6, "dense_2048": dense}


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
