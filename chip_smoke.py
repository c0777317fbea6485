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
               worst channel no worse than the twin's (B1/B3 convert their
               cascade state once a 100 ms hop, not once a sub-block:
               ROADMAP C5). B2's plan must name
               the cluster body with K = 16; on the calibrated (non-dyadic)
               weights its statistics must be bit-equal to the one-thread
               body's (the same sums in the same order), and it is timed
               beside the one-thread body and on all-zero spikes (the
               per-step floor: signalling, word scans, update, statistics).
  3. slice   - lsm_tpu_torch.pipeline.run_pipeline_arrays on the frozen hard
               corpus (30 x 12, seed 42, batch 64): regime EDGE OF CHAOS,
               accuracy inside the band (0.76, 0.90), and both kernels'
               launch counters > 0 for this run, every B2 launch on the
               cluster body.
  4. hot     - the inference path at 2400 synthetic utterances with the
               audio already on the card: featurize, extract, scale,
               predict; utterances/s beside the card's name and power limit;
               B2's plan at 2400 rows and its share of the wall.
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
               >= 0.60 and exact - matched <= 0.15; B3 and B4 launched, B2
               and B4 on the cluster body.
  7. serving - ContinuousKWS.step at 1024 streams (flagship reservoir of
               phase 6), int16 wire, after one 1 s window of warm-up, state
               carried: host wall per hop (median, min), stream-chunks/s,
               real-time factor, CUDA-event stage split, device busy share
               and top device ops from torch.profiler, peak memory; B4's
               time and bound at the serving weights from the carried
               state (the kernels line takes these), its plan (the cluster
               body, K = 16), its fired source rows a stream-step, and its
               outputs bit-equal to the one-thread body's on every hop.
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
               dense peak, beside the function's bound. B5's line prints
               the block body's plan (tile, tiles, persistent CTAs) and
               the counter ops/kernels/sparse_lif.counts over the timed
               call: steps, block uses and loads, and the share of loads
               saved (0: each tile fetches what it multiplies).
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
               Then the serving fold kernel (csrc/fold.cu) against its
               plain twin on the same CUDA tensors, bit for bit: phase 6's
               dense modules at 4096 streams (flagship.serve's shape) and
               phase 9's at 1024, on a live engine's rings after one 1 s
               window of int16 hops, the push and the fold-only mode, each
               timed beside the twin and the bytes it must move.
 11. offline - WAVs on disk at the flagship config (2400 synthetic files
               in Speech Commands layout and one corrupt one):
               create_spike_dataset on the int16 wire bit-equal to the
               float32 route, the corrupt file skipped with the labels
               aligned, the sharded route equal to the in-memory one, the
               mu-law route's flips recorded (the int16 route alone
               launches B1 once a batch); a trained dense bundle saved,
               reloaded on the card and classified over memory and shards
               with the trained modules' predictions, each classify
               launching B2 once a batch on the cluster body, the
               reloaded modules' features and logits bit-equal to the
               trained ones'; phase 9's modules through a v2-sparse bundle
               the same way (B5 once a batch);
               `python -m lsm_tpu_torch --data-dir ... --save-model` and
               `python -m lsm_tpu_torch.cli.classify` (--input <shards>,
               --data-dir) as subprocesses; the warm (shards on disk) and
               cold (WAVs on disk) rates, the decode worker's busy share of
               the cold wall for the native C++ decoder and for the NumPy
               one, bundle sizes and load times. The native decoder must
               build and decode every batch (io/native.py's count), and it
               is held to the NumPy decoder on the 2400 WAVs by
               tests/test_native.py's rule: the int16 and mu-law wires
               bit-equal, float32 within 1e-6, the corrupt file skipped by
               both.
 12. serving entry points - at full width on the int16 wire with 100 ms
               hops: the exact engine StreamingKWS over 1024 streams with
               phase 6's dense modules (host wall a hop after a 1 s
               warm-up, median and min of 12; the window's device time;
               one step alone launches B1 once and B2 once on the cluster
               body; `exact_counts` over the timed hops, one hop a step,
               and how many times each sample is featurized);
               ContinuousKWS over 1024 streams (B3 and B4 launched;
               save_serving_state compressed and uncompressed with bytes and
               seconds, a fresh engine loads each and its next 10 hops are
               bit-equal to the uninterrupted engine's; 64 streams migrated
               into a second engine continue bit-equal). On both dense
               engines step_compact's preds equal step's argmax and
               step_active with every other stream active is bit-equal to
               step with wire silence in the other rows, on all three
               wires, and stream(depth=2) and steps_fused(3) equal three
               serial steps. Phase 9's 10240-neuron modules: continuous at 1024
               streams saved, loaded and 5 hops bit-equal (B6 launched);
               exact at 256 streams, one step launching B1 and B5 once,
               save/load bit-equal. Then `python -m
               lsm_tpu_torch.cli.stream_kws` as subprocesses on phase 11's
               2400 WAVs and dense bundle: static (--compact) and --pool
               over 1024 slots, whose predictions must equal the static
               run's for every file; a continuous bundle of phase 6's
               modules served with --save-state, then --restore-state.
 13. frontends - BASELINE configs[0] (yes/no/up/down x 200 synthetic
               utterances, mel, 64 filters, flagship reservoir):
               run_pipeline_arrays on the card within 0.05 of the port's CPU
               run, B2 launched on the cluster body and no B1; the mel hot
               path (2400 utterances, 64 filters, audio on the card: min and
               median of 5 walls, the featurize share, peak memory); mel and
               fft spikes on the card against the CPU path on 256
               utterances (<= 1e-3 differing entries); iir-xla launching B1
               once with spikes equal to iir's; the mel continuous band
               (hard corpus 20 x 12, 128 filters: matched >= 0.45 and within
               0.15 of exact; B4 on the cluster body, no B3), then that
               engine at 1024 streams (int16 wire, 100 ms hops: hop wall,
               profiled device-busy time, save/load and 64 migrated streams bit-equal, 30
               hops launching B4 30 times) and the mel exact engine at 1024
               streams (one step: B2 once, no B1).
 14. training - 24,000 rows of synthetic_audio_batch (2000 a class,
               generated in chunks on the host, featurized on the card,
               written as compressed shards; set-up, timed apart), then
               extract_and_train_streaming with ridge and with logistic:
               rows/s, the fit pass's split and the device-busy share of each
               pass (CUDA events around the extract calls), peak RSS per
               pass beside the corpus's bytes, B2 on the cluster body; the
               in-memory path on the same rows as the oracle (ridge accuracy
               within 1e-6, logistic within 0.02 with >= 0.95 of the test
               predictions equal); the configs[3] reservoir (10240 neurons,
               multiplier 1.6) over the first 2400 rows with ridge (B5
               launched); `python -m lsm_tpu_torch.cli.extract_lsm_features
               --streaming-fit --save-model` as a subprocess, whose bundle
               classifies phase 11's WAVs through cli.classify.
 15. configs[2] - BASELINE configs[2]: 35 classes at 256 gammatone filters,
               the flagship reservoir, synthetic_audio_batch(30, 35, seed=77):
               B1 at C = 256 against its twin (rtol 5e-3) and against
               float64 by phase 2's rule on phase 2's audio and on the
               configs[2] corpus (every channel <= 1e-3, no worse than the
               twin); B2 with 256 input channels
               bit-equal to its twin on dyadic weights, timed with its plan
               and bound; run_pipeline_arrays on the 1050 utterances (B1 and
               B2 launched, accuracy > 0.25, 35 report rows, 2000 features;
               accuracy and regime recorded); `python -m lsm_tpu_torch
               --synthetic --vocab v35 --n-filters 256 --check --metrics-out
               --single-device` (30 a class, no artifacts) as a subprocess,
               whose metric file holds main.py's names.
 16. dense large - dense reservoirs past 4096 neurons on the block body:
               tools/sparse_parity.py's protocol at N = 4096 (hard corpus
               30 x 12, multiplier 0.6), dense then sparse: every dense
               B2/B4 launch on the block body, B5 launched, the device
               draw's structure held on the card (out-degree, no
               self-loops, zero padding, input fanout); accuracies beside
               docs/SENSITIVITY.md's. A dense reservoir at configs[3] width
               (10240 neurons, k = 2048, multiplier 1.6): B2 bit-equal to
               its twin on dyadic weights at B = 16, T = 400, B4 over ten
               chained 40-step chunks of 64 streams bit-equal; B2 at
               B = 256 timed beside its bound (each input read once, of
               W_rec the rows that fired, counted on the twin's run; beside
               it the fired rows re-read each step and the block body's
               traffic, every weight block each step) and peak memory. 5000 neurons (N_pad 5120): B2
               bit-equal on dyadic weights.
 17. distributed - the batch and training path over several ranks
               (lsm_tpu_torch/parallel). Two gloo ranks share the card
               (NCCL refuses two ranks on one GPU; the port uses only
               all_reduce and broadcast, which gloo takes on CUDA tensors),
               launched as `python3 chip_smoke.py --distributed-worker`
               through the entry points' env contract: phase 4's 2400
               utterances through featurize_audio_array +
               extract_lsm_features on a 2x1 mesh, spikes and features
               bit-equal to one process on the same weights, B1 and B2
               (cluster body) launched in each rank; fit_ridge_dp and
               fit_logistic_dp held to the single-process fits
               (tests/test_readout_dp.py's problem and rule); the
               tensor-parallel block-sparse reservoir at configs[3] width
               on a 1x2 mesh (B = 64, T = 400) bit-equal to B5 on the
               dyadic copy and within SPIKE_REL of its spike total on the
               calibrated weights; make_train_step's loss falling over 5
               steps; `python -m lsm_tpu_torch --synthetic --hard` as two
               processes, exit 0 on both, accuracy within one test row of
               phase 3's and its regime. One NCCL rank on a 1x1 mesh runs
               phase 3's slice through the mesh path, features bit-equal
               to phase 3's. Phase 4's path timed over both meshes beside
               phase 4's single-process wall.
 18. serving over ranks - the serving engines over a mesh, launched as
               `python3 chip_smoke.py --distributed-worker serve_pair|
               serve_single` through the env contract, each rank with a
               timeout. Two gloo ranks sharing the card: ContinuousKWS at
               1024 streams (512 a rank) with phase 6's modules (phase 12's
               continuous bundle), int16 wire, ten hops after a 1 s
               warm-up: the state leaves, features and snapshot bit-equal
               to one process on the same bundle, the logits bit-equal or
               within 1e-5 of each stream's largest with the argmax equal,
               B3 and B4 (cluster body) launched in each rank, the hop wall
               beside phase 7's and one process's; step_active at 25 %
               bit-equal to step with silence in the other rows; a reset of
               half the streams by mask; rank 0 saves with
               save_serving_state, one process loads the file and the ranks
               reload it, both continuing bit-equal. The exact engine at
               256 streams (B1 and B2 once a hop in each rank) and phase
               9's 10240-neuron block-sparse continuous engine at 256 (B6
               in each rank, spike total within SPIKE_REL, bits reported),
               both against one process. `python -m
               lsm_tpu_torch.cli.stream_kws --pool --max-streams 1024` as
               two processes on phase 11's WAVs: predictions equal to phase
               12's static run, `mesh x2`, rank 1 silent. One NCCL rank on
               a 1x1 mesh: the continuous sequence bit-equal to one
               process. Then each measurement tool
               (lsm_tpu_torch/tools/{bench_streaming, bench_continuous,
               bench_state, bench_tp, profile_stages}) once at a small size
               as a subprocess (bench_tp and a --mesh bench_streaming on
               two ranks): exit 0 and a JSON line.

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
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
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
# Phase 11's WAV corpora: 12 classes of this many files each (2400, the
# hot path's count; 360 for the two CLI subprocesses).
OFFLINE_PER_CLASS, CLI_PER_CLASS = 200, 30
# Phase 17's rank processes: this script in its worker mode.
DISTRIBUTED_WORKER = (sys.executable, str(REPO / "chip_smoke.py"), "--distributed-worker")
# Phase 13's configs[0] slice: 4 words of this many utterances each.
CONFIGS0_PER_CLASS = 200
# Phase 14's corpus: configs[4]'s 100k-utterance training corpus cut to
# 24,000 rows (2000 a class) for the run's time limit; the configs[3]
# reservoir trains on the first 2400 of them.
TRAIN_ROWS, TRAIN_ROWS_10K = 24000, 2400
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
    """nvidia-smi's name and power limit of the card (the port's tools
    print the same line)."""
    from lsm_tpu_torch.tools.common import gpu_line as query

    line = query()
    if line is None:
        fail("nvidia-smi --query-gpu=name,power.limit failed")
    return line


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events around `reps` calls
    (lsm_tpu_torch/tools/common.py, which the port's tools time with)."""
    from lsm_tpu_torch.tools.common import cuda_ms as ms

    return ms(fn, reps, warmup)


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
    channel of the kernel's exceeds F64_REL or its worst channel is
    worse than the twin's."""
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
        "source_rows_per_stream_step": rows / (n * hops[0][0].shape[0] * hops[0][0].shape[-1]),
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


# The kernels line's names for the registry's C entry points (ops/_build.py).
KERNEL_ENTRY = {"B1": "lsm_gtgram_sub_energy", "B2": "lsm_lif_stats", "B3": "lsm_gtgram_chunk",
                "B4": "lsm_lif_chunk", "B5": "lsm_sparse_lif_stats", "B6": "lsm_sparse_lif_chunk",
                "encoder": "lsm_hysteresis_encode", "fold": "lsm_fold_window"}


def reset_launches() -> None:
    from lsm_tpu_torch.ops import _build

    _build.launches.clear()


def read_launches() -> dict:
    from lsm_tpu_torch.ops._build import launches

    out = {k: launches[name] for k, name in KERNEL_ENTRY.items()}
    out["dense_bodies"] = {body: launches[f"lsm_lif_stats:{body}"]
                           + launches[f"lsm_lif_chunk:{body}"]
                           for body in ("one_thread", "cluster", "block")}
    return out


def on_cluster_body(launches: dict) -> bool:
    """Every dense B2/B4 launch of a flagship run went through the cluster
    body, and there was one."""
    n = launches["B2"] + launches["B4"]
    return n > 0 and launches["dense_bodies"]["cluster"] == n


def flagship_plan(plan, what: str) -> None:
    """A flagship B2/B4 call must take the cluster body at K = 16."""
    if plan.body != "cluster" or plan.cluster_size != 16:
        fail(f"{what}: the flagship shape planned {plan}, not the cluster body at K = 16")


def dense_timing(plan, ms: float, batch: int, steps: int) -> dict:
    """A dense B2/B4 call's plan, stream-steps per microsecond and
    microseconds a step (a cluster body round is `steps` steps; the
    one-thread body runs every stream at once)."""
    import dataclasses

    rounds = plan.rounds if plan.body == "cluster" else 1
    return {"plan": dataclasses.asdict(plan),
            "stream_steps_per_us": batch * steps / (ms * 1e3),
            "us_per_step": ms * 1e3 / (rounds * steps)}


def plan_text(t: dict) -> str:
    p = t["plan"]
    return (f"{p['body']} body K={p['cluster_size']} M={p['streams']} clusters={p['clusters']} "
            f"(co-resident {p['co_resident']}) rounds={p['rounds']}: "
            f"{t['stream_steps_per_us']:.1f} stream-steps/us, {t['us_per_step']:.3f} us a step")


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
    record["encoder"] = enc = encoder_kernel(dev, card)

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
    # The cluster body against the one-thread body on the calibrated
    # weights: the same sums in the same order, so the same bits.
    plan2 = klif.card_plan(spikes, ops[0].shape[0], kw["refractory"], chunk=False)
    one2 = klif.card_plan(spikes, ops[0].shape[0], kw["refractory"], chunk=False,
                          body=klif.ONE_THREAD)
    flagship_plan(plan2, "B2 at B=256")
    c_out = klif.lif_stats(spikes, *ops_r, **kw_r)
    o_out = klif.lif_stats(spikes, *ops_r, **kw_r, plan=one2)
    torch.cuda.synchronize()
    eq_one = all(torch.equal(a, b) for a, b in zip(c_out, o_out))
    zeros = torch.zeros_like(spikes)
    b2 = {
        "bit_equal_dyadic": bool(equal),
        "max_abs_err": b2_abs,
        "random_weight_feature_max_rel_err": rand_rel,
        "spikes_per_step": float(a_p.sum() / (256 * spikes.shape[-1])),
        "bit_equal_one_thread_calibrated": bool(eq_one),
        "ms": cuda_ms(lambda: klif.lif_stats(spikes, *ops, **kw), reps=5),
        "one_thread_ms": cuda_ms(lambda: klif.lif_stats(spikes, *ops, **kw, plan=one2), reps=5),
        "calibrated_ms": cuda_ms(lambda: klif.lif_stats(spikes, *ops_r, **kw_r), reps=5),
        "zero_input_ms": cuda_ms(lambda: klif.lif_stats(zeros, *ops, **kw), reps=5),
        "plain_ms": cuda_ms(lambda: klif.lif_stats_plain(spikes, *ops, **kw), reps=2),
        # Source rows: every reservoir spike (the last step's, <= 1/T of
        # them, included) and every input spike.
        **bound(lif_flops(float(a_p.sum() + spikes.sum()), spikes.shape[0], spikes.shape[-1],
                          r_rand.n_neurons),
                nbytes(spikes, *ops, s_k, a_k)),
    }
    T2 = spikes.shape[-1]
    b2.update(dense_timing(plan2, b2["ms"], 256, T2))
    b2["zero_input_us_per_step"] = b2["zero_input_ms"] * 1e3 / (plan2.rounds * T2)
    print(f"[B2 lif] B=256 C=128 N=1000 T=400 dyadic: bit_equal {equal} "
          f"max_abs_err {b2_abs:.3e}; random weights feature max rel err "
          f"{rand_rel:.3e}; kernel {b2['ms']:.3f} ms plain {b2['plain_ms']:.3f} ms bound "
          f"{b2['bound_ms']:.4f} ms ({b2['bound_by']}), {b2['spikes_per_step']:.1f} spikes a "
          f"stream-step ({card})")
    print(f"[B2 lif] plan: {plan_text(b2)}; one-thread body {b2['one_thread_ms']:.3f} ms; "
          f"all-zero spikes {b2['zero_input_ms']:.3f} ms ({b2['zero_input_us_per_step']:.3f} us "
          f"a step: signalling, word scans, update, statistics; the row walk the other "
          f"{b2['ms'] - b2['zero_input_ms']:.3f} ms); calibrated weights {b2['calibrated_ms']:.3f} "
          f"ms, bit-equal to the one-thread body {eq_one}")
    if not equal:
        fail("B2 statistics are not bit-equal to the plain twin on dyadic weights")
    if not eq_one:
        fail("B2's cluster body is not bit-equal to its one-thread body on calibrated weights")
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
    every = read_launches()
    launches = {k: v for k, v in every.items() if k in ("B1", "B2", "encoder")}
    record["slice"] = {
        "seconds": slice_s, "accuracy": result.accuracy,
        "regime": ext.diagnostics.regime,
        "avg_participation": ext.diagnostics.avg_participation,
        "mean_weight": ext.mean_weight, "lbfgs_iters": result.n_iters,
        "launches": launches, "dense_bodies": every["dense_bodies"],
    }
    print(ext.diagnostics.render())
    print(result.report.render())
    print(f"[slice] hard corpus 360 utt: accuracy {result.accuracy:.4f} regime "
          f"{ext.diagnostics.regime} lbfgs_iters {result.n_iters} launches "
          f"{launches} (dense bodies {every['dense_bodies']}) wall {slice_s:.2f} s")
    if ext.diagnostics.regime != "EDGE OF CHAOS":
        fail(f"regime {ext.diagnostics.regime}")
    if not ACC_BAND[0] <= result.accuracy <= ACC_BAND[1]:
        fail(f"accuracy {result.accuracy:.4f} outside {ACC_BAND}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path was not launched: {launches}")
    if not on_cluster_body(every):
        fail(f"B2 did not run on the cluster body: {every['dense_bodies']}")
    phase3 = {"x_train": ext.artifact.x_train, "x_test": ext.artifact.x_test,
              "accuracy": result.accuracy, "regime": ext.diagnostics.regime}
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
    plan_h = klif.card_plan(spikes0, ops_h[0].shape[0], kw_h["refractory"], chunk=False)
    flagship_plan(plan_h, f"B2 at B={n}")
    hot_rec["B2_2400"] = dense_timing(plan_h, hot_rec["B2_ms_2400"], n, spikes0.shape[-1])
    hot_rec["B2_share_of_min_wall"] = hot_rec["B2_ms_2400"] / (min(walls) * 1e3)
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
    print(f"[hot] B2 at B={n}: {plan_text(hot_rec['B2_2400'])}; "
          f"{100 * hot_rec['B2_share_of_min_wall']:.1f} % of the min wall")

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
    record["fold"] = fk = fold_kernel(dev, card, cont["engine_args"], engine_10k)
    laps("10 fold kernel")

    # ---- 11-12. offline inference and serving entry points -------------
    with tempfile.TemporaryDirectory(prefix="lsm_offline_") as tmp_name:
        tmp = Path(tmp_name)
        record["offline"] = offline(dev, card, engine_10k, tmp)
        laps("11 offline")
        record["serving_entry"] = serving_engines(dev, card, cont["engine_args"], engine_10k, tmp)
        record["serving_entry"]["cli"] = serving_cli(dev, card, cont["engine_args"], tmp)
        laps("12 serving entry points")
        record["frontends"] = frontends(dev, card, tmp)
        laps("13 frontends")
        record["training"] = corpus_training(dev, card, tmp)
        laps("14 training")
        record["configs2"] = configs2(dev, card, tmp)
        laps("15 configs[2]")
        record["dense_large"] = dense_large(dev, card, spikes)
        laps("16 dense large")
        with tempfile.TemporaryDirectory(prefix="lsm_distributed_") as tmp_name:
            record["distributed"] = distributed(dev, card, Path(tmp_name), phase3, spikes,
                                                [record["hot"]["wall_s_min"]])
        laps("17 distributed")
        record["serving_ranks"] = serving_ranks(dev, card, tmp, record["serving"])
        laps("18 serving over ranks")

    def row(name, key, source, replaces, rec, launches_):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_[key], "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None}

    # No single PyTorch call computes the IIR block scan, the spike-driven
    # LIF recurrence, the hysteresis encoder or the ring fold, so library_ms
    # is null for all.
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
        row("hysteresis_encode", "encoder", "lsm_tpu_torch/csrc/hysteresis.cu", None,
            enc["batch"], launches),
        row("serving_fold", "fold", "lsm_tpu_torch/csrc/fold.cu", None, fk["dense"],
            record["serving"]["launches"]),
    ]}
    record["phase_seconds"] = laps.seconds
    check_no_reference()
    print("[record] " + json.dumps(record))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def encoder_kernel(dev, card) -> dict:
    """The hysteresis encoder's kernel against its plain twin, bit for bit,
    and both timed: at the batch shape (2400 utterances, 128 filters, 100
    bins, contiguous) from the all-off start, and at the serving shape
    (4096 streams, 10 bins, the engine's view of a (T, B, F) tensor) from a
    carried state. Bound: the spectrogram read once, the spikes and the
    state written once."""
    from lsm_tpu_torch.config import FrontendConfig
    from lsm_tpu_torch.ops import hysteresis as hyst
    from lsm_tpu_torch.ops.kernels import hysteresis as khyst

    fcfg = FrontendConfig()
    thr, gap = fcfg.spike_thresholds, fcfg.hysteresis_gap
    on, off = hyst.levels(thr, gap)
    gen = torch.Generator(device=dev).manual_seed(17)
    rec = {}
    for name, (b, t) in {"batch": (2400, fcfg.time_bins), "serve": (4096, 10)}.items():
        if name == "batch":
            spec = torch.rand(b, fcfg.n_filters, t, device=dev, generator=gen)
            state = None
            state0 = torch.zeros(b, len(on), fcfg.n_filters, dtype=torch.bool, device=dev)
            run = lambda: hyst.hysteresis_encode(spec, thr, gap)     # noqa: E731
        else:
            spec = torch.rand(t, b, fcfg.n_filters, device=dev, generator=gen).permute(1, 2, 0)
            state = state0 = torch.rand(b, len(on), fcfg.n_filters, device=dev,
                                        generator=gen) < 0.3
            run = lambda: hyst.hysteresis_encode_step(spec, state, thr, gap)  # noqa: E731
        out = run()
        plain = khyst.encode_plain(spec, state0, on, off)
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        equal = all(torch.equal(a, p) for a, p in zip(outs, plain))
        rec[name] = {"shape": [b, fcfg.n_filters, t], "bit_equal": bool(equal),
                     "max_abs_err": 0.0 if equal else 1.0,
                     "ms": cuda_ms(run, reps=50, warmup=3),
                     "plain_ms": cuda_ms(lambda: khyst.encode_plain(spec, state0, on, off),
                                         reps=5),
                     **bound(0.0, nbytes(spec, *outs) + (0 if state is None else nbytes(state)))}
        r = rec[name]
        print(f"[encoder] {name} B={b} F={fcfg.n_filters} T={t}: bit_equal {equal} kernel "
              f"{r['ms']:.4f} ms plain {r['plain_ms']:.3f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) ({card})")
        if not equal:
            fail(f"the encoder kernel differs from its plain twin at the {name} shape")
    return rec


def fold_kernel(dev, card, dense, sparse) -> dict:
    """The serving fold kernel against its plain twin on the same CUDA
    tensors, bit for bit: `dense` (reservoir, readout, scaler) at 4096
    streams and `sparse` at N_SERVE, each on the rings of a live engine
    after one 1 s window of int16 hops, with the next hop's reservoir
    output; the push and the fold-only mode. Times from CUDA events. Bound:
    the bytes the kernel must move (the pushed rings' slots read once and
    written once, the window ring likewise, the features written)."""
    from lsm_tpu_torch.config import PipelineConfig
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.models.continuous import ContinuousKWS
    from lsm_tpu_torch.models.streaming import decode_pcm_device
    from lsm_tpu_torch.ops.kernels import fold as kfold

    cfg = PipelineConfig()
    audio, _ = dataset.synthetic_audio_batch_hard(86, 12, seed=9)
    n_hops = cfg.frontend.num_samples // CHUNK + 1
    rec = {}
    for name, (modules, n) in {"dense": (dense, 4096), "sparse": (sparse, N_SERVE)}.items():
        # Stream s plays utterance s % 1032 from an offset of its own,
        # wrapping at the end of the second.
        s = np.arange(n)
        t = ((s // audio.shape[0]) * 311)[:, None] + np.arange(n_hops * CHUNK)
        wave = np.take_along_axis(audio[s % audio.shape[0]], t % audio.shape[1], axis=1)
        wire = np.clip(wave * 32768.0, -32768.0, 32767.0).astype(np.int16)
        hops = [np.ascontiguousarray(wire[:, c * CHUNK:(c + 1) * CHUNK]) for c in range(n_hops)]
        kws = ContinuousKWS(*modules, cfg.frontend, cfg.feature_set, n_streams=n,
                            chunk_len=CHUNK)
        for h in hops[:-1]:
            kws.step(h)
        st = kws.state
        spikes = kws._featurize(decode_pcm_device(torch.as_tensor(hops[-1]).to(dev)), st)[0]
        new_seg, win_new = kws._reservoir_chunk(spikes, st)[3:]
        args = (st.segs, st.win_ring, kws._t_c, kws.reservoir.burst_isi_max, kws.keys)
        before = read_launches()["fold"]
        out, only = kfold.fold(*args, new_seg, win_new), kfold.fold(*args)
        ref, ref_only = kfold.fold_plain(*args, new_seg, win_new), kfold.fold_plain(*args)
        torch.cuda.synchronize()
        launched = read_launches()["fold"] - before
        rings = (all(torch.equal(out[0][k], ref[0][k]) for k in ref[0])
                 and torch.equal(out[1], ref[1]))
        equal = rings and torch.equal(out[2], ref[2]) and torch.equal(only[2], ref_only[2])
        err = max(float((out[2] - ref[2]).abs().max()), float((only[2] - ref_only[2]).abs().max()))
        fired = float((ref_only[2][:, :st.segs["counts"].shape[2]] > 0).float().mean())
        ring_bytes = nbytes(*out[0].values())
        r = {"streams": n, "outputs": int(st.segs["counts"].shape[2]),
             "n_ring": int(st.segs["counts"].shape[0]), "n_win": int(st.win_ring.shape[2]),
             "keys": list(kws.keys), "bit_equal": bool(equal), "rings_bit_equal": bool(rings),
             "max_abs_err": err, "fired_share": fired, "launches_a_call": launched / 2,
             "ms": cuda_ms(lambda: kfold.fold(*args, new_seg, win_new), reps=50, warmup=3),
             "fold_only_ms": cuda_ms(lambda: kfold.fold(*args), reps=50, warmup=3),
             "plain_ms": cuda_ms(lambda: kfold.fold_plain(*args, new_seg, win_new), reps=5),
             **bound(0.0, 2 * ring_bytes + 2 * nbytes(out[1]) + nbytes(out[2]))}
        r["fold_only_bound_ms"] = bound(0.0, ring_bytes + nbytes(out[1], out[2]))["bound_ms"]
        rec[name] = r
        print(f"[fold] {name} {n} streams x {r['outputs']} outputs, {r['n_ring']} slots, "
              f"{r['n_win']} rate windows, {len(kws.keys)} features ({fired:.1%} of the outputs "
              f"fired): bit_equal {equal} kernel {r['ms']:.4f} ms (fold only "
              f"{r['fold_only_ms']:.4f} ms) plain {r['plain_ms']:.3f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB; fold only "
              f"{r['fold_only_bound_ms']:.4f} ms) ({card})")
        if not equal:
            fail(f"the fold kernel differs from its plain twin at {n} {name} streams "
                 f"(rings equal {rings}, features max abs err {err:.3e})")
        if launched != 2:
            fail(f"two fold calls launched the kernel {launched} times")
        if not 0.0 < fired < 1.0:
            fail(f"{fired:.1%} of the {name} outputs fired: the rings test no silent neuron "
                 "or no busy one")
        del kws, st, args, new_seg, win_new, out, only, ref, ref_only
        torch.cuda.empty_cache()
    return rec


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
        before = read_launches()["B1"]
        on_card = featurize_batch(wave, fcfg).cpu()
        launched = read_launches()["B1"] - before
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
    if min(launches["B3"], launches["B4"], launches["fold"]) <= 0:
        fail(f"a kernel of the continuous path was not launched: {launches}")
    if not on_cluster_body(launches):
        fail(f"B2/B4 did not run on the cluster body: {launches['dense_bodies']}")
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
    if launches["fold"] != len(hops) + len(walls):
        fail(f"the fold kernel launched {launches['fold']} times over "
             f"{len(hops) + len(walls)} hops, not once a hop")
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
    else:
        if not on_cluster_body(launches):
            fail(f"B4 did not serve on the cluster body: {launches['dense_bodies']}")
        ck.update(b4_against_one_thread(ck_hops, ops, kw, ck["ms"]))
        if not ck["bit_equal_one_thread"]:
            fail("B4's cluster body is not bit-equal to its one-thread body at serving weights")
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
    if name == "B4":
        print(f"[serving] B4 plan: {plan_text(ck)}; {ck['source_rows_per_stream_step']:.2f} "
              f"fired source rows a stream-step; one-thread body {ck['one_thread_ms']:.3f} ms, "
              f"bit-equal to it on every hop {ck['bit_equal_one_thread']}; host "
              f"{ck['host_us_per_call']:.1f} us a call")
    for k, ms in ck.get("device_ms_by_kernel", {}).items():
        print(f"[serving]   {name} {ms:8.4f} ms/hop  {k[:100]}")
    for t in rec["top_device"]:
        print(f"[serving]   {t['us'] / 1e3 / prof['calls']:8.3f} ms/hop x{t['count'] // prof['calls']:4d}"
              f"  {t['name']}")
    return rec


def b4_against_one_thread(hops, ops, kw, ms: float) -> dict:
    """B4 at serving shapes over `hops` (x, carried state): its plan (the
    cluster body at K = 16) and timing from `ms`, its outputs bit-equal to
    the one-thread body's on every hop (calibrated weights), the one-thread
    body's time a hop, and the fired source rows (carried and recurrent
    spikes, input spikes) a stream-step from `chunk_measure`'s count."""
    from lsm_tpu_torch.ops.kernels import lif as klif

    x0 = hops[0][0]
    b, _, t = x0.shape
    plan = klif.card_plan(x0, ops[0].shape[0], kw["refractory"], chunk=True)
    one = klif.card_plan(x0, ops[0].shape[0], kw["refractory"], chunk=True,
                         body=klif.ONE_THREAD)
    flagship_plan(plan, f"B4 at {b} streams")
    equal = True
    for x, carried in hops:
        out_c = klif.lif_chunk(x, *ops, *carried, **kw)
        out_o = klif.lif_chunk(x, *ops, *carried, **kw, plan=one)
        equal = equal and all(torch.equal(c, o) for c, o in zip(out_c, out_o))
    torch.cuda.synchronize()
    one_ms = cuda_ms(lambda: [klif.lif_chunk(x, *ops, *c, **kw, plan=one) for x, c in hops],
                     reps=2) / len(hops)
    # The host's share of a serving launch: lif_chunk from its checks to the
    # enqueued kernel (plan, outputs, ctypes call), the card not waited on.
    x, carried = hops[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        klif.lif_chunk(x, *ops, *carried, **kw)
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    return {"bit_equal_one_thread": bool(equal), "one_thread_ms": one_ms,
            "host_us_per_call": host_us, **dense_timing(plan, ms, b, t)}


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
    before = ksp.counts.copy()
    s_c, a_c = ksp.sparse_lif_stats(spikes, *ops_c, **kw_c)
    # The block body's tiling on this card (a CPU rehearsal: one SM).
    plan = (ksp.card_block_plan(spikes, N_10K, S) if spikes.is_cuda
            else ksp.block_plan(B, N_10K, S, C, 1))
    entry = "lsm_sparse_lif_stats"
    block = {f: ksp.counts[f"{entry}:{f}"] - before[f"{entry}:{f}"]
             for f in ("steps", "block_uses", "block_loads")}
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
        "block_plan": {"tile": plan.tile, "tiles": plan.tiles, "ctas": plan.ctas},
        "block_counts": block,
        "loads_saved": 1.0 - block["block_loads"] / max(block["block_uses"], 1),
    }
    print(f"[B5 sparse_lif] N={N_10K} k={K_10K} S={S} C={C} T={T}, mean weight {mw:.6f} "
          f"(init {init_s:.1f} s): dyadic bit_equal {equal} max_abs_err {err:.3e}; "
          f"calibrated B={B}: {b5['spikes_per_step']:.4f} spikes a row-step (twin "
          f"{b5['plain_spikes_per_step']:.4f}, ratio {b5['spikes_ratio_to_plain']:.6f}), "
          f"participation {b5['participation']:.6f} (twin {b5['plain_participation']:.6f}), "
          f"kernel {b5['ms']:.3f} ms plain "
          f"{b5['plain_ms']:.3f} ms bound {b5['bound_ms']:.4f} ms ({b5['bound_by']}; block "
          f"form {b5['block_form_ms']:.4f} ms; tensor-core bound "
          f"{b5['tensor_core_bound_ms']:.4f} ms) ({card}); block body: tile {plan.tile}, "
          f"{plan.tiles} tiles, {plan.ctas} CTAs, {block['steps']} steps, "
          f"{block['block_uses']} block uses, {block['block_loads']} loads "
          f"(share saved {b5['loads_saved']:.3f})")
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


def timed(fn):
    """(seconds, fn()) on the host clock, the card synchronized before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def run_in_process(reservoir, readout, sc, x: np.ndarray, keys, batch: int, dev) -> tuple:
    """extract_features, then transform(scaler), then the readout's logits
    and predict's argmax, over x in batches of `batch` rows as
    classify_spikes_streaming batches them, without its bit packing:
    (features, logits, predictions) on the host."""
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.readout import logistic, scaler

    feats, logits, preds = [], [], []
    for s in range(0, x.shape[0], batch):
        f = res.extract_features(reservoir, torch.as_tensor(x[s:s + batch]).to(dev), keys)
        z = scaler.transform(sc, f)
        feats.append(f.cpu())
        logits.append(readout(z).cpu())
        preds.append(logistic.predict(readout, z).cpu())
    return torch.cat(feats), torch.cat(logits), torch.cat(preds).numpy().astype(np.int32)


def same_modules(a: tuple, b: tuple, x: np.ndarray, keys, batch: int, dev) -> tuple:
    """Run two (reservoir, readout, scaler) triples on the same spikes:
    (features bit-equal, logits bit-equal, a's predictions). A reload that
    lost or permuted a weight changes the features or the logits even where
    every prediction stays the same."""
    fa, za, pa = run_in_process(*a, x, keys, batch, dev)
    fb, zb, _ = run_in_process(*b, x, keys, batch, dev)
    return torch.equal(fa, fb), torch.equal(za, zb), pa


def run_cli(args: list, card: str, timeout: int = 600) -> tuple:
    """`python -m <args>` from the checkout's root: (seconds, stdout);
    fails on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *map(str, args)], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:])
        print(proc.stderr[-3000:])
        fail(f"`python -m {' '.join(map(str, args))}` exited {proc.returncode} ({card})")
    return seconds, proc.stdout


def offline(dev, card, sparse_modules, tmp: Path) -> dict:
    """Phase 11: offline inference from WAVs on disk at the flagship config
    (128 filters, 1000 neurons). A corpus of OFFLINE_PER_CLASS x 12
    synthetic WAVs plus one corrupt file: create_spike_dataset in memory on
    the int16 wire bit-equal to load_audio_batch (float32) +
    featurize_audio_array, the corrupt file skipped with the labels aligned,
    the sharded route (1000 a shard) equal through load_spike_dataset_any,
    the mu-law route's flip fraction against int16 recorded, the int16
    route alone launching B1 once a batch; then extract_lsm_features +
    train_and_evaluate, save_model, load_model on the card, and
    classify_spikes_streaming over the in-memory source and the shards
    equal to each other and to the trained modules' in-process predictions,
    each of the two calls alone launching B2 once a batch, all on the
    cluster body; the reloaded modules' features and logits bit-equal to
    the trained ones'. Phase 9's configs[3] modules go through a v2-sparse
    bundle the same way (B5 once a batch; its readout was fitted on the
    hard corpus, so on this corpus the features and logits tell a right
    reload from a wrong one where the predictions may not). Then the CLIs
    as subprocesses on a CLI_PER_CLASS x 12
    corpus: `python -m lsm_tpu_torch --data-dir ... --save-model`, then
    `python -m lsm_tpu_torch.cli.classify` with that bundle over its shards
    (--input) and over its WAVs (--data-dir), whose predictions must both
    equal the in-process ones of that bundle. The native C++ decoder must
    build and decode every batch; on the corpus it is held to the NumPy
    decoder (int16 and mu-law wires bit-equal, float32 within 1e-6, the
    corrupt file skipped by both). Times: the warm rate (classifying the
    shards on disk), the cold rate (WAVs to predictions) with the share of
    its wall the decode worker is busy, for the native decoder and the
    NumPy one, the bundles' sizes and load times."""
    import dataclasses

    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import COMMANDS_12, FEATURE_SETS, PipelineConfig
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.io.model import load_model, save_model
    from lsm_tpu_torch.io.sharded import ShardedSpikeDataset
    from lsm_tpu_torch.io.wav import load_audio_batch
    from lsm_tpu_torch.models.sparse import SparseReservoir

    cfg = PipelineConfig()
    keys = tuple(FEATURE_SETS[cfg.feature_set])
    n_utt = OFFLINE_PER_CLASS * len(COMMANDS_12)
    labels = np.repeat(np.arange(len(COMMANDS_12), dtype=np.int32), OFFLINE_PER_CLASS)
    rec = {"utterances": n_utt, "batch_size": cfg.batch_size}

    corpus = tmp / "corpus"
    rec["corpus_write_s"], _ = timed(lambda: dataset.write_synthetic_corpus(
        corpus, COMMANDS_12, n_per_class=OFFLINE_PER_CLASS, seed=42))
    corrupt = corpus / COMMANDS_12[5] / "00007_corrupt.wav"
    corrupt.write_bytes(b"RIFF\x24\x00\x00\x00WAVEfmt " + bytes(8))

    # ---- the native decoder against the NumPy one ------------------
    from lsm_tpu_torch.io import native

    if not native.available():
        fail(f"the native WAV decoder did not build on the card's host: "
             f"{native.unavailable_reason()}")
    files = dataset.index_speech_commands(corpus, cfg.commands, cfg.max_samples_per_class).files
    n_batches = -(-n_utt // cfg.batch_size)
    b1_want = -(-len(files) // cfg.batch_size)
    decoders = {}
    for wire in ("int16", "ulaw", "float32"):
        before = native.batches
        t_nat, (nat, kept_n, err_n) = timed(lambda: load_audio_batch(files, dtype=wire))
        native_ran = native.batches == before + 1
        t_np, (ref, kept_r, err_r) = timed(
            lambda: load_audio_batch(files, use_native=False, dtype=wire))
        same_rows = kept_n == kept_r and [p.name for p, _ in err_n] == \
            [p.name for p, _ in err_r] == [corrupt.name]
        if wire == "float32":
            held = same_rows and bool(np.allclose(nat, ref, rtol=0, atol=1e-6))
        else:
            held = same_rows and bool(np.array_equal(nat, ref))
        decoders[wire] = {"native_s": t_nat, "numpy_s": t_np, "native_ran": native_ran,
                          "held": held, "max_abs_diff": float(np.abs(
                              nat.astype(np.float64) - ref.astype(np.float64)).max())
                          if nat.shape == ref.shape else None}
    del nat, ref
    rec["decoders"] = decoders
    print(f"[offline] native decoder vs NumPy on {len(files)} WAVs: " + "; ".join(
        f"{w} native {d['native_s']:.3f} s NumPy {d['numpy_s']:.3f} s held {d['held']} "
        f"(max |diff| {d['max_abs_diff']})" for w, d in decoders.items()) + f" ({card})")
    if not all(d["native_ran"] and d["held"] for d in decoders.values()):
        fail(f"the native decoder against the NumPy one: {decoders}")

    # ---- featurize: four routes ------------------------------------
    reset_launches()
    before = native.batches
    rec["featurize_int16_s"], ds = timed(lambda: pipeline.create_spike_dataset(cfg, corpus, dev))
    rec["launches_featurize_int16"] = read_launches()
    if native.batches - before != b1_want:
        fail(f"the native decoder decoded {native.batches - before} of create_spike_dataset's "
             f"{b1_want} batches")
    rec["decode_float32_s"], (audio, kept, errors) = timed(
        lambda: load_audio_batch(files, dtype="float32"))
    sp_f32 = pipeline.featurize_audio_array(cfg, audio, dev)
    rec["int16_equals_float32"] = bool(np.array_equal(ds.x_spikes, sp_f32))
    rec["skipped"] = [p.name for p, _ in errors]
    rec["labels_aligned"] = bool(np.array_equal(ds.y_labels, labels))
    del audio, sp_f32
    rec["featurize_sharded_s"], _ = timed(lambda: pipeline.create_spike_dataset(
        cfg, corpus, dev, sharded_output=tmp / "shards", shard_size=1000))
    back = pipeline.load_spike_dataset_any(tmp / "shards")
    rec["sharded_equals_in_memory"] = bool(np.array_equal(back.x_spikes, ds.x_spikes)
                                           and np.array_equal(back.y_labels, ds.y_labels))
    del back
    ds_u = pipeline.create_spike_dataset(dataclasses.replace(cfg, audio_wire="ulaw"),
                                         corpus, dev)
    rec["ulaw_flip_fraction"] = float((ds_u.x_spikes != ds.x_spikes).mean())
    del ds_u
    print(f"[offline] {n_utt} WAVs (+1 corrupt) at {cfg.frontend.n_filters} filters: int16 "
          f"route {rec['featurize_int16_s']:.2f} s, bit-equal to float32 "
          f"{rec['int16_equals_float32']}; skipped {rec['skipped']}, labels aligned "
          f"{rec['labels_aligned']}; shards equal {rec['sharded_equals_in_memory']}; mu-law "
          f"flips {rec['ulaw_flip_fraction']:.3e} of the int16 spikes; the int16 route "
          f"alone launched B1 {rec['launches_featurize_int16']['B1']} times for "
          f"{len(files)} files ({card})")
    if not (rec["int16_equals_float32"] and rec["labels_aligned"]
            and rec["sharded_equals_in_memory"] and rec["skipped"] == [corrupt.name]
            and ds.x_spikes.shape == (n_utt, cfg.frontend.n_filters, 400)):
        fail(f"offline featurization: {rec}")
    if rec["launches_featurize_int16"]["B1"] != b1_want:
        fail(f"the int16 create_spike_dataset launched {rec['launches_featurize_int16']}, "
             f"not B1 once for each of its {b1_want} batches")

    # ---- train, save, reload, classify -----------------------------
    ext = pipeline.extract_lsm_features(cfg, ds, dev)
    result = pipeline.train_and_evaluate(cfg, ext.artifact, dev)
    model = tmp / "m.npz"
    save_model(model, ext.reservoir, result.readout, ext.scaler, cfg.frontend,
               cfg.feature_set, cfg.commands)
    rec["bundle_bytes"] = model.stat().st_size
    rec["bundle_load_s"], bundle = timed(lambda: load_model(model, dev))
    classified, launches = {}, {}
    for name, source in (("memory", pipeline.InMemorySource(ds)),
                         ("shards", ShardedSpikeDataset(tmp / "shards"))):
        reset_launches()
        classified[name] = pipeline.classify_spikes_streaming(
            cfg, source, bundle.reservoir, bundle.readout, bundle.scaler, dev)
        launches[name] = read_launches()
    (p_mem, l_mem), (p_sh, l_sh) = classified["memory"], classified["shards"]
    feats_eq, logits_eq, p_in = same_modules(
        (ext.reservoir, result.readout, ext.scaler),
        (bundle.reservoir, bundle.readout, bundle.scaler), ds.x_spikes, keys,
        cfg.batch_size, dev)
    rec.update(train_accuracy=result.accuracy, regime=ext.diagnostics.regime,
               classify_accuracy=float((p_mem == labels).mean()),
               shards_equal_in_memory=bool(np.array_equal(p_sh, p_mem)
                                           and np.array_equal(l_sh, l_mem)),
               equal_in_process=bool(np.array_equal(p_mem, p_in)),
               features_equal=feats_eq, logits_equal=logits_eq,
               launches_classify={k: {"B2": v["B2"], "dense_bodies": v["dense_bodies"]}
                                  for k, v in launches.items()})
    print(f"[offline] dense bundle {rec['bundle_bytes'] / 1e6:.2f} MB, load to the card "
          f"{rec['bundle_load_s'] * 1e3:.1f} ms; test accuracy {result.accuracy:.4f} "
          f"{rec['regime']}; classify accuracy {rec['classify_accuracy']:.4f}, shards = "
          f"in memory {rec['shards_equal_in_memory']}, = in-process "
          f"{rec['equal_in_process']}; reloaded = trained: features {feats_eq}, logits "
          f"{logits_eq}; each classify launched B2 "
          f"{launches['memory']['B2']} (memory) and {launches['shards']['B2']} (shards) "
          f"times for {n_batches} batches ({card})")
    if not (rec["shards_equal_in_memory"] and rec["equal_in_process"] and feats_eq
            and logits_eq and np.array_equal(l_mem, labels)):
        fail(f"the reloaded dense bundle: {rec}")
    for name, got in launches.items():
        if got["B2"] != n_batches or not on_cluster_body(got):
            fail(f"classify over {name} launched {got}, not B2 once for each of its "
                 f"{n_batches} batches on the cluster body")

    # ---- rates -----------------------------------------------------
    warm = [timed(lambda: pipeline.classify_spikes_streaming(
        cfg, ShardedSpikeDataset(tmp / "shards"), bundle.reservoir, bundle.readout,
        bundle.scaler, dev))[0] for _ in range(3)]
    # The decode worker's busy seconds inside each cold run (wrapping
    # the loader create_spike_dataset calls), against that run's wall; the
    # native decoder, then the NumPy one, in the same call.
    decode_busy = []

    def busy_decode(use_native):
        def decode(*args, **kw):
            t0 = time.perf_counter()
            out = load_audio_batch(*args, use_native=use_native, **kw)
            decode_busy.append(time.perf_counter() - t0)
            return out
        return decode

    cold = {}
    try:
        for name, use_native in (("native", True), ("numpy", False)):
            pipeline.load_audio_batch = busy_decode(use_native)
            cold[name] = []
            for _ in range(3):
                decode_busy.clear()
                before = native.batches
                wall, _ = timed(lambda: pipeline.classify_spikes_streaming(
                    cfg, pipeline.InMemorySource(pipeline.create_spike_dataset(cfg, corpus, dev)),
                    bundle.reservoir, bundle.readout, bundle.scaler, dev))
                cold[name].append((wall, sum(decode_busy)))
                if (native.batches - before == b1_want) != use_native:
                    fail(f"the {name} cold run's batches went through the native decoder "
                         f"{native.batches - before} times of {b1_want}")
    finally:
        pipeline.load_audio_batch = load_audio_batch
    best = min(cold["native"])
    best_np = min(cold["numpy"])
    rec.update(warm_s=warm, cold_s=[c[0] for c in cold["native"]],
               cold_decode_s=[c[1] for c in cold["native"]], warm_utt_per_s=n_utt / min(warm),
               warm_utt_per_s_median=n_utt / statistics.median(warm),
               cold_utt_per_s=n_utt / best[0], decode_share_of_cold=best[1] / best[0],
               cold_numpy_s=[c[0] for c in cold["numpy"]],
               cold_numpy_decode_s=[c[1] for c in cold["numpy"]],
               cold_numpy_utt_per_s=n_utt / best_np[0],
               decode_share_of_cold_numpy=best_np[1] / best_np[0])
    print(f"[offline] warm: {n_utt} utt from shards on disk -> predictions "
          f"{rec['warm_utt_per_s']:.1f} utt/s (walls " + " ".join(f"{w:.3f}" for w in warm)
          + " s)")
    for name, runs in cold.items():
        b = min(runs)
        print(f"[offline] cold, {name} decoder: WAVs on disk -> predictions "
              f"{n_utt / b[0]:.1f} utt/s (walls " + " ".join(f"{c[0]:.3f}" for c in runs)
              + " s; the decode worker busy " + " ".join(f"{c[1]:.3f}" for c in runs)
              + f" s, {100 * b[1] / b[0]:.1f} % of the fastest wall) ({card})")

    # ---- the sparse bundle (phase 9's configs[3] modules) ------------
    s_res, s_ro, s_sc = sparse_modules
    s_model = tmp / "sparse.npz"
    rec["sparse_save_s"], _ = timed(lambda: save_model(
        s_model, s_res, s_ro, s_sc, cfg.frontend, cfg.feature_set, cfg.commands))
    rec["sparse_bundle_bytes"] = s_model.stat().st_size
    rec["sparse_bundle_load_s"], s_bundle = timed(lambda: load_model(s_model, dev))
    s_cfg = PipelineConfig(frontend=s_bundle.frontend, feature_set=s_bundle.feature_set,
                           commands=s_bundle.class_names)
    s_ds = pipeline.create_spike_dataset(s_cfg, corpus, dev)
    reset_launches()
    p_s, _ = pipeline.classify_spikes_streaming(
        s_cfg, pipeline.InMemorySource(s_ds), s_bundle.reservoir, s_bundle.readout,
        s_bundle.scaler, dev)
    s_launches = read_launches()
    s_batches = -(-n_utt // s_cfg.batch_size)
    s_feats_eq, s_logits_eq, p_s_in = same_modules(
        (s_res, s_ro, s_sc), (s_bundle.reservoir, s_bundle.readout, s_bundle.scaler),
        s_ds.x_spikes, keys, s_cfg.batch_size, dev)
    rec["sparse"] = {"kind": type(s_bundle.reservoir).__name__,
                     "equal_in_process": bool(np.array_equal(p_s, p_s_in)),
                     "features_equal": s_feats_eq, "logits_equal": s_logits_eq,
                     "accuracy": float((p_s == labels).mean()),
                     "distinct_predictions": int(np.unique(p_s).size),
                     "launches_B5": s_launches["B5"]}
    print(f"[offline] sparse bundle (N={s_res.n_neurons}) {rec['sparse_bundle_bytes'] / 1e6:.2f}"
          f" MB, save {rec['sparse_save_s']:.2f} s, load to the card "
          f"{rec['sparse_bundle_load_s'] * 1e3:.1f} ms; predictions = phase 9's modules "
          f"{rec['sparse']['equal_in_process']}, reloaded = phase 9's: features "
          f"{s_feats_eq}, logits {s_logits_eq}; accuracy {rec['sparse']['accuracy']:.4f} "
          f"({rec['sparse']['distinct_predictions']} distinct classes predicted), classify "
          f"launched B5 {s_launches['B5']} times for {s_batches} batches ({card})")
    if not (isinstance(s_bundle.reservoir, SparseReservoir)
            and rec["sparse"]["equal_in_process"] and s_feats_eq and s_logits_eq
            and s_launches["B5"] == s_batches):
        fail(f"the reloaded sparse bundle: {rec['sparse']}")
    del s_bundle, s_ds

    # ---- the CLIs as subprocesses ------------------------------------
    corpus30 = tmp / "corpus30"
    dataset.write_synthetic_corpus(corpus30, COMMANDS_12, n_per_class=CLI_PER_CLASS, seed=7)
    cli_model = tmp / "cli_model.npz"
    main_s, main_out = run_cli(["lsm_tpu_torch", "--data-dir", corpus30, "--save-model",
                                cli_model, "--skip-artifacts", "--device", dev.type], card)
    cli_bundle = load_model(cli_model, dev)
    c_cfg = PipelineConfig(frontend=cli_bundle.frontend, commands=cli_bundle.class_names)
    pipeline.create_spike_dataset(c_cfg, corpus30, dev, sharded_output=tmp / "shards30")
    classify_s, _ = run_cli(["lsm_tpu_torch.cli.classify", "--model", cli_model, "--input",
                             tmp / "shards30", "--output", tmp / "preds.npz", "--device",
                             dev.type], card)
    wav_s, _ = run_cli(["lsm_tpu_torch.cli.classify", "--model", cli_model, "--data-dir",
                        corpus30, "--output", tmp / "preds_wav.npz", "--device", dev.type],
                       card)
    got = np.load(tmp / "preds.npz")
    p_wav = np.load(tmp / "preds_wav.npz")["predictions"]
    p_ref, _ = pipeline.classify_spikes_streaming(
        c_cfg, ShardedSpikeDataset(tmp / "shards30"), cli_bundle.reservoir,
        cli_bundle.readout, cli_bundle.scaler, dev)
    acc_line = [ln for ln in main_out.splitlines() if ln.startswith("Test Accuracy:")]
    rec["cli"] = {"main_s": main_s, "classify_s": classify_s, "classify_wav_s": wav_s,
                  "main_test_accuracy_line": acc_line[-1] if acc_line else None,
                  "predictions_equal": bool(np.array_equal(got["predictions"], p_ref)
                                            and np.array_equal(p_wav, p_ref)),
                  "classify_accuracy": float((got["predictions"] == got["labels"]).mean())}
    print(f"[offline] CLIs on {CLI_PER_CLASS * 12} WAVs: python -m lsm_tpu_torch --save-model "
          f"{main_s:.1f} s ({rec['cli']['main_test_accuracy_line']}), cli.classify --input "
          f"<shards> {classify_s:.1f} s and --data-dir {wav_s:.1f} s, predictions of both "
          f"= in-process "
          f"{rec['cli']['predictions_equal']}, accuracy {rec['cli']['classify_accuracy']:.4f}"
          f" ({card})")
    if not rec["cli"]["predictions_equal"] or len(got["predictions"]) != CLI_PER_CLASS * 12:
        fail(f"the CLIs' predictions: {rec['cli']}")
    return rec


def serving_hops(n_streams: int):
    """The serving cell's audio (phase 7's corpus) as 10 hops of 100 ms on
    each wire: {wire: [(n_streams, CHUNK), ...]}."""
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.io.wav import to_pcm16_wire
    from lsm_tpu_torch.ops.ulaw import encode_ulaw_f32

    audio, _ = dataset.synthetic_audio_batch_hard(86, 12, seed=9)
    audio = audio[:n_streams]
    hops = [np.ascontiguousarray(audio[:, c * CHUNK:(c + 1) * CHUNK]) for c in range(10)]
    return {"f32": hops, "pcm16": [to_pcm16_wire(h) for h in hops],
            "ulaw": [encode_ulaw_f32(h) for h in hops]}


def engine_gates(kws, hops) -> dict:
    """From one engine state: step_compact's preds against step's argmax;
    step_active with every other stream active bit-equal to step with
    wire silence in the other rows, on all three wires; stream(depth=2)
    (asynchronous copies to the host) and steps_fused(3) against three
    serial steps. The state is put back after each comparison (snapshot /
    restore)."""
    from lsm_tpu_torch.models.streaming import wire_silence

    snap = kws.snapshot()
    serial = [kws.step(h) for h in hops["pcm16"][:3]]
    logits = serial[0]
    kws.restore(snap)
    piped = list(kws.stream(hops["pcm16"][:3], depth=2))
    kws.restore(snap)
    fused = kws.steps_fused(hops["pcm16"][0], 3)
    fused_state = kws.snapshot()
    kws.restore(snap)
    for _ in range(3):
        last = kws.step(hops["pcm16"][0])
    # The checksum is summed on the engine's device, so the serial one is too.
    last_sum = float(torch.sum(torch.as_tensor(last).to(kws.device), dtype=torch.float32))
    serial_state = kws.snapshot()
    kws.restore(snap)
    preds, margins = kws.step_compact(hops["pcm16"][0])
    kws.restore(snap)
    idx = np.arange(0, kws.n_streams, 2)
    active = {}
    for w, hs in hops.items():
        full = np.full_like(hs[1], wire_silence(hs[1].dtype))
        full[idx] = hs[1][idx]
        want = kws.step(full)
        kws.restore(snap)
        got = kws.step_active(hs[1][idx], idx)
        kws.restore(snap)
        active[w] = bool(np.array_equal(got, want))
    rec = {"compact_preds_equal_argmax": bool(np.array_equal(preds, logits.argmax(-1))),
           "compact_margin_min": float(margins.min()),
           "step_active_bit_equal": active,
           "stream_bit_equal": all(np.array_equal(a, b) for a, b in zip(piped, serial))
           and len(piped) == 3,
           "steps_fused_equal": fused == last_sum and all(
               np.array_equal(v, serial_state[k]) for k, v in fused_state.items())}
    if not (rec["compact_preds_equal_argmax"] and all(active.values())
            and rec["stream_bit_equal"] and rec["steps_fused_equal"]):
        fail(f"{type(kws).__name__} at {kws.n_streams} streams: {rec}")
    return rec


def hop_walls(kws, hops, n: int) -> dict:
    """Host wall of n hops of step() on the int16 wire, each ending in
    synchronize(): median, min, stream-chunks/s, real-time factor."""
    walls = []
    for i in range(n):
        walls.append(timed(lambda: kws.step(hops["pcm16"][i % 10]))[0])
    med = statistics.median(walls)
    return {"streams": kws.n_streams, "hops_timed": n, "hop_wall_ms_median": med * 1e3,
            "hop_wall_ms_min": min(walls) * 1e3, "stream_chunks_per_s": kws.n_streams / med,
            "real_time_factor": 0.1 / med}


def continues_bit_exactly(make, kws, hops, path: Path, n: int, compress: bool) -> dict:
    """Save `kws`, load the file into a fresh engine from `make()`, and run
    both over the next n hops: their logits must be bit-equal. Seconds of
    the save and the load, the file's bytes."""
    from lsm_tpu_torch.io.serving_state import load_serving_state, save_serving_state

    save_s, _ = timed(lambda: save_serving_state(path, kws, compress=compress))
    fresh = make()
    load_s, _ = timed(lambda: load_serving_state(path, fresh))
    equal = all(np.array_equal(fresh.step(hops["pcm16"][i % 10]), kws.step(hops["pcm16"][i % 10]))
                for i in range(n))
    return {"compress": compress, "bytes": path.stat().st_size, "save_s": save_s,
            "load_s": load_s, "next_hops": n, "bit_equal": bool(equal)}


def serving_engines(dev, card, dense, sparse, tmp: Path) -> dict:
    """Phase 12, items 1-3: the exact engine and the rest of the continuous
    engine at full width, with phase 6's dense modules and phase 9's
    10240-neuron ones."""
    from lsm_tpu_torch.config import PipelineConfig
    from lsm_tpu_torch.io.serving_state import migrate_streams
    from lsm_tpu_torch.models.continuous import ContinuousKWS
    from lsm_tpu_torch.models.streaming import StreamingKWS, exact_counts

    cfg = PipelineConfig()
    fcfg, fs = cfg.frontend, cfg.feature_set
    hops = serving_hops(N_SERVE)
    rec = {}

    # ---- 1. exact engine, dense, 1024 streams ------------------------------
    def exact(modules, n):
        return StreamingKWS(*modules, fcfg, fs, n_streams=n)

    kws = exact(dense, N_SERVE)
    for h in hops["pcm16"]:                                   # warm-up: one window
        kws.step(h)
    counted = dict(exact_counts)
    ex = hop_walls(kws, hops, 12)
    ex["exact_counts"] = {k: exact_counts[k] - counted.get(k, 0)
                          for k in ("hops", "windows", "window_samples", "new_samples")}
    ex["recompute_factor"] = ex["exact_counts"]["window_samples"] / ex["exact_counts"]["new_samples"]
    reset_launches()
    kws.step(hops["pcm16"][0])
    ex["launches_one_step"] = one = read_launches()
    ex["device_ms_window"] = cuda_ms(lambda: kws._evaluate(kws.buffer), reps=5)
    ex.update(engine_gates(kws, hops))
    rec["exact_dense"] = ex
    print(f"[serving entry] exact engine N={dense[0].n_neurons}, {N_SERVE} streams, int16 "
          f"wire, 100 ms hops: "
          f"median hop wall {ex['hop_wall_ms_median']:.3f} ms (min {ex['hop_wall_ms_min']:.3f}), "
          f"{ex['stream_chunks_per_s']:.1f} stream-chunks/s, real-time factor "
          f"{ex['real_time_factor']:.2f}; the window's device time {ex['device_ms_window']:.3f} "
          f"ms; one step launched {one}; exact_counts over the timed hops "
          f"{ex['exact_counts']}, each sample featurized {ex['recompute_factor']:.1f} times; "
          f"step_compact = argmax "
          f"{ex['compact_preds_equal_argmax']}, step_active = step with silence "
          f"{ex['step_active_bit_equal']}, stream = steps {ex['stream_bit_equal']}, "
          f"steps_fused = steps {ex['steps_fused_equal']} ({card})")
    if not (one["B1"] == 1 and one["B2"] == 1 and on_cluster_body(one)):
        fail(f"one exact step launched {one}, not B1 once and B2 once on the cluster body")
    if ex["exact_counts"]["hops"] != ex["hops_timed"]:
        fail(f"exact_counts counted {ex['exact_counts']['hops']} hops of {ex['hops_timed']}")
    del kws

    # ---- 2. continuous engine, dense, 1024 streams --------------------------
    def cont(modules, n):
        return ContinuousKWS(*modules, fcfg, fs, n_streams=n, chunk_len=CHUNK)

    kws = cont(dense, N_SERVE)
    reset_launches()
    for h in hops["pcm16"]:
        kws.step(h)
    co = {"launches_10_hops": read_launches()}
    co["saves"] = [continues_bit_exactly(lambda: cont(dense, N_SERVE), kws, hops,
                                         tmp / f"cont_{c}.npz", 10, c) for c in (True, False)]
    co["state_bytes"] = sum(v.nbytes for v in kws.snapshot().values())
    dst = cont(dense, N_SERVE)
    n_mig = min(64, N_SERVE // 4)             # 64 of 1024 streams, every 16th
    src_idx = np.arange(n_mig) * (N_SERVE // n_mig) + 3
    dst_idx = np.arange(n_mig)[::-1]
    co["migrate_s"], _ = timed(lambda: migrate_streams(kws, dst, src_idx, dst_idx))
    moved = True
    for i in range(3):
        h = hops["pcm16"][i]
        chunk = np.zeros_like(h)
        chunk[dst_idx] = h[src_idx]
        moved &= bool(np.array_equal(dst.step(chunk)[dst_idx], kws.step(h)[src_idx]))
    co["migrated"] = {"streams": n_mig, "bit_equal": moved}
    co.update(engine_gates(kws, hops))
    rec["continuous_dense"] = co
    s0, s1 = co["saves"]
    print(f"[serving entry] continuous engine N={dense[0].n_neurons}, {N_SERVE} streams: state "
          f"{co['state_bytes'] / 1e6:.1f} MB; save_serving_state compressed {s0['bytes'] / 1e6:.1f}"
          f" MB in {s0['save_s']:.2f} s (load {s0['load_s']:.2f} s), uncompressed "
          f"{s1['bytes'] / 1e6:.1f} MB in {s1['save_s']:.2f} s (load {s1['load_s']:.2f} s); the "
          f"next 10 hops bit-equal {s0['bit_equal']}, {s1['bit_equal']}; {n_mig} streams migrated in "
          f"{co['migrate_s'] * 1e3:.1f} ms, bit-equal {moved}; step_compact = argmax "
          f"{co['compact_preds_equal_argmax']}, step_active {co['step_active_bit_equal']}, stream "
          f"{co['stream_bit_equal']}, steps_fused {co['steps_fused_equal']}; "
          f"launches {co['launches_10_hops']} ({card})")
    if not (s0["bit_equal"] and s1["bit_equal"] and moved):
        fail(f"the continuous engine did not continue bit-exactly: {co}")
    if min(co["launches_10_hops"]["B3"], co["launches_10_hops"]["B4"]) <= 0:
        fail(f"a kernel of the continuous path was not launched: {co['launches_10_hops']}")
    del kws, dst

    # ---- 3. the 10240-neuron block-sparse reservoir --------------------------
    kws = cont(sparse, N_SERVE)
    for h in hops["pcm16"]:
        kws.step(h)
    reset_launches()
    sc = {"continuous_save": continues_bit_exactly(lambda: cont(sparse, N_SERVE), kws, hops,
                                                   tmp / "sparse_cont.npz", 5, False)}
    sc["continuous_launches"] = read_launches()
    del kws
    n_exact = min(256, N_SERVE)               # B5 costs ~18 ms a call at 256 rows
    kws = exact(sparse, n_exact)
    for h in hops["pcm16"]:
        kws.step(h[:n_exact])
    reset_launches()
    kws.step(hops["pcm16"][0][:n_exact])
    sc["exact_launches_one_step"] = one = read_launches()
    sub = {w: [h[:n_exact] for h in hs] for w, hs in hops.items()}
    sc["exact"] = hop_walls(kws, sub, 12)
    sc["exact"]["device_ms_window"] = cuda_ms(lambda: kws._evaluate(kws.buffer), reps=3)
    sc["exact_save"] = continues_bit_exactly(lambda: exact(sparse, n_exact), kws, sub,
                                             tmp / "sparse_exact.npz", 3, False)
    rec["sparse"] = sc
    c, e = sc["continuous_save"], sc["exact_save"]
    print(f"[serving entry] N={sparse[0].n_neurons}: continuous {N_SERVE} streams saved "
          f"{c['bytes'] / 1e6:.1f} MB in {c['save_s']:.2f} s, loaded in {c['load_s']:.2f} s, "
          f"5 hops bit-equal {c['bit_equal']} (launches {sc['continuous_launches']}); exact "
          f"{n_exact} streams: median hop wall {sc['exact']['hop_wall_ms_median']:.3f} ms, the "
          f"window's device time {sc['exact']['device_ms_window']:.3f} ms, one step launched "
          f"{one}, save/load bit-equal {e['bit_equal']} ({card})")
    if not (c["bit_equal"] and e["bit_equal"]):
        fail(f"the sparse engines did not continue bit-exactly: {sc}")
    if sc["continuous_launches"]["B6"] <= 0 or one["B5"] != 1 or one["B1"] != 1:
        fail(f"sparse serving launched {sc['continuous_launches']} (continuous) and {one} "
             "(one exact step), not B6 and B1 + B5 once")
    return rec


def _served(out: str) -> dict:
    """The numbers of cli.stream_kws's 'Served ...' and accuracy lines."""
    rec = {}
    for ln in out.splitlines():
        if ln.startswith("Served "):
            rec["served_line"] = ln
            rec["serve_wall_s"] = float(ln.split(" chunks in ")[1].split(" s ")[0])
            rec["per_s"] = float(ln.split("stream-chunks/s, ")[1].split(" ")[0])
        elif ln.startswith("Accuracy vs directory labels"):
            rec["accuracy_line"] = ln
    return rec


def serving_cli(dev, card, cont_modules, tmp: Path) -> dict:
    """Phase 12, item 4: `python -m lsm_tpu_torch.cli.stream_kws` as
    subprocesses on phase 11's 2400 WAVs (its corrupt file removed) and
    dense bundle: static exact serving, the pool over 1024 slots (its
    predictions equal to the static run's for every file), and a
    continuous bundle from phase 6's modules served with --save-state and
    again with --restore-state."""
    from lsm_tpu_torch.config import COMMANDS_12, PipelineConfig
    from lsm_tpu_torch.io.model import save_model

    cfg = PipelineConfig()
    corpus, model = tmp / "corpus", tmp / "m.npz"
    (corpus / COMMANDS_12[5] / "00007_corrupt.wav").unlink()
    n_files = len(list(corpus.rglob("*.wav")))
    rec = {"files": n_files}
    base = ["lsm_tpu_torch.cli.stream_kws", "--model", model, "--data-dir", corpus,
            "--wire", "pcm16", "--device", dev.type]
    rec["static_s"], out = run_cli(base + ["--compact", "--max-streams", n_files,
                                           "--output", tmp / "static.npz"], card)
    rec["static"] = _served(out)
    rec["pool_s"], out = run_cli(base + ["--pool", "--max-streams", N_SERVE,
                                         "--output", tmp / "pool.npz"], card)
    rec["pool"] = _served(out)
    st, po = np.load(tmp / "static.npz"), np.load(tmp / "pool.npz")
    by_file = dict(zip(st["files"], st["predictions"]))
    rec["pool_equals_static"] = bool(
        len(po["files"]) == len(st["files"]) == n_files
        and all(by_file[f] == p for f, p in zip(po["files"], po["predictions"])))
    cont = tmp / "cont.npz"
    save_model(cont, *cont_modules, cfg.frontend, cfg.feature_set, COMMANDS_12,
               feature_mode="continuous",
               continuous_params={"chunk_len": CHUNK, "norm_decay_db_per_bin": 0.1})
    cbase = ["lsm_tpu_torch.cli.stream_kws", "--model", cont, "--data-dir", corpus,
             "--wire", "pcm16", "--max-streams", N_SERVE, "--device", dev.type]
    rec["continuous_save_s"], out = run_cli(cbase + ["--save-state", tmp / "cli_state.npz",
                                                     "--output", tmp / "c1.npz"], card)
    rec["continuous_save"] = _served(out)
    rec["continuous_restore_s"], out = run_cli(cbase + ["--restore-state", tmp / "cli_state.npz",
                                                        "--output", tmp / "c2.npz"], card)
    rec["continuous_restore"] = _served(out)
    print(f"[serving entry] cli.stream_kws on {n_files} WAVs: static exact (compact) "
          f"{rec['static_s']:.1f} s ({rec['static'].get('served_line')}); pool over {N_SERVE} "
          f"slots {rec['pool_s']:.1f} s ({rec['pool'].get('served_line')}), predictions = "
          f"static for every file {rec['pool_equals_static']}; continuous --save-state "
          f"{rec['continuous_save_s']:.1f} s, --restore-state {rec['continuous_restore_s']:.1f} s "
          f"({rec['continuous_restore'].get('accuracy_line')}) ({card})")
    for k in ("static", "pool"):
        print(f"[serving entry]   {k}: {rec[k].get('accuracy_line')}")
    if not rec["pool_equals_static"]:
        fail("the pool's predictions differ from the static run's")
    return rec


# ---- 13. the mel frontend and the other gammatone methods -----------------

MEL64 = dict(filterbank="mel", n_filters=64)
CONFIGS0_WORDS = ("yes", "no", "up", "down")        # BASELINE.json configs[0]
CONT_MEL_MIN_ACC = 0.45                              # tests/test_continuous_band.py, mel


def spike_flips(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Share and count of differing spike entries."""
    n = int((a.cpu() != b.cpu()).sum())
    return {"differing": n, "entries": a.numel(), "share": n / a.numel()}


def frontends(dev, card, tmp: Path) -> dict:
    """Phase 13: BASELINE configs[0] (4 words, mel, 64 filters) on the card
    beside the port's CPU run; the mel hot path at 2400 utterances; mel and
    fft spikes against the CPU path; iir-xla on B1; the mel continuous
    engine (band, 1024-stream hops, save/load and migration) and the mel
    exact engine at 1024 streams."""
    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import FEATURE_SETS, FrontendConfig, PipelineConfig
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.io.serving_state import migrate_streams
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.models.calibration import calibrate_weight
    from lsm_tpu_torch.models.continuous import ContinuousKWS, fit_continuous_readout
    from lsm_tpu_torch.models.frontend import featurize_batch
    from lsm_tpu_torch.models.streaming import StreamingKWS
    from lsm_tpu_torch.readout import logistic, scaler

    cpu = torch.device("cpu")
    rec = {}

    # ---- configs[0]: card beside CPU ---------------------------------------
    cfg0 = PipelineConfig(frontend=FrontendConfig(**MEL64), commands=CONFIGS0_WORDS)
    audio0, labels0 = dataset.synthetic_audio_batch(CONFIGS0_PER_CLASS, len(CONFIGS0_WORDS),
                                                    seed=42)
    reset_launches()
    t_card, (r_card, e_card) = timed(lambda: pipeline.run_pipeline_arrays(
        cfg0, audio0, labels0, dev))
    launches0 = read_launches()
    t_cpu, (r_cpu, e_cpu) = timed(lambda: pipeline.run_pipeline_arrays(
        cfg0, audio0, labels0, cpu))
    c0 = rec["configs0"] = {
        "utterances": len(labels0), "card_s": t_card, "cpu_s": t_cpu,
        "accuracy_card": r_card.accuracy, "accuracy_cpu": r_cpu.accuracy,
        "regime_card": e_card.diagnostics.regime, "regime_cpu": e_cpu.diagnostics.regime,
        "participation_card": e_card.diagnostics.avg_participation,
        "participation_cpu": e_cpu.diagnostics.avg_participation,
        "mean_weight_card": e_card.mean_weight, "mean_weight_cpu": e_cpu.mean_weight,
        "launches": launches0}
    print(f"[frontends] configs[0] (4 words x {CONFIGS0_PER_CLASS}, mel, 64 filters, flagship "
          f"reservoir): card accuracy {r_card.accuracy:.4f} {e_card.diagnostics.regime} "
          f"({e_card.diagnostics.avg_participation:.1f} %) in {t_card:.1f} s; CPU "
          f"{r_cpu.accuracy:.4f} {e_cpu.diagnostics.regime} "
          f"({e_cpu.diagnostics.avg_participation:.1f} %) in {t_cpu:.1f} s; launches "
          f"{launches0} ({card})")
    if abs(r_card.accuracy - r_cpu.accuracy) > 0.05:
        fail(f"configs[0] on the card {r_card.accuracy:.4f} against the CPU {r_cpu.accuracy:.4f}")
    if launches0["B2"] <= 0 or launches0["B1"] != 0 or not on_cluster_body(launches0):
        fail(f"configs[0] launched {launches0}: B2 on the cluster body, no B1")
    del e_card, e_cpu

    # ---- the mel hot path at 2400 utterances --------------------------------
    pcfg = PipelineConfig(frontend=FrontendConfig(**MEL64))
    fcfg, keys = pcfg.frontend, tuple(FEATURE_SETS[pcfg.feature_set])
    audio_np, labels_np = dataset.synthetic_audio_batch(n_per_class=200, n_classes=12, seed=42)
    audio = torch.as_tensor(audio_np).to(dev)
    labels = torch.as_tensor(labels_np, dtype=torch.int64).to(dev)
    spikes = featurize_batch(audio, fcfg)
    _, mw = calibrate_weight(pcfg.reservoir, spikes, pcfg.multiplier)
    reservoir = res.init_reservoir(pcfg.reservoir, fcfg.n_filters, mean_weight=mw, device=dev)
    feats = res.extract_features(reservoir, spikes, keys)
    sc = scaler.fit_scaler(feats)
    ro, _ = logistic.fit_logistic(scaler.transform(sc, feats), labels, 12)

    def hot():
        f = res.extract_features(reservoir, featurize_batch(audio, fcfg), keys)
        return logistic.predict(ro, scaler.transform(sc, f))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = [timed(hot)[0] for _ in range(5)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    sp = featurize_batch(audio, fcfg)
    ev[1].record()
    logistic.predict(ro, scaler.transform(sc, res.extract_features(reservoir, sp, keys)))
    ev[2].record()
    torch.cuda.synchronize()
    fz, rest = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    hot_rec = rec["mel_hot"] = {
        "n": len(labels_np), "wall_s_min": min(walls), "wall_s_median": statistics.median(walls),
        "utt_per_s": len(labels_np) / min(walls),
        "utt_per_s_median": len(labels_np) / statistics.median(walls),
        "featurize_ms": fz, "extract_readout_ms": rest, "featurize_share": fz / (fz + rest),
        "peak_mem_gb": peak_gb,
        "fit_accuracy": float((hot() == labels).float().mean())}
    print(f"[frontends] mel hot path, {len(labels_np)} utt, 64 filters: min of 5 walls "
          f"{min(walls) * 1e3:.2f} ms ({hot_rec['utt_per_s']:.1f} utt/s), median "
          f"{hot_rec['wall_s_median'] * 1e3:.2f} ms; featurize {fz:.2f} ms of {fz + rest:.2f} "
          f"({100 * hot_rec['featurize_share']:.1f} %); peak memory {peak_gb:.2f} GB ({card})")
    del audio, labels, spikes, feats, sp

    # ---- spikes on the card against the CPU path; iir-xla on B1 ---------------
    a256 = audio_np[np.linspace(0, len(audio_np) - 1, 256).astype(np.int64)]
    flips = {}
    for name, kw in (("mel", MEL64), ("fft", dict(gammatone_method="fft"))):
        c = FrontendConfig(**kw)
        flips[name] = spike_flips(featurize_batch(torch.as_tensor(a256).to(dev), c),
                                  featurize_batch(torch.as_tensor(a256), c))
    reset_launches()
    s_xla = featurize_batch(torch.as_tensor(a256).to(dev),
                            FrontendConfig(gammatone_method="iir-xla"))
    l_xla = read_launches()
    s_iir = featurize_batch(torch.as_tensor(a256).to(dev), FrontendConfig())
    rec["spikes"] = {**flips, "iir_xla_equals_iir": bool(torch.equal(s_xla, s_iir)),
                     "iir_xla_launches": l_xla}
    print(f"[frontends] 256 utt, card against the CPU path: mel {flips['mel']['differing']} of "
          f"{flips['mel']['entries']} spike entries differ, fft {flips['fft']['differing']}; "
          f"iir-xla launched {l_xla}, spikes equal to iir's {rec['spikes']['iir_xla_equals_iir']}")
    for name, f in flips.items():
        if f["share"] > SPIKE_REL:
            fail(f"{name} spikes on the card part from the CPU path's on {f['share']:.2e} "
                 f"of entries (> {SPIKE_REL})")
    if l_xla["B1"] != 1 or not rec["spikes"]["iir_xla_equals_iir"]:
        fail(f"iir-xla launched {l_xla} (B1 once) and equal to iir "
             f"{rec['spikes']['iir_xla_equals_iir']}")

    # ---- the mel continuous engine: the band protocol ------------------------
    bcfg = PipelineConfig(batch_size=64, frontend=FrontendConfig(filterbank="mel"))
    ha, hl = dataset.synthetic_audio_batch_hard(20, 12, seed=42)
    reset_launches()
    result, ext = pipeline.run_pipeline_arrays(bcfg, ha, hl, dev)
    x_train, x_test, y_train, y_test = pipeline.stratified_split(
        ha, hl, bcfg.test_size, bcfg.split_seed)
    m_ro, m_sc = fit_continuous_readout(
        ext.reservoir, bcfg.frontend, x_train, y_train, num_classes=12,
        feature_set=bcfg.feature_set, chunk_len=CHUNK, norm_decay_db_per_bin=0.1,
        l2_c=bcfg.readout.l2_c, max_iter=bcfg.readout.max_iter, tol=bcfg.readout.tol)
    n = x_test.shape[0]
    nc = bcfg.frontend.num_samples // CHUNK
    kws = ContinuousKWS(ext.reservoir, m_ro, m_sc, bcfg.frontend, bcfg.feature_set,
                        n_streams=n, chunk_len=CHUNK)
    prev = x_test[np.random.default_rng(12345).permutation(n)]
    for c in range(nc):
        kws.step(prev[:, c * CHUNK:(c + 1) * CHUNK])
    for c in range(nc):
        logits = kws.step(x_test[:, c * CHUNK:(c + 1) * CHUNK])
    band_launches = read_launches()
    acc = float((np.argmax(logits, -1) == y_test).mean())
    band = rec["mel_band"] = {"exact_accuracy": result.accuracy, "matched_accuracy": acc,
                              "delta": result.accuracy - acc, "n_test": n,
                              "launches": band_launches}
    print(f"[frontends] mel continuous band (hard corpus 20 x 12, 128 filters): exact "
          f"{result.accuracy:.4f} matched {acc:.4f} (delta {band['delta']:+.4f}); launches "
          f"{band_launches} ({card})")
    if acc < CONT_MEL_MIN_ACC or band["delta"] > CONT_MAX_DELTA:
        fail(f"mel matched continuous accuracy {acc:.4f} outside the band (>= "
             f"{CONT_MEL_MIN_ACC}, within {CONT_MAX_DELTA} of exact {result.accuracy:.4f})")
    if band_launches["B4"] <= 0 or band_launches["B3"] != 0 or not on_cluster_body(band_launches):
        fail(f"the mel continuous path launched {band_launches}: B4 on the cluster body, no B3")
    modules = (ext.reservoir, m_ro, m_sc)
    del kws, ext

    # ---- the mel continuous engine at 1024 streams ----------------------------
    hops = serving_hops(N_SERVE)
    mfcfg, fs = bcfg.frontend, bcfg.feature_set

    def cont(n_streams):
        return ContinuousKWS(*modules, mfcfg, fs, n_streams=n_streams, chunk_len=CHUNK)

    kws = cont(N_SERVE)
    for h in hops["pcm16"]:                                   # warm-up: one window
        kws.step(h)
    reset_launches()
    co = hop_walls(kws, hops, 30)
    co["launches_30_hops"] = launches_c = read_launches()
    # The hop is host-bound (~460 launches), so CUDA events around it would
    # time the host; the device time is the profiler's busy union.
    next_hop = iter(hops["pcm16"])
    prof = device_profile(lambda: kws.step(next(next_hop)), calls=10)
    co["device_ms"] = prof["device_busy_us"] / 1e3 / prof["calls"]
    co["device_busy_share"] = prof["busy_share_of_wall"]
    co["device_events_per_hop"] = prof["n_device_events"] / prof["calls"]
    co["top_device"] = prof["top_device"][:8]
    co["saves"] = [continues_bit_exactly(lambda: cont(N_SERVE), kws, hops,
                                         tmp / "mel_cont.npz", 10, False)]
    dst = cont(N_SERVE)
    n_mig = min(64, N_SERVE // 4)             # 64 of 1024 streams, every 16th
    src_idx = np.arange(n_mig) * (N_SERVE // n_mig) + 3
    dst_idx = np.arange(n_mig)[::-1]
    migrate_streams(kws, dst, src_idx, dst_idx)
    moved = True
    for i in range(3):
        h = hops["pcm16"][i]
        chunk = np.zeros_like(h)
        chunk[dst_idx] = h[src_idx]
        moved &= bool(np.array_equal(dst.step(chunk)[dst_idx], kws.step(h)[src_idx]))
    co["migrated"] = {"streams": n_mig, "bit_equal": moved}
    co["state_bytes"] = sum(v.nbytes for v in kws.snapshot().values())
    rec["mel_continuous"] = co
    print(f"[frontends] mel continuous engine, {N_SERVE} streams, int16 wire, 100 ms hops: "
          f"median hop wall {co['hop_wall_ms_median']:.3f} ms (min {co['hop_wall_ms_min']:.3f}), "
          f"device busy {co['device_ms']:.3f} ms a hop ({100 * co['device_busy_share']:.1f} % of "
          f"the profiled wall, {co['device_events_per_hop']:.0f} device events a hop), "
          f"real-time factor "
          f"{co['real_time_factor']:.2f}; state {co['state_bytes'] / 1e6:.1f} MB; save/load "
          f"bit-equal {[s['bit_equal'] for s in co['saves']]}, {n_mig} streams migrated bit-equal "
          f"{moved}; launches {launches_c} ({card})")
    for t in co["top_device"]:
        print(f"[frontends]   {t['us'] / 1e3 / prof['calls']:8.3f} ms/hop x{t['count'] // prof['calls']:4d}"
              f"  {t['name']}")
    if not (all(s["bit_equal"] for s in co["saves"]) and moved):
        fail(f"the mel continuous engine did not continue bit-exactly: {co}")
    if launches_c["B4"] != 30 or launches_c["B3"] != 0 or not on_cluster_body(launches_c):
        fail(f"30 mel continuous hops launched {launches_c}: B4 30 times on the cluster body")
    del kws, dst

    # ---- the mel exact engine at 1024 streams ---------------------------------
    kws = StreamingKWS(*modules, mfcfg, fs, n_streams=N_SERVE)
    for h in hops["pcm16"]:
        kws.step(h)
    ex = hop_walls(kws, hops, 12)
    reset_launches()
    kws.step(hops["pcm16"][0])
    ex["launches_one_step"] = one = read_launches()
    ex["device_ms_window"] = cuda_ms(lambda: kws._evaluate(kws.buffer), reps=5)
    rec["mel_exact"] = ex
    print(f"[frontends] mel exact engine, {N_SERVE} streams: median hop wall "
          f"{ex['hop_wall_ms_median']:.3f} ms (min {ex['hop_wall_ms_min']:.3f}), the window's "
          f"device time {ex['device_ms_window']:.3f} ms; one step launched {one} ({card})")
    if not (one["B2"] == 1 and one["B1"] == 0 and on_cluster_body(one)):
        fail(f"one mel exact step launched {one}, not B2 once (cluster body) and no B1")
    return rec


# ---- 14. corpus-scale training ------------------------------------------------

def corpus_training(dev, card, tmp: Path) -> dict:
    """Phase 14: TRAIN_ROWS rows of synthetic_audio_batch written as
    compressed shards (set-up, timed apart), then
    extract_and_train_streaming with ridge and with logistic (rows/s, the
    fit pass's split, device-busy share and peak RSS per pass), held against
    the in-memory path on the same rows; the configs[3] reservoir over
    TRAIN_ROWS_10K of them; the --streaming-fit --save-model entry point as
    a subprocess, whose bundle classifies phase 11's WAVs."""
    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import FEATURE_SETS, PipelineConfig, ReservoirConfig
    from lsm_tpu_torch.io.model import load_model
    from lsm_tpu_torch.io.sharded import ShardedSpikeDataset, ShardedSpikeDatasetWriter
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.readout import logistic, scaler
    from lsm_tpu_torch.tools import bench_stream_train as bench

    cfg = PipelineConfig()
    keys = tuple(FEATURE_SETS[cfg.feature_set])
    root = tmp / "train_shards"
    sampler = bench.RssSampler()
    try:
        rec = {"write": bench.write_corpus(root, TRAIN_ROWS, cfg, dev)}
        source = ShardedSpikeDataset(root)
        runs = {}
        for readout in ("ridge", "logistic"):
            reset_launches()
            result, rep = bench.train(source, cfg, dev, readout, sampler)
            rep["launches"] = read_launches()
            runs[readout] = result
            rec[readout] = rep
    finally:
        sampler.stop()
    w = rec["write"]
    print(f"[training] corpus: {w['rows']} rows in {w['seconds']:.1f} s (waiting on "
          f"{w['generate_workers']} generator processes {w['generate_wait_s']:.1f} s, "
          f"featurize {w['featurize_s']:.1f} s), "
          f"{w['bytes_on_disk'] / 1e6:.1f} MB on disk ({w['bytes_raw'] / 1e6:.1f} MB raw) ({card})")
    for readout in ("ridge", "logistic"):
        r = rec[readout]
        fp, ep = r["passes"]["fit_pass"], r["passes"]["eval_pass"]
        solve = r["passes"].get("solve", {}).get("seconds")
        print(f"[training] {readout}: accuracy {r['accuracy']:.4f} ({r['n_train']} train, "
              f"{r['n_test']} test); fit pass {fp['utt_per_s']:.1f} rows/s (split "
              + " ".join(f"{k} {v:.2f} s" for k, v in r["fit_split_s"].items())
              + f"), device busy {100 * fp.get('device_busy_share', 0):.1f} %, RSS "
              f"{fp['start_rss_bytes'] / 1e6:.0f} MB at its start, peak "
              f"{fp['peak_rss_bytes'] / 1e6:.0f} MB; eval pass {ep['utt_per_s']:.1f} rows/s, "
              f"busy {100 * ep.get('device_busy_share', 0):.1f} %, peak RSS "
              f"{ep['peak_rss_bytes'] / 1e6:.0f} MB"
              + (f"; L-BFGS {solve:.2f} s" if solve is not None else "")
              + f"; launches {r['launches']} ({card})")
        if r["launches"]["B2"] <= 0 or not on_cluster_body(r["launches"]):
            fail(f"the {readout} trainer launched {r['launches']}: B2 on the cluster body")

    # ---- the in-memory oracle on the same rows ------------------------------
    ds = source.load_all()
    ext = pipeline.extract_lsm_features(cfg, ds, dev, run_diagnostics=False)
    x_tr = torch.as_tensor(ext.artifact.x_train).to(dev)
    y_tr = torch.as_tensor(ext.artifact.y_train, dtype=torch.int64).to(dev)
    x_te = torch.as_tensor(ext.artifact.x_test).to(dev)
    y_te = ext.artifact.y_test
    ridge = logistic.fit_ridge(x_tr, y_tr, 12)
    p_ridge = logistic.predict(ridge, x_te).cpu().numpy()
    lbfgs, _ = logistic.fit_logistic(x_tr, y_tr, 12)
    p_log = logistic.predict(lbfgs, x_te).cpu().numpy()
    _, spikes_te, _, _ = pipeline.stratified_split(ds.x_spikes, ds.y_labels, cfg.test_size,
                                                   cfg.split_seed)
    mine = []
    for s in range(0, spikes_te.shape[0], cfg.batch_size):
        f = res.extract_features(runs["logistic"].reservoir,
                                 torch.as_tensor(spikes_te[s:s + cfg.batch_size]).to(dev), keys)
        mine.append(logistic.predict(runs["logistic"].readout,
                                     scaler.transform(runs["logistic"].scaler, f)).cpu())
    mine = torch.cat(mine).numpy()
    oracle = rec["oracle"] = {
        "ridge_accuracy": float((p_ridge == y_te).mean()),
        "logistic_accuracy": float((p_log == y_te).mean()),
        "logistic_agreement": float((mine == p_log).mean()),
        "corpus_bytes_in_memory": int(ds.x_spikes.nbytes)}
    del ds, x_tr, x_te, spikes_te, ext
    print(f"[training] in-memory oracle: ridge {oracle['ridge_accuracy']:.4f} (streamed "
          f"{rec['ridge']['accuracy']:.4f}), logistic {oracle['logistic_accuracy']:.4f} "
          f"(streamed {rec['logistic']['accuracy']:.4f}, test predictions equal on "
          f"{oracle['logistic_agreement']:.4f}); the spikes alone are "
          f"{oracle['corpus_bytes_in_memory'] / 1e6:.0f} MB in memory ({card})")
    if abs(rec["ridge"]["accuracy"] - oracle["ridge_accuracy"]) > 1e-6:
        fail(f"streamed ridge {rec['ridge']['accuracy']} against in-memory "
             f"{oracle['ridge_accuracy']}")
    if abs(rec["logistic"]["accuracy"] - oracle["logistic_accuracy"]) > 0.02 or \
            oracle["logistic_agreement"] < 0.95:
        fail(f"streamed logistic against in-memory: {oracle}")

    # ---- configs[3]: 10240 neurons at multiplier 1.6, ridge -----------------
    root10k = tmp / "train_shards_10k"
    idx = np.arange(TRAIN_ROWS_10K)
    writer = ShardedSpikeDatasetWriter(root10k, 1200, resume=False, compress=False)
    writer.append(source.gather_rows(idx), source.labels()[idx], idx)
    writer.close()
    cfg10k = PipelineConfig(reservoir=ReservoirConfig(num_neurons=N_10K, small_world_k=K_10K),
                            multiplier=MULT_10K)
    reset_launches()
    t10k, r10k = timed(lambda: pipeline.extract_and_train_streaming(
        cfg10k, ShardedSpikeDataset(root10k), dev))
    l10k = read_launches()
    rec["configs3"] = {"rows": TRAIN_ROWS_10K, "seconds": t10k, "accuracy": r10k.accuracy,
                       "regime": r10k.diagnostics.regime,
                       "participation": r10k.diagnostics.avg_participation,
                       "n_train": r10k.n_train, "n_test": r10k.n_test, "launches": l10k}
    print(f"[training] configs[3] ({N_10K} neurons, multiplier {MULT_10K}) over "
          f"{TRAIN_ROWS_10K} rows, ridge: accuracy {r10k.accuracy:.4f}, "
          f"{r10k.diagnostics.regime} ({r10k.diagnostics.avg_participation:.1f} %), "
          f"{t10k:.1f} s; launches {l10k} ({card})")
    if l10k["B5"] <= 0 or not np.isfinite(r10k.accuracy):
        fail(f"the configs[3] trainer launched {l10k}: B5 not launched")
    del r10k

    # ---- the entry point: --streaming-fit --save-model, then classify -------
    model = tmp / "streamed.npz"
    fit_s, out = run_cli(["lsm_tpu_torch.cli.extract_lsm_features", "--input", root,
                          "--streaming-fit", "--save-model", model, "--device", dev.type], card)
    bundle = load_model(model, dev)
    cls_s, _ = run_cli(["lsm_tpu_torch.cli.classify", "--model", model, "--data-dir",
                        tmp / "corpus", "--output", tmp / "streamed_preds.npz",
                        "--device", dev.type], card)
    got = np.load(tmp / "streamed_preds.npz")
    acc_line = [ln for ln in out.splitlines() if ln.startswith("Test Accuracy:")]
    rec["cli"] = {"streaming_fit_s": fit_s, "classify_s": cls_s,
                  "test_accuracy_line": acc_line[-1] if acc_line else None,
                  "classified": int(len(got["predictions"])),
                  "classify_accuracy": float((got["predictions"] == got["labels"]).mean()),
                  "bundle_class_names": list(bundle.class_names)}
    print(f"[training] cli.extract_lsm_features --streaming-fit --save-model {fit_s:.1f} s "
          f"({rec['cli']['test_accuracy_line']}); cli.classify of phase 11's WAVs with that "
          f"bundle {cls_s:.1f} s: {rec['cli']['classified']} files, accuracy "
          f"{rec['cli']['classify_accuracy']:.4f} ({card})")
    if rec["cli"]["classified"] == 0 or not acc_line:
        fail(f"the streaming-fit entry point: {rec['cli']}")
    return rec


# Phase 15: BASELINE.json configs[2], the 35-class vocabulary at 256
# gammatone filters with the flagship reservoir, on 30 synthetic
# utterances a class (seed 77, tests/test_config35.py's corpus, 1050 in
# all); the accuracy floor is tests/test_config35.py's.
CONFIGS2_PER_CLASS, CONFIGS2_MIN_ACC = 30, 0.25
# The metric names lsm_tpu's main.py emits with --metrics-out (main.py:81-111),
# in order; tests/test_torch_cli_metrics.py holds the port's run to them
# and to lsm_tpu's.
MAIN_PY_METRICS = ("stage1_wall_s", "avg_spikes_per_sample", "stage2_wall_s", "w_critico",
                   "mean_weight", "regime", "stage3_wall_s", "test_accuracy")


def report_rows(report, names) -> list:
    """The class names that head a row of the rendered report."""
    heads = {line.split()[0] for line in report.render().splitlines() if line.split()}
    return [n for n in names if n in heads]


def configs2(dev, card, tmp: Path) -> dict:
    """Phase 15: configs[2] at full width. B1 at C = 256 against its twin
    (rtol 5e-3) on the corpus, and against float64 by phase 2's rule on
    phase 2's audio (every channel <= 1e-3 and no worse than the twin); on
    the corpus itself the float64 figure is recorded and held no worse than
    the twin's (its quiet sub-blocks read ~1.07e-3: ROADMAP C5). B2 with 256
    input channels bit-equal to its twin on the dyadic copy, timed with its
    plan and bound; run_pipeline_arrays on the corpus (B1 and B2 launched,
    accuracy > 0.25, 35 report rows, 2000 features); `python -m
    lsm_tpu_torch --synthetic --vocab v35 --n-filters 256 --check
    --metrics-out --single-device` as a subprocess on the same corpus size,
    whose metric file holds main.py's names."""
    import dataclasses

    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import COMMANDS_35, FrontendConfig, PipelineConfig
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.models.calibration import calibrate_weight
    from lsm_tpu_torch.models.frontend import featurize_batch
    from lsm_tpu_torch.ops import gammatone as gt
    from lsm_tpu_torch.ops.kernels import gtgram as kgt
    from lsm_tpu_torch.ops.kernels import lif as klif

    cfg = PipelineConfig(frontend=FrontendConfig(n_filters=256), commands=COMMANDS_35)
    fcfg, rcfg = cfg.frontend, cfg.reservoir
    audio_np, labels = dataset.synthetic_audio_batch(CONFIGS2_PER_CLASS, 35, seed=77)
    audio = torch.as_tensor(audio_np[:256]).to(dev)

    # B1 at 256 channels.
    hop_time = fcfg.num_samples / (fcfg.sample_rate * fcfg.time_bins)
    nwin, hop, _ = gt.gtgram_strides(fcfg.sample_rate, fcfg.gt_window_time, hop_time,
                                     fcfg.num_samples)
    g = int(np.gcd(nwin, hop))
    fb = gt.filterbank(fcfg.sample_rate, 256, fcfg.gt_f_min, g, dev)
    fb64 = gt.filterbank(fcfg.sample_rate, 256, fcfg.gt_f_min, g, dev, torch.float64)
    e_k = kgt.sub_energy(audio, fb)
    e_p = kgt.sub_energy_plain(audio, fb)
    e_64 = kgt.sub_energy_plain(audio.double(), fb64)
    torch.cuda.synchronize()
    if not torch.isfinite(e_k).all():
        fail("B1 at C = 256 produced non-finite energies")
    b1 = {"max_abs_err": float((e_k - e_p).abs().max()),
          "allclose": bool(torch.allclose(e_k, e_p, rtol=5e-3, atol=1e-6)),
          "ms": cuda_ms(lambda: kgt.sub_energy(audio, fb), reps=10),
          "plain_ms": cuda_ms(lambda: kgt.sub_energy_plain(audio, fb), reps=3),
          **gtgram_bound(audio, fb, e_k)}
    if not b1["allclose"]:
        fail("B1 at C = 256 disagrees with its plain twin beyond rtol 5e-3 / atol 1e-6")
    b1["float64_corpus"] = f64 = float64_errors(e_k, e_64, twin=e_p)
    del e_64
    hard_np, _ = dataset.synthetic_audio_batch_hard(22, 12, seed=7)      # phase 2's audio
    hard = torch.as_tensor(hard_np[:256]).to(dev)
    b1["float64"] = f64h = float64_errors(kgt.sub_energy(hard, fb),
                                          kgt.sub_energy_plain(hard.double(), fb64),
                                          twin=kgt.sub_energy_plain(hard, fb))
    print(f"[configs2 B1] B=256 C=256: max_abs_err {b1['max_abs_err']:.3e}; against float64 "
          f"(channel worst at >= 1e-4 of peak) on phase 2's audio {f64h['kernel_worst']:.3e} "
          f"(channel {f64h['kernel_worst_channel']}; twin {f64h['twin_worst']:.3e}), on the "
          f"configs[2] corpus {f64['kernel_worst']:.3e} (channel {f64['kernel_worst_channel']}; "
          f"twin {f64['twin_worst']:.3e}); kernel {b1['ms']:.3f} ms plain {b1['plain_ms']:.3f} "
          f"ms bound {b1['bound_ms']:.3f} ms ({b1['bound_by']}) ({card})")

    # B2 with 256 input channels at the flagship reservoir.
    spikes = featurize_batch(audio, fcfg)                          # (256, 256, 400)
    _, mw = calibrate_weight(rcfg, spikes, cfg.multiplier)
    r = res.init_reservoir(rcfg, 256, mean_weight=mw, device=dev)
    ops, kw = r.dyadic().kernel_operands()
    s_k, a_k = klif.lif_stats(spikes, *ops, **kw)
    s_p, a_p = klif.lif_stats_plain(spikes, *ops, **kw)
    torch.cuda.synchronize()
    equal = torch.equal(s_k, s_p) and torch.equal(a_k, a_p)
    ops_r, kw_r = r.kernel_operands()
    s_r, a_r = klif.lif_stats(spikes, *ops_r, **kw_r)
    plan = klif.card_plan(spikes, ops_r[0].shape[0], kw_r["refractory"], chunk=False)
    b2 = {"bit_equal_dyadic": bool(equal),
          "max_abs_err": max(finite_err(s_k, s_p), float((a_k - a_p).abs().max())),
          "dyadic_spikes": float(a_p.sum()),
          "ms": cuda_ms(lambda: klif.lif_stats(spikes, *ops_r, **kw_r), reps=5),
          "plain_ms": cuda_ms(lambda: klif.lif_stats_plain(spikes, *ops_r, **kw_r), reps=2),
          "spikes_per_step": float(a_r.sum() / (256 * spikes.shape[-1])),
          **bound(lif_flops(float(a_r.sum() + spikes.sum()), 256, spikes.shape[-1],
                            r.n_neurons), nbytes(spikes, *ops_r, s_r, a_r))}
    b2.update(dense_timing(plan, b2["ms"], 256, spikes.shape[-1]))
    print(f"[configs2 B2] B=256 C=256 N=1000 T=400: dyadic bit_equal {equal} "
          f"({b2['dyadic_spikes']:.0f} spikes); calibrated kernel {b2['ms']:.3f} ms plain "
          f"{b2['plain_ms']:.3f} ms bound {b2['bound_ms']:.4f} ms ({b2['bound_by']}); plan "
          f"{plan_text(b2)} ({card})")
    if not equal or b2["dyadic_spikes"] <= 0:
        fail("B2 at C = 256 is not bit-equal to its plain twin on dyadic weights (or silent)")

    # The pipeline on the whole corpus.
    reset_launches()
    t0 = time.perf_counter()
    result, ext = pipeline.run_pipeline_arrays(cfg, audio_np, labels, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    art = ext.artifact
    rows = report_rows(result.report, COMMANDS_35)
    rec = {"B1": b1, "B2": b2, "utterances": len(labels), "seconds": wall,
           "accuracy": result.accuracy, "regime": ext.diagnostics.regime,
           "avg_participation": ext.diagnostics.avg_participation,
           "mean_weight": ext.mean_weight, "lbfgs_iters": result.n_iters,
           "report_rows": len(rows), "feature_width": int(art.x_train.shape[1]),
           "launches": launches}
    print(ext.diagnostics.render())
    print(f"[configs2] 35 classes x {CONFIGS2_PER_CLASS}, 256 filters: accuracy "
          f"{result.accuracy:.4f} regime {rec['regime']} participation "
          f"{rec['avg_participation']:.1f} %, {len(rows)} report rows, feature width "
          f"{rec['feature_width']}, launches {launches}, wall {wall:.2f} s ({card})")
    if min(launches["B1"], launches["B2"]) <= 0:
        fail(f"a kernel of the configs[2] path was not launched: {launches}")
    if result.accuracy <= CONFIGS2_MIN_ACC:
        fail(f"configs[2] accuracy {result.accuracy:.4f} <= {CONFIGS2_MIN_ACC}")
    if len(rows) != 35 or len(result.report.class_names) != 35:
        fail(f"configs[2] report has {len(rows)} rows, not 35")
    if rec["feature_width"] != 2000 or not (np.isfinite(art.x_train).all()
                                            and np.isfinite(art.x_test).all()):
        fail(f"configs[2] features {art.x_train.shape} or non-finite")

    # The entry point with the flags lsm_tpu's main.py takes.
    metrics = tmp / "configs2_metrics.jsonl"
    secs, out = run_cli(["lsm_tpu_torch", "--synthetic", "--vocab", "v35", "--n-filters", "256",
                         "--check", "--metrics-out", metrics, "--single-device",
                         "--samples-per-class", CONFIGS2_PER_CLASS, "--skip-artifacts"], card)
    names = tuple(json.loads(line)["metric"] for line in metrics.read_text().splitlines())
    rec["cli"] = {"seconds": secs, "metrics": names,
                  "accuracy_line": next((ln for ln in out.splitlines()
                                         if ln.startswith("Test Accuracy:")), None)}
    print(f"[configs2 cli] python -m lsm_tpu_torch --synthetic --vocab v35 --n-filters 256 "
          f"--check --metrics-out --single-device: {secs:.1f} s, {rec['cli']['accuracy_line']}, "
          f"metrics {list(names)}")
    if names != MAIN_PY_METRICS:
        fail(f"the configs[2] entry point wrote metrics {names}, not main.py's {MAIN_PY_METRICS}")
    return rec


# Phase 16: dense reservoirs past 4096 neurons on the block body. The
# sparse-parity protocol of lsm_tpu_torch.tools.sparse_parity at N = 4096
# (hard corpus 30 x 12, multiplier 0.6) beside lsm_tpu's figures in
# docs/SENSITIVITY.md, then dense reservoirs at configs[3] width (10240
# neurons, k = 2048, multiplier 1.6) and at 5000 neurons (N_pad 5120).
PARITY_N, PARITY_MULT = 4096, 0.6
SENSITIVITY_4096 = {"dense": 0.7500, "sparse": 0.8056}
N_DENSE_ODD = 5000
# A dense row keeps k/2 edges but for rewired targets that land on another
# of its edges (tests/test_torch_dense_large.py's bound).
OUTDEG_SLACK = 30


def fired_rows(x, ops, kw) -> tuple:
    """The rows of W_rec a dense run over x needs, counted on B2's plain
    twin (not launched as the kernel): (the distinct source neurons that
    fired at some step of some stream but the last, the sum over the steps
    of those that some stream fired the step before)."""
    from lsm_tpu_torch.ops.kernels import lif as klif

    w_rec, w_in, leak_keep = ops
    wr = w_rec.to(torch.float32)
    seen = torch.zeros(wr.shape[0], dtype=torch.bool, device=wr.device)
    per_step = []

    def recurrent(s):
        fired = s.amax(dim=0) > 0
        seen.logical_or_(fired)
        per_step.append(fired.sum())
        return s @ wr

    klif.stats_scan(x, recurrent, w_in, leak_keep, **kw)
    return int(seen.sum()), int(torch.stack(per_step).sum())


def dense_structure(r, half: int, fanout: int, weight: float) -> dict:
    """The device draw's structure, counted on the card: out-degree of every
    real row within [k/2 - OUTDEG_SLACK, k/2], no self-loops, zero padding,
    and exactly `fanout` input targets of `weight` a channel."""
    n, c = r.n_neurons, r.n_channels
    nz = r.w_rec[:n, :n] != 0
    outdeg = nz.sum(dim=1)
    w_in = r.w_in[:c]
    rec = {"outdeg_min": int(outdeg.min()), "outdeg_max": int(outdeg.max()),
           "outdeg_mean": float(outdeg.double().mean()),
           "self_loops": int(torch.diagonal(nz).sum()),
           "padding_nonzero": int((r.w_rec[n:] != 0).sum() + (r.w_rec[:, n:] != 0).sum()
                                  + (r.w_in[:, n:] != 0).sum()),
           "fanout_min": int((w_in != 0).sum(dim=1).min()),
           "fanout_max": int((w_in != 0).sum(dim=1).max()),
           "input_weights": sorted({float(v) for v in w_in[w_in != 0].unique().tolist()})}
    rec["held"] = (half - OUTDEG_SLACK <= rec["outdeg_min"] <= rec["outdeg_max"] <= half
                   and rec["self_loops"] == 0 and rec["padding_nonzero"] == 0
                   and rec["fanout_min"] == rec["fanout_max"] == fanout
                   and rec["input_weights"] == [weight])
    return rec


def dense_large(dev, card, spikes) -> dict:
    """Phase 16 (spikes: phase 2's (256, 128, 400) hard-corpus spikes)."""
    from lsm_tpu_torch.config import ReservoirConfig
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.models.calibration import calibrate_weight
    from lsm_tpu_torch.ops.kernels import lif as klif
    from lsm_tpu_torch.tools.sparse_parity import run_one

    # The sparse-parity protocol at 4096 neurons, dense then sparse.
    base = ReservoirConfig(num_neurons=PARITY_N, num_output_neurons=400,
                           small_world_k=int(0.10 * PARITY_N * 2))
    audio, labels = dataset.synthetic_audio_batch_hard(30, 12, seed=42)
    parity = {}
    for kind in ("dense", "sparse"):
        reset_launches()
        t0 = time.perf_counter()
        result, ext = run_one(base, kind == "sparse", audio, labels, PARITY_MULT, dev)
        torch.cuda.synchronize()
        parity[kind] = {"accuracy": result.accuracy, "regime": ext.diagnostics.regime,
                        "avg_participation": ext.diagnostics.avg_participation,
                        "mean_weight": ext.mean_weight, "seconds": time.perf_counter() - t0,
                        "launches": read_launches(),
                        "lsm_tpu_accuracy": SENSITIVITY_4096[kind]}
        if kind == "dense":
            parity["dense"]["structure"] = dense_structure(
                ext.reservoir, base.small_world_k // 2, base.input_fanout, base.input_weight)
    dn, sp = parity["dense"], parity["sparse"]
    parity["delta"] = sp["accuracy"] - dn["accuracy"]
    print(f"[dense large] sparse parity N={PARITY_N} multiplier {PARITY_MULT}: dense "
          f"{dn['accuracy']:.4f} {dn['regime']} ({dn['avg_participation']:.1f} %), sparse "
          f"{sp['accuracy']:.4f} {sp['regime']} ({sp['avg_participation']:.1f} %), delta "
          f"{parity['delta']:+.4f} (lsm_tpu, docs/SENSITIVITY.md: dense 0.7500, sparse 0.8056); "
          f"dense launches {dn['launches']}, sparse B5 {sp['launches']['B5']}; dense draw "
          f"{dn['structure']} ({card})")
    dl = dn["launches"]
    if dl["B2"] <= 0 or dl["dense_bodies"]["block"] != dl["B2"] + dl["B4"]:
        fail(f"the dense {PARITY_N}-neuron run did not run B2 on the block body: {dl}")
    if sp["launches"]["B5"] <= 0:
        fail(f"the sparse {PARITY_N}-neuron run did not launch B5: {sp['launches']}")
    if not dn["structure"]["held"]:
        fail(f"the dense device draw at {PARITY_N} neurons breaks its structure: "
             f"{dn['structure']}")

    # configs[3] width, dense.
    rcfg = ReservoirConfig(num_neurons=N_10K, small_world_k=K_10K, sparse=False)
    _, mw = calibrate_weight(rcfg, spikes, MULT_10K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r10 = res.init_reservoir(rcfg, spikes.shape[1], mean_weight=mw, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    struct10 = dense_structure(r10, K_10K // 2, rcfg.input_fanout, rcfg.input_weight)
    chunks = [spikes[:64, :, c * 40:(c + 1) * 40].contiguous() for c in range(10)]
    pair10 = dense_pair_equal(spikes[:16].contiguous(), chunks, *r10.dyadic().kernel_operands())
    ops, kw = r10.kernel_operands()
    x = spikes.contiguous()                                        # B = 256
    n_pad = ops[0].shape[0]
    plan = klif.card_plan(x, n_pad, kw["refractory"], chunk=False)
    s_k, a_k = klif.lif_stats(x, *ops, **kw)
    ms = cuda_ms(lambda: klif.lif_stats(x, *ops, **kw), reps=3)
    plain_ms = cuda_ms(lambda: klif.lif_stats_plain(x, *ops, **kw), reps=1, warmup=0)
    steps = x.shape[-1]
    # The bound: the function's adds and updates, and the bytes it must
    # move, each input read once: the spikes, the input weights, leak and
    # outputs, and the rows of W_rec (N_pad bf16 each) that some stream
    # fired, counted on the twin's run. Beside it two reads of W_rec a
    # step: the rows some stream fired the step before (a design that keeps
    # no row on chip between steps), and every weight block (the block
    # body's own traffic).
    distinct, per_step = fired_rows(x, ops, kw)
    fixed = nbytes(x, *ops[1:], s_k, a_k)
    step_rows = fixed + per_step * n_pad * 2
    traffic = fixed + steps * n_pad * n_pad * 2
    b10 = {"plan": plan.body, "ms": ms, "plain_ms": plain_ms,
           "spikes_per_step": float(a_k.sum() / (x.shape[0] * steps)),
           "fired_rows": distinct, "fired_rows_per_step": per_step / steps,
           "step_rows_bytes": step_rows, "step_rows_ms": step_rows / HBM_BYTES_S * 1e3,
           "traffic_bytes": traffic, "traffic_ms": traffic / HBM_BYTES_S * 1e3,
           **bound(lif_flops(float(a_k.sum() + x.sum()), x.shape[0], steps, r10.n_neurons),
                   fixed + distinct * n_pad * 2)}
    peak = torch.cuda.max_memory_allocated()
    print(f"[dense large] N={N_10K} k={K_10K} dense (device draw {draw_s:.2f} s, structure "
          f"{struct10}): B2 B=16 and B4 ten chained 40-step chunks of 64 streams, dyadic: "
          f"{pair10}; B2 B={x.shape[0]} T={steps} calibrated on the {plan.body} body: "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b10['bound_ms']:.3f} ms "
          f"({b10['bound_by']}: {b10['flops'] / 1e9:.2f} GFLOP, {b10['bytes'] / 1e9:.3f} GB "
          f"with the {distinct} source rows that fired; {b10['spikes_per_step']:.2f} spikes "
          f"a stream-step); W_rec's fired rows re-read each step "
          f"({b10['fired_rows_per_step']:.1f} a step) {step_rows / 1e9:.2f} GB "
          f"({b10['step_rows_ms']:.3f} ms), the block body's traffic {traffic / 1e9:.1f} GB "
          f"({b10['traffic_ms']:.3f} ms); peak memory "
          f"{peak / 1e9:.2f} GB ({card})")
    if not struct10["held"]:
        fail(f"the dense device draw at {N_10K} neurons breaks its structure: {struct10}")
    if plan.body != "block":
        fail(f"dense B2 at N_pad {n_pad} planned the {plan.body} body, not the block body")
    if not dense_held(pair10):
        fail(f"dense B2/B4 at N = {N_10K} are not bit-equal to their twins: {pair10}")
    del r10, ops, s_k, a_k

    # 5000 neurons: N % 128 != 0, so dense; N_pad 5120.
    rcfg5 = ReservoirConfig(num_neurons=N_DENSE_ODD, small_world_k=int(0.2 * N_DENSE_ODD))
    _, mw5 = calibrate_weight(rcfg5, spikes, PARITY_MULT)
    r5 = res.init_reservoir(rcfg5, spikes.shape[1], mean_weight=mw5, device=dev)
    struct5 = dense_structure(r5, rcfg5.small_world_k // 2, rcfg5.input_fanout,
                              rcfg5.input_weight)
    ops5, kw5 = r5.dyadic().kernel_operands()
    x16 = spikes[:16].contiguous()
    s5k, a5k = klif.lif_stats(x16, *ops5, **kw5)
    s5p, a5p = klif.lif_stats_plain(x16, *ops5, **kw5)
    torch.cuda.synchronize()
    eq5 = torch.equal(s5k, s5p) and torch.equal(a5k, a5p)
    print(f"[dense large] N={N_DENSE_ODD} (N_pad {ops5[0].shape[0]}) dense: B2 B=16 dyadic "
          f"bit_equal {eq5} ({float(a5p.sum()):.0f} spikes); structure {struct5}")
    if not (eq5 and float(a5p.sum()) > 0):
        fail(f"dense B2 at N = {N_DENSE_ODD} is not bit-equal to its twin (or silent)")
    if not struct5["held"]:
        fail(f"the dense device draw at {N_DENSE_ODD} neurons breaks its structure: {struct5}")
    return {"parity_4096": parity, "dense_10240": {"structure": struct10, "draw_s": draw_s,
                                                   "dyadic": pair10, "B2_256": b10,
                                                   "peak_mem_gb": peak / 1e9},
            "dense_5000": {"structure": struct5, "B2_bit_equal": bool(eq5),
                           "max_abs_err": finite_err(s5k, s5p)}}


# ---- 17. distributed ---------------------------------------------------------

def _dp_hot_walls(mesh, audio_np, reservoir, st, ro, fcfg, keys, dev, reps: int = 5) -> list:
    """Host walls of phase 4's inference path over the mesh: each rank
    featurizes and extracts its rows (audio already on the card), scales,
    predicts, and the predictions are gathered; every wall starts after a
    barrier and ends in `synchronize()`."""
    from lsm_tpu_torch.parallel import mesh as ml
    from lsm_tpu_torch.parallel.sharded import extract_features_dp, featurize_dp
    from lsm_tpu_torch.readout import logistic, scaler

    audio = ml.shard_batch(audio_np, mesh)

    def hot():
        f = extract_features_dp(reservoir, featurize_dp(audio, fcfg, mesh), keys, mesh)
        return ml.host_local(logistic.predict(ro, scaler.transform(st, f)), mesh)

    hot()
    walls = []
    for _ in range(reps):
        ml.barrier(mesh)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        hot()
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    return walls


def distributed_worker(task: str, out_dir: Path) -> None:
    """One rank of phase 17, launched by `distributed` through the entry
    points' env contract. task "pair": two gloo ranks sharing the card;
    "single": one NCCL rank. Writes out_dir/<task>.npz (rank 0) and
    out_dir/<task>_rank<r>.json."""
    import hashlib

    import torch.distributed as dist

    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import FEATURE_SETS, PipelineConfig, ReservoirConfig
    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io import artifacts, dataset
    from lsm_tpu_torch.models import sparse
    from lsm_tpu_torch.models.calibration import calibrate_weight
    from lsm_tpu_torch.models.reservoir import init_reservoir
    from lsm_tpu_torch.parallel import mesh as ml
    from lsm_tpu_torch.parallel.sharded import simulate_model_sharded_sparse
    from lsm_tpu_torch.parallel.train_step import ReadoutState, make_train_step
    from lsm_tpu_torch.readout import logistic

    if not ml.maybe_init_distributed_from_env():
        fail("the distributed worker found no LSM_TPU_COORDINATOR in its environment")
    dev = resolve_device("cuda")
    rank = dist.get_rank()
    args = json.loads((out_dir / "args.json").read_text())
    cfg = PipelineConfig()
    keys = tuple(FEATURE_SETS[cfg.feature_set])
    rec = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend()}
    arrays = {}
    audio, labels = dataset.synthetic_audio_batch(200, 12, seed=42)   # phase 4's corpus
    mesh = ml.make_mesh(dist.get_world_size(), 1, device=dev)
    if task == "single":
        audio_h, labels_h = dataset.synthetic_audio_batch_hard(30, 12, seed=42)
        reset_launches()
        result, ext_h = pipeline.run_pipeline_arrays(PipelineConfig(batch_size=64), audio_h,
                                                     labels_h, dev, mesh=mesh)
        rec.update(launches=read_launches(), accuracy=result.accuracy)
        arrays.update(x_train=ext_h.artifact.x_train, x_test=ext_h.artifact.x_test)
    reset_launches()
    ml.barrier(mesh)
    t0 = time.perf_counter()
    spikes = pipeline.featurize_audio_array(cfg, audio, dev, mesh=mesh)
    ext = pipeline.extract_lsm_features(cfg, artifacts.SpikeDataset(spikes, labels), dev,
                                        run_diagnostics=False, mesh=mesh)
    torch.cuda.synchronize(dev)
    rec["stages_wall_s"] = time.perf_counter() - t0
    rec["stages_launches"] = read_launches()
    rec["spikes_sha256"] = hashlib.sha256(spikes.tobytes()).hexdigest()
    if task == "pair":
        arrays.update(x_train=ext.artifact.x_train, x_test=ext.artifact.x_test)
        toy_x, toy_y = np.asarray(args["toy_x"], np.float32), np.asarray(args["toy_y"])
        ridge = logistic.fit_ridge_dp(toy_x, toy_y, 5, mesh)
        lg, it = logistic.fit_logistic_dp(toy_x, toy_y, 5, mesh, max_iter=200)
        arrays.update(ridge_w=ridge.w.cpu().numpy(), ridge_b=ridge.b.cpu().numpy(),
                      logistic_w=lg.w.cpu().numpy(), logistic_b=lg.b.cpu().numpy())
        rec["logistic_iters"] = it

        # The tensor-parallel block-sparse reservoir at configs[3] width on
        # a 1x2 mesh: B = 64 rows of phase 2's spikes, the dyadic copy and
        # the calibrated weights, bf16 weights as B5 rounds them.
        tp = ml.make_mesh(1, 2, device=dev)
        x = np.load(out_dir / "tp_spikes.npy")
        sr = sparse.init_reservoir_sparse(ReservoirConfig(num_neurons=N_10K, small_world_k=K_10K),
                                          x.shape[1], mean_weight=args["mw_10k"], device=dev)
        for name, r in (("dyadic", sr.dyadic()), ("calibrated", sr)):
            ml.barrier(tp)
            t0 = time.perf_counter()
            st = simulate_model_sharded_sparse(r, ml.shard_batch(x, tp), tp,
                                               matmul_dtype=torch.bfloat16)
            torch.cuda.synchronize(dev)
            rec[f"tp_{name}_s"] = time.perf_counter() - t0
            for k, v in st.items():
                if torch.is_tensor(v):
                    arrays[f"tp_{name}_{k}"] = v.cpu().numpy()
        del sr

        # The fused train step on the 2x1 mesh, five steps from a zero
        # readout, on every tenth utterance (all twelve classes).
        x_tr, y_tr = spikes[::10], labels[::10]
        _, mw = calibrate_weight(cfg.reservoir, x_tr, cfg.multiplier)
        res_d = init_reservoir(cfg.reservoir, x_tr.shape[1], mean_weight=mw, device=dev)
        step = make_train_step(res_d, keys, 12, mesh)
        d = len(keys) * res_d.n_outputs
        state = ReadoutState(torch.zeros(d, 12, device=dev), torch.zeros(12, device=dev))
        losses = []
        for _ in range(5):
            loss, state = step(ml.shard_batch(x_tr, mesh), ml.shard_batch(y_tr, mesh), state)
            losses.append(float(loss))
        rec["train_losses"] = losses

    # Phase 4's path over the mesh (2400 utterances), with a ridge readout
    # of their features.
    x_all = np.concatenate([ext.artifact.x_train, ext.artifact.x_test])
    y_all = np.concatenate([ext.artifact.y_train, ext.artifact.y_test])
    ro = logistic.fit_ridge(torch.as_tensor(x_all).to(dev), torch.as_tensor(y_all).to(dev), 12)
    rec["hot_walls_s"] = _dp_hot_walls(mesh, audio, ext.reservoir, ext.scaler, ro,
                                       cfg.frontend, keys, dev)
    rec["hot_utt_per_s"] = audio.shape[0] / min(rec["hot_walls_s"])
    if rank == 0:
        np.savez(out_dir / f"{task}.npz", **arrays)
    (out_dir / f"{task}_rank{rank}.json").write_text(json.dumps(rec))
    ml.barrier(mesh)
    dist.destroy_process_group()


def _launch_ranks(argv: list, n: int, cwd: Path, timeout: int, card: str) -> list:
    """Start n processes of argv with the env contract (a coordinator on a
    free localhost port), wait for all, and fail unless every one exits 0.
    Returns their stdouts."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO), "LSM_TPU_COORDINATOR": f"localhost:{port}",
           "LSM_TPU_NUM_PROCESSES": str(n)}
    procs = [subprocess.Popen(argv, cwd=cwd, env={**env, "LSM_TPU_PROCESS_ID": str(i)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-4000:])
            fail(f"rank {i} of {n} of `{' '.join(map(str, argv[1:4]))}` exited "
                 f"{p.returncode} ({card})")
    return outs


def distributed(dev, card, tmp: Path, phase3: dict, phase2_spikes, hot_walls: list) -> dict:
    """Phase 17: the batch and training path over several ranks (ROADMAP
    A14). Two gloo ranks share the card (NCCL refuses two ranks on one
    GPU; gloo takes CUDA tensors for all_reduce and broadcast, the only
    collectives the port uses): featurize_audio_array + extract_lsm_features
    on the 2400-utterance hot-path corpus on a 2x1 mesh, bit-equal to the
    single-process run on the same weights, B1 and B2 launched in each
    rank on the cluster body; fit_ridge_dp / fit_logistic_dp on
    tests/test_readout_dp.py's problem held to the single-process fits; the
    tensor-parallel block-sparse reservoir at configs[3] width on a 1x2
    mesh against B5 (bit-equal on the dyadic copy, spike totals within
    SPIKE_REL on the calibrated weights); make_train_step's loss falling
    over 5 steps; `python -m lsm_tpu_torch` as two processes on the hard
    slice. One NCCL rank on a 1x1 mesh runs phase 3's slice through the
    mesh path, bit-equal to phase 3. Walls beside phase 4's."""
    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import ReservoirConfig
    from lsm_tpu_torch.io import artifacts, dataset
    from lsm_tpu_torch.models import sparse
    from lsm_tpu_torch.models.calibration import calibrate_weight
    from lsm_tpu_torch.ops.kernels import sparse_lif as ksp
    from lsm_tpu_torch.readout import logistic
    from lsm_tpu_torch.config import PipelineConfig

    out = tmp / "distributed"
    out.mkdir()
    rng = np.random.default_rng(0)          # tests/test_readout_dp.py's _toy_problem
    centers = rng.normal(0, 2.0, (5, 24)).astype(np.float32)
    toy_y = rng.integers(0, 5, 257).astype(np.int32)
    toy_x = (centers[toy_y] + rng.normal(0, 1.0, (257, 24)).astype(np.float32)).astype(np.float32)
    rcfg10 = ReservoirConfig(num_neurons=N_10K, small_world_k=K_10K)
    _, mw10 = calibrate_weight(rcfg10, phase2_spikes, MULT_10K)
    np.save(out / "tp_spikes.npy", phase2_spikes[:64].cpu().numpy())
    (out / "args.json").write_text(json.dumps({"toy_x": toy_x.tolist(), "toy_y": toy_y.tolist(),
                                               "mw_10k": mw10}))
    rec = {}
    worker = list(DISTRIBUTED_WORKER)
    t0 = time.perf_counter()
    _launch_ranks(worker + ["pair", str(out)], 2, tmp, 400, card)
    rec["pair_process_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _launch_ranks(worker + ["single", str(out)], 1, tmp, 300, card)
    rec["single_process_s"] = time.perf_counter() - t0
    pair = [json.loads((out / f"pair_rank{r}.json").read_text()) for r in (0, 1)]
    single = json.loads((out / "single_rank0.json").read_text())
    got, one = np.load(out / "pair.npz"), np.load(out / "single.npz")
    rec["backends"] = {"pair": [p["backend"] for p in pair], "single": single["backend"]}
    print(f"[distributed] two ranks on the card: backend {rec['backends']['pair']}; one "
          f"rank: backend {rec['backends']['single']}")
    if rec["backends"] != {"pair": ["gloo", "gloo"], "single": "nccl"}:
        fail(f"phase 17's backends: {rec['backends']}")

    # The hot-path corpus on 2 ranks against one process on the same weights.
    cfg = PipelineConfig()
    audio, labels = dataset.synthetic_audio_batch(200, 12, seed=42)
    spikes = pipeline.featurize_audio_array(cfg, audio, dev, mesh=None)
    ext = pipeline.extract_lsm_features(cfg, artifacts.SpikeDataset(spikes, labels), dev,
                                        run_diagnostics=False, mesh=None)
    sha = __import__("hashlib").sha256(spikes.tobytes()).hexdigest()
    rec["pair"] = {
        "spikes_bit_equal": all(p["spikes_sha256"] == sha for p in pair),
        "features_bit_equal": bool(np.array_equal(got["x_train"], ext.artifact.x_train)
                                   and np.array_equal(got["x_test"], ext.artifact.x_test)),
        "launches": [p["stages_launches"] for p in pair],
        "stages_wall_s": [p["stages_wall_s"] for p in pair]}
    each = rec["pair"]["launches"]
    print(f"[distributed] 2400 utterances on a 2x1 mesh: spikes bit-equal "
          f"{rec['pair']['spikes_bit_equal']}, features bit-equal "
          f"{rec['pair']['features_bit_equal']}; launches rank 0 B1 {each[0]['B1']} B2 "
          f"{each[0]['B2']}, rank 1 B1 {each[1]['B1']} B2 {each[1]['B2']} (dense bodies "
          f"{each[0]['dense_bodies']}, {each[1]['dense_bodies']})")
    if not (rec["pair"]["spikes_bit_equal"] and rec["pair"]["features_bit_equal"]):
        fail(f"the 2-rank features differ from the single process's: {rec['pair']}")
    if not all(e["B1"] > 0 and e["B2"] > 0 and on_cluster_body(e) for e in each):
        fail(f"B1 and B2 on the cluster body were not launched in each rank: {each}")

    # The data-parallel readout fits against the single-process ones.
    xt, yt = torch.as_tensor(toy_x).to(dev), torch.as_tensor(toy_y).to(dev)
    ridge = logistic.fit_ridge(xt, yt, 5)
    lg, _ = logistic.fit_logistic(xt, yt, 5, max_iter=200)
    ridge_ok = bool(np.allclose(got["ridge_w"], ridge.w.cpu().numpy(), rtol=1e-4, atol=1e-5)
                    and np.allclose(got["ridge_b"], ridge.b.cpu().numpy(), rtol=1e-4, atol=1e-5))
    pred_dp = np.argmax(toy_x @ got["logistic_w"] + got["logistic_b"], axis=1)
    lg_ok = bool(np.allclose(got["logistic_w"], lg.w.cpu().numpy(), rtol=0, atol=5e-3)
                 and np.allclose(got["logistic_b"], lg.b.cpu().numpy(), rtol=0, atol=5e-3)
                 and np.array_equal(pred_dp, logistic.predict(lg, xt).cpu().numpy()))
    rec["readouts"] = {
        "ridge_max_abs_err": float(np.abs(got["ridge_w"] - ridge.w.cpu().numpy()).max()),
        "logistic_max_abs_err": float(np.abs(got["logistic_w"] - lg.w.cpu().numpy()).max()),
        "ridge_ok": ridge_ok, "logistic_ok": lg_ok}
    print(f"[distributed] fit_ridge_dp vs fit_ridge max |dW| "
          f"{rec['readouts']['ridge_max_abs_err']:.2e} ({ridge_ok}); fit_logistic_dp vs "
          f"fit_logistic max |dW| {rec['readouts']['logistic_max_abs_err']:.2e}, equal "
          f"predictions ({lg_ok})")
    if not (ridge_ok and lg_ok):
        fail(f"the data-parallel readout fits: {rec['readouts']}")

    # The tensor-parallel sparse reservoir against B5.
    sr = sparse.init_reservoir_sparse(rcfg10, phase2_spikes.shape[1], mean_weight=mw10,
                                      device=dev)
    x64 = phase2_spikes[:64].contiguous()
    tp = {}
    for name, r in (("dyadic", sr.dyadic()), ("calibrated", sr)):
        ops, kw = r.kernel_operands()
        stats, all_counts = ksp.sparse_lif_stats(x64, *ops, **kw)
        ref = dict(zip(["counts", "sum_t", "sum_t2", "first", "last", "n_isi", "sum_isi",
                        "sum_isi2", "bursts", "win_sum", "win_sum2"], stats.cpu().numpy()))
        port_total = float(got[f"tp_{name}_all_counts"].sum())
        b5_total = float(all_counts.sum())
        tp[name] = {
            "stats_bit_equal": all(np.array_equal(got[f"tp_{name}_{k}"], v)
                                   for k, v in ref.items()),
            "all_counts_bit_equal": bool(np.array_equal(got[f"tp_{name}_all_counts"],
                                                        all_counts.cpu().numpy())),
            "spikes_tp": port_total, "spikes_B5": b5_total,
            "spike_rel": abs(port_total - b5_total) / max(b5_total, 1.0),
            "seconds": pair[0][f"tp_{name}_s"]}
    rec["tensor_parallel_sparse"] = tp
    print(f"[distributed] tensor-parallel sparse reservoir, 1x2 mesh, N={N_10K} B=64 T=400: "
          f"dyadic stats bit-equal to B5 {tp['dyadic']['stats_bit_equal']} (all_counts "
          f"{tp['dyadic']['all_counts_bit_equal']}, {tp['dyadic']['seconds']:.2f} s); calibrated "
          f"spikes {tp['calibrated']['spikes_tp']:.0f} vs B5 {tp['calibrated']['spikes_B5']:.0f} "
          f"(rel {tp['calibrated']['spike_rel']:.2e}, {tp['calibrated']['seconds']:.2f} s)")
    if not (tp["dyadic"]["stats_bit_equal"] and tp["dyadic"]["all_counts_bit_equal"]):
        fail("the tensor-parallel sparse reservoir is not bit-equal to B5 on the dyadic copy")
    if tp["calibrated"]["spike_rel"] > SPIKE_REL:
        fail(f"tensor-parallel spike totals part from B5's by {tp['calibrated']['spike_rel']:.2e}")

    losses = pair[0]["train_losses"]
    rec["train_losses"] = losses
    print(f"[distributed] make_train_step on 2x1, 5 steps: losses "
          + " ".join(f"{v:.4f}" for v in losses))
    if not losses[-1] < losses[0]:
        fail(f"the train step's loss did not fall: {losses}")

    # One NCCL rank: phase 3's slice through the mesh path.
    rec["single"] = {"features_bit_equal": bool(
        np.array_equal(one["x_train"], phase3["x_train"])
        and np.array_equal(one["x_test"], phase3["x_test"])),
        "accuracy": single["accuracy"], "launches": single["launches"]}
    print(f"[distributed] one NCCL rank, 1x1 mesh, the hard slice: features bit-equal to "
          f"phase 3 {rec['single']['features_bit_equal']}, accuracy {single['accuracy']:.4f} "
          f"(phase 3 {phase3['accuracy']:.4f}), launches B1 {single['launches']['B1']} B2 "
          f"{single['launches']['B2']}")
    if not rec["single"]["features_bit_equal"]:
        fail("the 1x1 NCCL mesh path's features differ from phase 3's")

    # The pipeline entry point as two processes (env contract) on the hard slice.
    cli = [sys.executable, "-m", "lsm_tpu_torch", "--synthetic", "--hard",
           "--samples-per-class", "30", "--batch-size", "64", "--skip-artifacts"]
    t0 = time.perf_counter()
    logs = _launch_ranks(cli, 2, tmp, 300, card)
    rec["cli_process_s"] = time.perf_counter() - t0
    import re

    accs = [float(re.search(r"Test Accuracy: ([0-9.]+)%", s).group(1)) / 100 for s in logs]
    regimes = [re.search(r"STATUS: ([A-Z -]+)", s).group(1).strip() for s in logs]
    n_test = len(phase3["x_test"])
    rec["cli"] = {"accuracy": accs, "regime": regimes}
    print(f"[distributed] `python -m lsm_tpu_torch --synthetic --hard` on 2 processes: exit 0 "
          f"on both, accuracy {accs} regime {regimes} (phase 3: {phase3['accuracy']:.4f} "
          f"{phase3['regime']}) in {rec['cli_process_s']:.1f} s")
    if not all(abs(a - phase3["accuracy"]) <= 1.0 / n_test + 1e-9 for a in accs) or \
            any(r != phase3["regime"] for r in regimes):
        fail(f"the 2-process CLI: {rec['cli']} against phase 3's {phase3['accuracy']} "
             f"{phase3['regime']}")

    rec["walls"] = {"single_process_phase4_s": min(hot_walls),
                    "two_ranks_s": min(pair[0]["hot_walls_s"]),
                    "one_nccl_rank_s": min(single["hot_walls_s"])}
    print(f"[distributed] phase 4's path, 2400 utterances, min of 5 walls: one process "
          f"{rec['walls']['single_process_phase4_s'] * 1e3:.2f} ms; two gloo ranks sharing the "
          f"card {rec['walls']['two_ranks_s'] * 1e3:.2f} ms; one NCCL rank on a 1x1 mesh "
          f"{rec['walls']['one_nccl_rank_s'] * 1e3:.2f} ms ({card})")
    return rec


# ---- 18. serving over ranks ---------------------------------------------------

# Phase 18's exact and block-sparse engines serve this many streams (the
# exact hop re-runs the 1 s window; B6 at 10240 neurons is the sparse hop).
N_RANKS_EXACT = N_RANKS_SPARSE = 256
# The mesh engines' logits against one process's, relative to each
# stream's largest logit: the readout product on half the rows takes
# another cuBLAS algorithm (the features feeding it are bit-equal).
LOGITS_REL = 1e-5


def _sha(a) -> str:
    import hashlib

    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _rows(kws):
    """The rows of a full host chunk that this rank's engine takes."""
    return lambda h: np.ascontiguousarray(h[kws.rows])


def serve_sequence(kws, hops, path: Path, barrier) -> tuple:
    """Phase 18's continuous-engine sequence, the same on one process and
    on the ranks of a mesh (each feeding its rows): one window of warm-up,
    ten hops timed on the host (a barrier, then synchronize() around each
    step), the features' and the snapshot's hashes, step_active with 25 %
    of the streams against step with silence in the other rows (logits and
    this rank's state), a reset of every other stream by mask and two
    hops, the state file (rank 0 writes), two more hops. Returns (record,
    arrays)."""
    from lsm_tpu_torch.io.serving_state import save_serving_state

    local = _rows(kws)
    reset_launches()
    for h in hops:
        kws.step(local(h))
    walls, logits = [], []
    for h in hops:
        barrier()
        torch.cuda.synchronize(kws.device)
        t0 = time.perf_counter()
        logits.append(kws.step(local(h)))
        torch.cuda.synchronize(kws.device)
        walls.append(time.perf_counter() - t0)
    rec = {"launches": read_launches(), "hop_walls_s": walls,
           "features_sha": _sha(kws.features()),
           "state_sha": {k: _sha(v) for k, v in kws.snapshot().items()}}
    arrays = {"logits": np.stack(logits)}
    idx = np.arange(0, kws.n_streams, 4)
    h = hops[0]
    before = kws.state                       # every step makes new tensors
    arrays["active"] = kws.step_active(h[idx], idx)
    after = kws._leaves()
    kws.state = before
    silent = np.zeros_like(h)
    silent[idx] = h[idx]
    rec["active_equals_silence"] = bool(
        np.array_equal(arrays["active"], kws.step(local(silent)))
        and all(torch.equal(after[k], v) for k, v in kws._leaves().items()))
    mask = np.zeros(kws.n_streams, bool)
    mask[::2] = True
    kws.reset(mask)
    arrays["after_reset"] = np.stack([kws.step(local(h)) for h in hops[1:3]])
    save_serving_state(path, kws, compress=False)
    arrays["continued"] = np.stack([kws.step(local(h)) for h in hops[3:5]])
    return rec, arrays


def serve_exact(kws, hops) -> tuple:
    """The exact engine over its first n streams: one window of warm-up,
    then three hops with the launches counted."""
    local, n = _rows(kws), kws.n_streams
    for h in hops:
        kws.step(local(h[:n]))
    reset_launches()
    logits = np.stack([kws.step(local(h[:n])) for h in hops[:3]])
    return {"launches": read_launches()}, {"logits": logits}


def serve_sparse(kws, hops) -> tuple:
    """The block-sparse continuous engine over its first n streams: ten
    hops with the launches counted, the snapshot's hashes and the window's
    output spike total."""
    local, n = _rows(kws), kws.n_streams
    reset_launches()
    for h in hops:
        last = kws.step(local(h[:n]))
    snap = kws.snapshot()
    return ({"launches": read_launches(), "state_sha": {k: _sha(v) for k, v in snap.items()},
             "spikes": float(snap["seg:counts"].sum())}, {"logits": last})


def serving_worker(task: str, out_dir: Path) -> None:
    """One rank of phase 18, launched by `serving_ranks` through the entry
    points' env contract. task "serve_pair": two gloo ranks sharing the
    card run the continuous engine's sequence at 1024 streams (and reload
    the ranks' state file), the exact engine and the block-sparse
    continuous engine at 256; "serve_single": one NCCL rank on a 1x1 mesh
    runs the continuous sequence. Writes out_dir/<task>.npz (rank 0) and
    out_dir/<task>_rank<r>.json."""
    import torch.distributed as dist

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io.model import load_model
    from lsm_tpu_torch.io.serving_state import load_serving_state
    from lsm_tpu_torch.models.continuous import ContinuousKWS
    from lsm_tpu_torch.models.streaming import StreamingKWS
    from lsm_tpu_torch.parallel import mesh as ml

    if not ml.maybe_init_distributed_from_env():
        fail("the serving worker found no LSM_TPU_COORDINATOR in its environment")
    mesh = ml.make_mesh(dist.get_world_size(), 1, device=resolve_device("cuda"))
    rank = dist.get_rank()
    rec = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend()}
    hops = serving_hops(N_SERVE)["pcm16"]
    dense = load_model(out_dir / "cont.npz", mesh.device)

    def cont(bundle, n):
        return ContinuousKWS(bundle.reservoir, bundle.readout, bundle.scaler, bundle.frontend,
                             bundle.feature_set, n_streams=n, chunk_len=CHUNK, mesh=mesh)

    kws = cont(dense, N_SERVE)
    state = out_dir / f"{task}_state.npz"
    rec["continuous"], got = serve_sequence(kws, hops, state, lambda: ml.barrier(mesh))
    arrays = {f"cont_{k}": v for k, v in got.items()}
    if task == "serve_pair":
        fresh = cont(dense, N_SERVE)
        load_serving_state(state, fresh)
        arrays["cont_reloaded"] = np.stack([fresh.step(_rows(fresh)(h)) for h in hops[3:5]])
        del kws, fresh
        ex = StreamingKWS(dense.reservoir, dense.readout, dense.scaler, dense.frontend,
                          dense.feature_set, n_streams=N_RANKS_EXACT, mesh=mesh)
        rec["exact"], got = serve_exact(ex, hops)
        arrays.update({f"exact_{k}": v for k, v in got.items()})
        del ex
        sparse = load_model(out_dir / "sparse.npz", mesh.device)
        rec["sparse"], got = serve_sparse(cont(sparse, N_RANKS_SPARSE), hops)
        arrays.update({f"sparse_{k}": v for k, v in got.items()})
    if rank == 0:
        np.savez(out_dir / f"{task}.npz", **arrays)
    (out_dir / f"{task}_rank{rank}.json").write_text(json.dumps(rec))
    ml.barrier(mesh)
    dist.destroy_process_group()


def logits_rule(a, b) -> dict:
    """The mesh engines' logits against one process's: bit-equal, or
    within LOGITS_REL of the stream's largest logit magnitude (a logit
    sums ~2000 terms that cancel, so its own size says little) with the
    argmax equal."""
    a, b = np.asarray(a), np.asarray(b)
    bits = bool(np.array_equal(a, b))
    scale = np.maximum(np.abs(b).max(-1, keepdims=True), np.finfo(np.float32).tiny)
    rel = float((np.abs(a - b) / scale).max())
    argmax = bool(np.array_equal(a.argmax(-1), b.argmax(-1)))
    return {"bit_equal": bits, "max_abs_err": float(np.abs(a - b).max()),
            "max_row_rel_err": rel, "argmax_equal": argmax,
            "ok": bits or (rel <= LOGITS_REL and argmax)}


def serving_ranks(dev, card, tmp: Path, phase7: dict) -> dict:
    """Phase 18: the serving engines over ranks (ROADMAP A14's serving
    half). Two gloo ranks share the card: ContinuousKWS at 1024 streams
    (512 a rank) with phase 6's modules (phase 12's continuous bundle) on
    the int16 wire, serve_sequence's steps; the state leaves, features and
    the snapshot bit-equal to one process on the same bundle, the logits
    by logits_rule, B3 and B4 (cluster body) launched in each rank, the
    hop wall beside phase 7's; step_active at 25 % bit-equal to step with
    silence; the ranks' state file loaded by one process and by the ranks
    again, both continuing bit-equal. The exact engine at 256 streams (B1
    and B2 in each rank) and the 10240-neuron block-sparse continuous
    engine of phase 9's bundle at 256 (B6 in each rank, spike total within
    SPIKE_REL, bits reported). `python -m lsm_tpu_torch.cli.stream_kws
    --pool --max-streams 1024` as two processes on phase 11's WAVs predicts
    as phase 12's static run, rank 0 alone writing. One NCCL rank on a 1x1
    mesh runs serve_sequence bit-equal to one process."""
    from lsm_tpu_torch.io.model import load_model
    from lsm_tpu_torch.io.serving_state import load_serving_state
    from lsm_tpu_torch.models.continuous import ContinuousKWS
    from lsm_tpu_torch.models.streaming import StreamingKWS

    out = tmp / "serve_ranks"
    out.mkdir()
    for name in ("cont.npz", "sparse.npz"):
        (out / name).symlink_to(tmp / name)
    worker = list(DISTRIBUTED_WORKER)
    rec = {}
    rec["pair_process_s"], _ = timed(lambda: _launch_ranks(worker + ["serve_pair", str(out)], 2,
                                                           tmp, 400, card))
    rec["single_process_s"], _ = timed(lambda: _launch_ranks(
        worker + ["serve_single", str(out)], 1, tmp, 300, card))
    pair = [json.loads((out / f"serve_pair_rank{r}.json").read_text()) for r in (0, 1)]
    single = json.loads((out / "serve_single_rank0.json").read_text())
    got, one = np.load(out / "serve_pair.npz"), np.load(out / "serve_single.npz")
    rec["backends"] = {"pair": [p["backend"] for p in pair], "single": single["backend"]}
    if rec["backends"] != {"pair": ["gloo", "gloo"], "single": "nccl"}:
        fail(f"phase 18's backends: {rec['backends']}")

    # One process on the same bundles, the same sequences.
    hops = serving_hops(N_SERVE)["pcm16"]
    dense = load_model(tmp / "cont.npz", dev)

    def cont(bundle, n):
        return ContinuousKWS(bundle.reservoir, bundle.readout, bundle.scaler, bundle.frontend,
                             bundle.feature_set, n_streams=n, chunk_len=CHUNK)

    ref_rec, ref = serve_sequence(cont(dense, N_SERVE), hops, out / "one_state.npz", lambda: None)
    fresh = cont(dense, N_SERVE)
    load_serving_state(out / "serve_pair_state.npz", fresh)
    from_ranks = np.stack([fresh.step(h) for h in hops[3:5]])
    del fresh
    ex_rec, ex_ref = serve_exact(StreamingKWS(dense.reservoir, dense.readout, dense.scaler,
                                              dense.frontend, dense.feature_set,
                                              n_streams=N_RANKS_EXACT), hops)
    sparse = load_model(tmp / "sparse.npz", dev)
    sp_rec, sp_ref = serve_sparse(cont(sparse, N_RANKS_SPARSE), hops)
    del sparse

    c = [p["continuous"] for p in pair]
    cont_rec = {
        "state_bit_equal": all(p["state_sha"] == ref_rec["state_sha"] for p in c),
        "features_bit_equal": all(p["features_sha"] == ref_rec["features_sha"] for p in c),
        "logits": {k: logits_rule(got[f"cont_{k}"], ref[k])
                   for k in ("logits", "active", "after_reset", "continued")},
        "active_equals_silence": [p["active_equals_silence"] for p in c],
        "ranks_reload_bit_equal": bool(np.array_equal(got["cont_reloaded"],
                                                      got["cont_continued"])),
        "one_process_load_bit_equal": bool(np.array_equal(from_ranks, ref["continued"])),
        "launches": [p["launches"] for p in c],
        "hop_wall_ms_median": [statistics.median(p["hop_walls_s"]) * 1e3 for p in c],
        "hop_wall_ms_min": [min(p["hop_walls_s"]) * 1e3 for p in c],
        "one_process_hop_wall_ms_median": statistics.median(ref_rec["hop_walls_s"]) * 1e3,
        "one_process_hop_wall_ms_min": min(ref_rec["hop_walls_s"]) * 1e3,
        "phase7_hop_wall_ms_median": phase7["hop_wall_ms_median"],
        "phase7_hop_wall_ms_min": phase7["hop_wall_ms_min"]}
    rec["continuous"] = cont_rec
    print(f"[serving ranks] ContinuousKWS N={dense.reservoir.n_neurons}, {N_SERVE} streams on "
          f"two gloo ranks sharing the card, int16 wire: state leaves bit-equal to one process "
          f"{cont_rec['state_bit_equal']}, features {cont_rec['features_bit_equal']}; logits "
          + ", ".join(f"{k} bit-equal {v['bit_equal']} (max |d| {v['max_abs_err']:.2e}, "
                      f"{v['max_row_rel_err']:.2e} of the row's largest, argmax equal "
                      f"{v['argmax_equal']})" for k, v in cont_rec["logits"].items())
          + f"; step_active 25 % = step with silence {cont_rec['active_equals_silence']}; the "
          f"ranks' state file: reloaded by the ranks bit-equal "
          f"{cont_rec['ranks_reload_bit_equal']}, by one process "
          f"{cont_rec['one_process_load_bit_equal']} ({card})")
    print(f"[serving ranks] hop wall (median / min of 10): rank 0 "
          f"{cont_rec['hop_wall_ms_median'][0]:.3f} / {cont_rec['hop_wall_ms_min'][0]:.3f} ms, "
          f"rank 1 {cont_rec['hop_wall_ms_median'][1]:.3f} / {cont_rec['hop_wall_ms_min'][1]:.3f}"
          f" ms; one process in this phase {cont_rec['one_process_hop_wall_ms_median']:.3f} / "
          f"{cont_rec['one_process_hop_wall_ms_min']:.3f} ms; phase 7 "
          f"{phase7['hop_wall_ms_median']:.3f} / {phase7['hop_wall_ms_min']:.3f} ms; launches "
          f"rank 0 {c[0]['launches']}, rank 1 {c[1]['launches']} ({card})")
    if not (cont_rec["state_bit_equal"] and cont_rec["features_bit_equal"]
            and all(v["ok"] for v in cont_rec["logits"].values())
            and all(cont_rec["active_equals_silence"]) and cont_rec["ranks_reload_bit_equal"]
            and cont_rec["one_process_load_bit_equal"]):
        fail(f"the continuous engine over two ranks: {cont_rec}")
    if not all(e["B3"] > 0 and e["B4"] > 0 and on_cluster_body(e) for e in cont_rec["launches"]):
        fail(f"B3 and B4 on the cluster body were not launched in each rank: "
             f"{cont_rec['launches']}")

    ex = [p["exact"] for p in pair]
    rec["exact"] = {"logits": logits_rule(got["exact_logits"], ex_ref["logits"]),
                    "launches": [p["launches"] for p in ex], "one_process": ex_rec["launches"]}
    sp = [p["sparse"] for p in pair]
    spikes = sp[0]["spikes"]
    rec["sparse"] = {"state_bit_equal": all(p["state_sha"] == sp_rec["state_sha"] for p in sp),
                     "logits": logits_rule(got["sparse_logits"], sp_ref["logits"]),
                     "spikes": spikes, "one_process_spikes": sp_rec["spikes"],
                     "spike_rel": abs(spikes - sp_rec["spikes"]) / max(sp_rec["spikes"], 1.0),
                     "launches": [p["launches"] for p in sp]}
    e, q = rec["exact"], rec["sparse"]
    print(f"[serving ranks] exact engine, {N_RANKS_EXACT} streams on two ranks: logits bit-equal "
          f"{e['logits']['bit_equal']} (max |d| {e['logits']['max_abs_err']:.2e}), launches rank 0 "
          f"B1 {e['launches'][0]['B1']} B2 {e['launches'][0]['B2']}, rank 1 B1 "
          f"{e['launches'][1]['B1']} B2 {e['launches'][1]['B2']}; sparse continuous N="
          f"{N_10K}, {N_RANKS_SPARSE} streams: state bit-equal {q['state_bit_equal']}, spikes "
          f"{q['spikes']:.0f} vs one process {q['one_process_spikes']:.0f} (rel "
          f"{q['spike_rel']:.2e}), logits bit-equal {q['logits']['bit_equal']}, B6 rank 0 "
          f"{q['launches'][0]['B6']} rank 1 {q['launches'][1]['B6']} ({card})")
    if not (e["logits"]["ok"] and all(x["B1"] == 3 and x["B2"] == 3 and on_cluster_body(x)
                                      for x in e["launches"])):
        fail(f"the exact engine over two ranks: {e}")
    if q["spike_rel"] > SPIKE_REL or not all(x["B6"] > 0 for x in q["launches"]):
        fail(f"the sparse continuous engine over two ranks: {q}")

    s = single["continuous"]
    rec["single"] = {"state_bit_equal": s["state_sha"] == ref_rec["state_sha"],
                     "features_bit_equal": s["features_sha"] == ref_rec["features_sha"],
                     "logits_bit_equal": all(np.array_equal(one[f"cont_{k}"], ref[k])
                                             for k in ref),
                     "hop_wall_ms_median": statistics.median(s["hop_walls_s"]) * 1e3,
                     "hop_wall_ms_min": min(s["hop_walls_s"]) * 1e3, "launches": s["launches"]}
    print(f"[serving ranks] one NCCL rank, 1x1 mesh: state, features and every logit "
          f"bit-equal to one process {rec['single']['state_bit_equal']}, "
          f"{rec['single']['features_bit_equal']}, {rec['single']['logits_bit_equal']}; hop "
          f"wall {rec['single']['hop_wall_ms_median']:.3f} / {rec['single']['hop_wall_ms_min']:.3f}"
          f" ms ({card})")
    if not (rec["single"]["state_bit_equal"] and rec["single"]["features_bit_equal"]
            and rec["single"]["logits_bit_equal"]):
        fail(f"the 1x1 NCCL mesh engine differs from one process: {rec['single']}")

    # The serving entry point as two processes, --pool over 1024 slots.
    cli = [sys.executable, "-m", "lsm_tpu_torch.cli.stream_kws", "--model", str(tmp / "m.npz"),
           "--data-dir", str(tmp / "corpus"), "--wire", "pcm16", "--pool", "--max-streams",
           str(N_SERVE), "--output", str(out / "pool2.npz")]
    rec["pool_process_s"], logs = timed(lambda: _launch_ranks(cli, 2, tmp, 400, card))
    st, po = np.load(tmp / "static.npz"), np.load(out / "pool2.npz")
    by_file = dict(zip(st["files"], st["predictions"]))
    rec["pool"] = {
        "equals_static": bool(len(po["files"]) == len(st["files"]) and all(
            by_file[f] == p for f, p in zip(po["files"], po["predictions"]))),
        "mesh_x2": "mesh x2" in logs[0],
        "rank1_silent": "Final predictions" not in logs[1] and "Served" not in logs[1],
        "served": _served(logs[0])}
    print(f"[serving ranks] cli.stream_kws --pool --max-streams {N_SERVE} on two processes, "
          f"{len(po['files'])} WAVs: predictions = phase 12's static run "
          f"{rec['pool']['equals_static']}, mesh x2 {rec['pool']['mesh_x2']}, rank 1 printed "
          f"nothing {rec['pool']['rank1_silent']}; {rec['pool']['served'].get('served_line')} "
          f"({rec['pool_process_s']:.1f} s) ({card})")
    if not all(rec["pool"][k] for k in ("equals_static", "mesh_x2", "rank1_silent")):
        fail(f"the pool over two processes: {rec['pool']}")
    rec["tools"] = measurement_tools(card, tmp)
    return rec


# Each measurement tool once at a small size (its JSON line is its result):
# (name, arguments, ranks).
TOOL_RUNS = (
    ("bench_streaming", ["--pcm16", "--streams", "1", "1024", "--steps", "5"], 1),
    ("bench_streaming", ["--continuous", "--pcm16", "--mesh", "--streams", "1024",
                         "--steps", "5"], 2),
    ("bench_continuous", ["--n-per-class", "5", "--bench-streams", "1024", "--steps", "3"], 1),
    ("bench_state", ["--streams", "256", "--reps", "1"], 1),
    ("bench_tp", ["--sparse", "--num-neurons", str(N_10K), "--batch", "16", "--t", "100",
                  "--repeats", "1"], 2),
    ("profile_stages", ["--n", "1024", "--continuous", "--repeats", "2"], 1),
)


def measurement_tools(card, tmp: Path) -> dict:
    """`python -m lsm_tpu_torch.tools.<name>` for each of TOOL_RUNS as
    subprocesses on the card (the ranks through the env contract): each
    must exit 0 and end in its JSON line."""
    rec = {}
    for name, args, ranks in TOOL_RUNS:
        argv = [sys.executable, "-m", f"lsm_tpu_torch.tools.{name}", *args]
        seconds, outs = timed(lambda: _launch_ranks(argv, ranks, tmp, 400, card))
        # Rank 0's stdout and stderr come merged: its last JSON object line
        # (a process group's exit may log after it).
        lines = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
        try:
            got = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            print(outs[0][-3000:])
            fail(f"{name} {' '.join(args)} printed no JSON line ({card})")
        got["process_s"] = seconds
        rec[f"{name} {' '.join(args)}"] = got
        print(f"[tools] {name} {' '.join(args)} on {ranks} rank(s): {seconds:.1f} s; "
              + json.dumps({k: v for k, v in got.items() if k != "tool"})[:1500])
    return rec


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--distributed-worker":
        worker = serving_worker if sys.argv[2].startswith("serve") else distributed_worker
        worker(sys.argv[2], Path(sys.argv[3]))
    else:
        main()
