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

A "[record] {...}" line holds every number of the run as JSON. The
second-to-last stdout line is a JSON object with each kernel's launches,
error against its twin and times; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ACC_BAND = (0.76, 0.90)       # tests/test_accuracy_band.py, frozen


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
    }
    print(f"[B2 lif] B=256 C=128 N=1000 T=400 dyadic: bit_equal {equal} "
          f"max_abs_err {b2_abs:.3e}; random weights feature max rel err "
          f"{rand_rel:.3e}; kernel {b2['ms']:.3f} ms plain {b2['plain_ms']:.3f} ms ({card})")
    if not equal:
        fail("B2 statistics are not bit-equal to the plain twin on dyadic weights")
    record["B1"], record["B2"] = b1, b2

    # ---- 3. the slice ---------------------------------------------------
    audio_h, labels_h = dataset.synthetic_audio_batch_hard(30, 12, seed=42)
    kgt.launches = 0
    klif.launches = 0
    t0 = time.perf_counter()
    result, ext = pipeline.run_pipeline_arrays(
        PipelineConfig(batch_size=64), audio_h, labels_h, dev
    )
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = {"B1": kgt.launches, "B2": klif.launches}
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
    record["hot"] = hot_rec
    print(f"[hot] {n} utt audio-on-card -> predictions: {hot_rec['utt_per_s']:.1f} utt/s "
          f"(min of 5 walls {min(walls) * 1e3:.2f} ms, median "
          f"{statistics.median(walls) * 1e3:.2f} ms); stages "
          + " ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; B1 {hot_rec['B1_ms_2400']:.2f} ms B2 {hot_rec['B2_ms_2400']:.2f} ms "
          f"at B={n}; fit accuracy {fit_acc:.3f} ({card})")

    kernels = {"kernels": [
        {"name": "gtgram_sub_energy", "route": "cuda",
         "source": "lsm_tpu_torch/csrc/gtgram.cu",
         "replaces": "lsm_tpu/ops/pallas/gtgram_kernel.py:70",
         "launches": launches["B1"], "max_abs_err": b1["max_abs_err"],
         "ms": b1["ms"], "plain_ms": b1["plain_ms"]},
        {"name": "lif_stats", "route": "cuda",
         "source": "lsm_tpu_torch/csrc/lif.cu",
         "replaces": "lsm_tpu/ops/pallas/lif_kernel.py:46",
         "launches": launches["B2"], "max_abs_err": b2["max_abs_err"],
         "ms": b2["ms"], "plain_ms": b2["plain_ms"]},
    ]}
    check_no_reference()
    print("[record] " + json.dumps(record))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
