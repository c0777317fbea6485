"""Flags and config assembly shared by the port's entry points (the
counterpart of lsm_tpu/cli/common.py).

The flag names and defaults are the reference scripts'. The port adds
--device (cuda by default; no silent CPU fallback). It always runs on one
device, which is what lsm_tpu's --single-device asks for, so that flag is
taken and changes nothing.
"""

from __future__ import annotations

import argparse
import logging
import sys

from lsm_tpu_torch.config import (
    COMMANDS_12, COMMANDS_35, FEATURE_SETS, FrontendConfig, PipelineConfig, ReservoirConfig,
)

def setup_logging() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout, force=True)


def add_frontend_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n-filters", type=int, default=128,
                   help="Number of filters for the filterbank.")
    p.add_argument("--filterbank", type=str, default="gammatone",
                   choices=["mel", "gammatone"],
                   help="Type of filterbank to use.")


def add_extract_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--feature-set", type=str, default="original",
                   choices=list(FEATURE_SETS.keys()))
    p.add_argument("--multiplier", type=float, default=0.6)
    p.add_argument("--leak-variance-divisor", type=float, default=None)


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu.")


def add_vocab_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--vocab", type=str, default="v12", choices=["v12", "v35"],
                   help="12-command reference vocabulary or full 35-class set.")
    p.add_argument("--commands", type=str, default=None,
                   help="Comma-separated keyword subset (e.g. 'yes,no,up,down'); "
                        "overrides --vocab. Class index = position in the list.")


def add_audio_wire_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--audio-wire", type=str, default="int16", choices=["int16", "ulaw"],
                   help="Decoder->device audio format of the WAV stages: int16 "
                        "(exact for PCM16 files, half the float32 bytes) or ulaw "
                        "(uint8 G.711 mu-law, a quarter, lossy).")


def add_extension_flags(p: argparse.ArgumentParser) -> None:
    """lsm_tpu's extensions beyond the reference CLI, and --device."""
    p.add_argument("--data-dir", type=str, default="speech_commands_v0.02",
                   help="Speech Commands-style dataset root.")
    add_vocab_flags(p)
    p.add_argument("--synthetic", action="store_true",
                   help="Use a synthetic corpus (no dataset on disk needed).")
    p.add_argument("--samples-per-class", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--gammatone-method", type=str, default="iir",
                   choices=["iir", "iir-xla", "fft"],
                   help="Gammatone spectrogram: iir and iir-xla the exact cascade "
                        "(kernel B1 on the card; two TPU implementations in lsm_tpu), "
                        "fft the FFT-weighted approximation.")
    p.add_argument("--num-neurons", type=int, default=1000)
    p.add_argument("--num-output-neurons", type=int, default=400)
    p.add_argument("--sparse", dest="sparse", action="store_true", default=None,
                   help="Force the block-sparse reservoir (default: automatic for "
                        ">=4096 neurons with N %% 128 == 0; requires N %% 128 == 0).")
    p.add_argument("--dense", dest="sparse", action="store_false",
                   help="Force the dense reservoir representation.")
    p.add_argument("--redundancy-factor", type=int, default=1,
                   help="Duplicate each filter channel R times before the reservoir.")
    add_single_device_flag(p)
    p.add_argument("--check", action="store_true",
                   help="Debug sanitizer mode: validate each stage boundary on the device "
                        "(finite audio and spectrogram, 0/1 spikes before any pack, finite "
                        "non-constant features) and fail loudly instead of encoding garbage. "
                        "Costs a device sync per check.")
    add_metrics_flag(p)
    add_audio_wire_flag(p)
    add_device_flag(p)


def add_single_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--single-device", action="store_true",
                   help="Run every stage on one device (lsm_tpu's flag; the port always "
                        "does).")


def add_metrics_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--metrics-out", type=str, default=None,
                   help="Append structured JSONL metric records (per-stage rates, "
                        "w_critico, regime, accuracy) to this file.")


def metrics_from_args(args: argparse.Namespace):
    """MetricLogger for --metrics-out (None when the flag is unset)."""
    path = getattr(args, "metrics_out", None)
    if not path:
        return None
    from lsm_tpu_torch.utils.logging import MetricLogger

    return MetricLogger(path=path)


def emit_extraction_metrics(metrics, ext, cfg: PipelineConfig, n: int, seconds: float) -> None:
    """Stage 2's records, as lsm_tpu's main.py and extract_lsm_features.py
    emit them: the wall and rate, w_critico, the mean weight and the
    regime."""
    metrics.emit("stage2_wall_s", round(seconds, 3), stage="extract_features",
                 utterances=n, utt_per_sec=round(n / max(seconds, 1e-9), 1))
    metrics.emit("w_critico", ext.w_critico, stage="extract_features")
    metrics.emit("mean_weight", ext.mean_weight, stage="extract_features",
                 multiplier=cfg.multiplier)
    if ext.diagnostics is not None:
        metrics.emit("regime", ext.diagnostics.regime, stage="extract_features",
                     avg_participation=round(ext.diagnostics.avg_participation, 2))


def emit_training_metrics(metrics, result, cfg: PipelineConfig, seconds: float) -> None:
    """Stage 3's records, as lsm_tpu's main.py and train_classifier.py emit
    them."""
    metrics.emit("stage3_wall_s", round(seconds, 3), stage="train_classifier",
                 lbfgs_iters=result.n_iters)
    metrics.emit("test_accuracy", result.accuracy, stage="train_classifier",
                 feature_set=cfg.feature_set)


def resolve_commands(args: argparse.Namespace):
    """The keyword vocabulary implied by the flags: --commands (at least two
    distinct comma-separated words) wins over --vocab; the default is the
    reference's 12."""
    raw = getattr(args, "commands", None)
    if raw:
        commands = tuple(w.strip() for w in raw.split(",") if w.strip())
        if len(commands) < 2:
            raise SystemExit(f"--commands needs at least 2 comma-separated words, got {raw!r}")
        if len(set(commands)) != len(commands):
            raise SystemExit(f"--commands has duplicate words: {raw!r}")
        return commands
    return COMMANDS_35 if getattr(args, "vocab", "v12") == "v35" else COMMANDS_12


def build_config(args: argparse.Namespace) -> PipelineConfig:
    """The pipeline config the flags describe (lsm_tpu's `build_config`
    over the fields the port keeps)."""
    n_neurons = getattr(args, "num_neurons", 1000)
    return PipelineConfig(
        frontend=FrontendConfig(
            n_filters=getattr(args, "n_filters", 128),
            filterbank=getattr(args, "filterbank", "gammatone"),
            gammatone_method=getattr(args, "gammatone_method", "iir"),
            redundancy_factor=getattr(args, "redundancy_factor", 1),
        ),
        reservoir=ReservoirConfig(
            num_neurons=n_neurons,
            num_output_neurons=getattr(args, "num_output_neurons", 400),
            small_world_k=int(0.10 * n_neurons * 2),
            leak_variance_divisor=getattr(args, "leak_variance_divisor", None),
            sparse=getattr(args, "sparse", None),
        ),
        feature_set=getattr(args, "feature_set", "original"),
        multiplier=getattr(args, "multiplier", 0.6),
        max_samples_per_class=getattr(args, "samples_per_class", 1000),
        commands=resolve_commands(args),
        batch_size=getattr(args, "batch_size", 512),
        check=getattr(args, "check", False),
        audio_wire=getattr(args, "audio_wire", "int16"),
    )


def synthetic_n_per(args: argparse.Namespace) -> int:
    """--samples-per-class under --synthetic, capped at 200 as lsm_tpu caps it."""
    n_per = min(args.samples_per_class, 200)
    if n_per < args.samples_per_class:
        print(f"note: --synthetic caps --samples-per-class at 200 "
              f"(requested {args.samples_per_class}) — the synthetic "
              "corpus is a smoke/bench fixture, not a dataset.")
    return n_per
