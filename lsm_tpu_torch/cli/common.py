"""Flags and config assembly shared by the port's entry points (the
counterpart of lsm_tpu/cli/common.py).

The flag names and defaults are the reference scripts'. The port adds
--device (cuda by default; no silent CPU fallback). Flags whose feature is
not ported yet are taken and then refused with SystemExit naming the
ROADMAP item that ports it (`refuse_unported`).
"""

from __future__ import annotations

import argparse
import logging
import sys

from lsm_tpu_torch.config import (
    COMMANDS_12, COMMANDS_35, FEATURE_SETS, FrontendConfig, PipelineConfig, ReservoirConfig,
)

# (attribute, value that means "not given", flag, ROADMAP item)
_UNPORTED = (
    ("filterbank", "gammatone", "--filterbank mel", "A8"),
    ("gammatone_method", "iir", "--gammatone-method other than iir", "A8"),
    ("single_device", False, "--single-device", "A14"),
    ("check", False, "--check", "A15"),
    ("metrics_out", None, "--metrics-out", "A15"),
    ("streaming_fit", False, "--streaming-fit", "A13"),
    ("ridge_alpha", None, "--ridge-alpha", "A13"),
    ("readout", None, "--readout", "A13"),
)


def setup_logging() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout, force=True)


def add_frontend_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n-filters", type=int, default=128,
                   help="Number of filters for the filterbank.")
    p.add_argument("--filterbank", type=str, default="gammatone",
                   choices=["mel", "gammatone"],
                   help="Type of filterbank to use (mel is not ported yet).")


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
                   help="Only iir (the exact cascade) is ported.")
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
                   help="Debug sanitizer mode (not ported yet).")
    add_metrics_flag(p)
    add_audio_wire_flag(p)
    add_device_flag(p)


def add_single_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--single-device", action="store_true",
                   help="The port runs on one device; multi-device is not ported yet.")


def add_metrics_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--metrics-out", type=str, default=None,
                   help="Structured JSONL metric records (not ported yet).")


def refuse_unported(args: argparse.Namespace) -> None:
    """SystemExit naming the ROADMAP item of the first flag given whose
    feature the port does not have yet."""
    for attr, unset, flag, item in _UNPORTED:
        if getattr(args, attr, unset) != unset:
            raise SystemExit(f"{flag} is not ported to lsm_tpu_torch yet (ROADMAP {item})")


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
