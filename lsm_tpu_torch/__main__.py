"""`python -m lsm_tpu_torch`: the full pipeline on one device, the port's
counterpart of the repo-root main.py.

Same flags as main.py where the slice covers them (--n-filters
--filterbank --feature-set --multiplier --leak-variance-divisor --vocab
--commands --synthetic --samples-per-class --batch-size --redundancy-factor
--skip-artifacts --num-neurons --num-output-neurons --sparse/--dense), plus
--device (default cuda; no silent CPU fallback) and --hard (the frozen hard
synthetic corpus). With --synthetic the corpus has one class per resolved
command. Writes the same two .npz artifacts and prints the same sections
and report.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from lsm_tpu_torch.config import (
    COMMANDS_12, COMMANDS_35, FEATURE_SETS, FrontendConfig, PipelineConfig, ReservoirConfig,
)
from lsm_tpu_torch.io import artifacts, dataset


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m lsm_tpu_torch",
        description="Run the entire speech recognition pipeline (PyTorch/CUDA port).",
    )
    p.add_argument("--n-filters", type=int, default=128,
                   help="Number of filters for the filterbank.")
    p.add_argument("--filterbank", type=str, default="gammatone",
                   choices=["mel", "gammatone"],
                   help="Type of filterbank to use (mel is not ported yet).")
    p.add_argument("--feature-set", type=str, default="original",
                   choices=list(FEATURE_SETS.keys()))
    p.add_argument("--multiplier", type=float, default=0.6)
    p.add_argument("--leak-variance-divisor", type=float, default=None)
    p.add_argument("--vocab", type=str, default="v12", choices=["v12", "v35"],
                   help="12-command reference vocabulary or full 35-class set.")
    p.add_argument("--commands", type=str, default=None,
                   help="Comma-separated keyword subset (e.g. 'yes,no,up,down'); "
                        "overrides --vocab. Class index = position in the list.")
    p.add_argument("--synthetic", action="store_true",
                   help="Use a synthetic corpus (no dataset on disk needed).")
    p.add_argument("--hard", action="store_true",
                   help="With --synthetic: the frozen hard benchmark corpus "
                        "(synthetic_audio_batch_hard) instead of the easy one.")
    p.add_argument("--samples-per-class", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--num-neurons", type=int, default=1000)
    p.add_argument("--num-output-neurons", type=int, default=400)
    p.add_argument("--redundancy-factor", type=int, default=1,
                   help="Duplicate each filter channel R times before the reservoir.")
    p.add_argument("--sparse", dest="sparse", action="store_true", default=None,
                   help="Force the block-sparse reservoir (default: automatic for "
                        ">=4096 neurons with N %% 128 == 0; requires N %% 128 == 0).")
    p.add_argument("--dense", dest="sparse", action="store_false",
                   help="Force the dense reservoir representation.")
    p.add_argument("--skip-artifacts", action="store_true",
                   help="Skip writing intermediate .npz artifacts.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu.")
    return p.parse_args(argv)


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
    return PipelineConfig(
        frontend=FrontendConfig(n_filters=args.n_filters, filterbank=args.filterbank,
                                redundancy_factor=args.redundancy_factor),
        reservoir=ReservoirConfig(
            num_neurons=args.num_neurons,
            num_output_neurons=args.num_output_neurons,
            small_world_k=int(0.10 * args.num_neurons * 2),
            leak_variance_divisor=args.leak_variance_divisor,
            sparse=args.sparse,
        ),
        feature_set=args.feature_set,
        multiplier=args.multiplier,
        max_samples_per_class=args.samples_per_class,
        commands=resolve_commands(args),
        batch_size=args.batch_size,
    )


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout, force=True)
    if not args.synthetic:
        raise SystemExit(
            "the port reads no WAV corpus yet (ROADMAP A7); pass --synthetic"
        )

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.pipeline import (
        extract_lsm_features, featurize_audio_array, train_and_evaluate,
    )

    device = resolve_device(args.device)
    cfg = build_config(args)

    print("--- Running Pipeline ---")
    print("\n--- Step 1: Creating Spike Train Dataset ---")
    n_per = min(args.samples_per_class, 200)
    if n_per < args.samples_per_class:
        print(f"note: --synthetic caps --samples-per-class at 200 "
              f"(requested {args.samples_per_class}) — the synthetic "
              "corpus is a smoke/bench fixture, not a dataset.")
    make = dataset.synthetic_audio_batch_hard if args.hard else dataset.synthetic_audio_batch
    audio, labels = make(n_per_class=n_per, n_classes=len(cfg.commands))
    spikes = featurize_audio_array(cfg, audio, device)
    ds = artifacts.SpikeDataset(x_spikes=spikes, y_labels=labels)
    if not args.skip_artifacts:
        artifacts.save_spike_dataset(Path(artifacts.SPIKE_DATASET_FILENAME), ds)
    print(f"  Shape: {ds.x_spikes.shape}")

    print("\n--- Step 2: Extracting LSM Features ---")
    feat_path = None if args.skip_artifacts else Path(artifacts.FEATURES_FILENAME)
    ext = extract_lsm_features(cfg, ds, device, output_path=feat_path)

    print("\n--- Step 3: Training and Evaluating Classifier ---")
    result = train_and_evaluate(cfg, ext.artifact, device)
    print("\n--- Final Results ---")
    print(f"Test Accuracy: {result.accuracy * 100:.2f}%\n")
    print("Classification Report:")
    print(result.report.render())
    print("\n--- Pipeline Finished ---")


if __name__ == "__main__":
    main()
