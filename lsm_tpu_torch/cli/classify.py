"""Standalone inference with a saved model bundle (the port's counterpart
of the repo-root classify.py, plus --device): score a Speech Commands-style
WAV tree (--data-dir), a classic spike .npz or a sharded spike directory
(--input), write predictions.npz and print the counts and, where labels
exist, the accuracy.

    python -m lsm_tpu_torch.cli.classify --model lsm_model.npz --data-dir <tree>
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from lsm_tpu_torch.cli.common import (
    add_audio_wire_flag, add_device_flag, add_single_device_flag, setup_logging,
)
from lsm_tpu_torch.config import PipelineConfig, ReservoirConfig
from lsm_tpu_torch.io import artifacts
from lsm_tpu_torch.io.model import MODEL_FILENAME


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.cli.classify",
                                description="Classify utterances with a saved LSM model.")
    p.add_argument("--model", type=str, default=MODEL_FILENAME)
    p.add_argument("--data-dir", type=str, default=None,
                   help="Speech Commands-style WAV directory to classify.")
    p.add_argument("--input", type=str, default=None,
                   help="Spike dataset: classic .npz or sharded dir.")
    p.add_argument("--output", type=str, default="predictions.npz")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--samples-per-class", type=int, default=0,
                   help="Cap WAVs per class dir under --data-dir (0 = no cap, the "
                        "default: inference scores every file).")
    add_single_device_flag(p)
    add_audio_wire_flag(p)
    add_device_flag(p)
    args = p.parse_args(argv)
    setup_logging()

    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io.model import load_model
    from lsm_tpu_torch.io.sharded import ShardedSpikeDataset

    device = resolve_device(args.device)
    try:
        bundle = load_model(Path(args.model), device)
    except FileNotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)
    if bundle.feature_mode != "batch":
        print("Error: this bundle is calibrated for continuous-mode streaming "
              "features; batch classification would mismatch its readout. "
              "Serve it with python -m lsm_tpu_torch.cli.stream_kws --mode "
              "continuous, or use the original batch bundle.", file=sys.stderr)
        sys.exit(1)
    cfg = PipelineConfig(
        frontend=bundle.frontend,
        reservoir=ReservoirConfig(num_neurons=bundle.reservoir.n_neurons,
                                  num_output_neurons=bundle.reservoir.n_outputs),
        feature_set=bundle.feature_set,
        commands=bundle.class_names,
        batch_size=args.batch_size,
        audio_wire=args.audio_wire,
        max_samples_per_class=args.samples_per_class or 1_000_000_000,
    )

    if args.data_dir is not None:
        ds = pipeline.create_spike_dataset(cfg, Path(args.data_dir), device)
        source = pipeline.InMemorySource(ds)
    elif args.input is not None:
        path = Path(args.input)
        source = (ShardedSpikeDataset(path) if path.is_dir()
                  else pipeline.InMemorySource(artifacts.load_spike_dataset(path)))
    else:
        print("Error: provide --data-dir or --input.", file=sys.stderr)
        sys.exit(1)

    preds, labels = pipeline.classify_spikes_streaming(
        cfg, source, bundle.reservoir, bundle.readout, bundle.scaler, device)
    np.savez_compressed(Path(args.output), predictions=preds.astype(np.int32),
                        labels=labels.astype(np.int32),
                        class_names=np.asarray(bundle.class_names))
    print(f"Classified {len(preds)} utterances -> '{args.output}'")
    counts = np.bincount(preds, minlength=len(bundle.class_names))
    for name, c in zip(bundle.class_names, counts):
        print(f"  {name:>10s}: {c}")
    if labels.size and labels.max() >= 0:
        print(f"Accuracy vs provided labels: {float((preds == labels).mean()) * 100:.2f}%")


if __name__ == "__main__":
    main()
