"""Stage 1: audio -> spike-train dataset (the port's counterpart of the
repo-root create_dataset.py: the same flags, artifact and --metrics-out
records, plus --device).

    python -m lsm_tpu_torch.cli.create_dataset --data-dir <tree> [--sharded-output DIR]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from lsm_tpu_torch.cli.common import (
    add_extension_flags, add_frontend_flags, build_config, metrics_from_args, setup_logging,
    synthetic_n_per,
)
from lsm_tpu_torch.config import corpus_meta
from lsm_tpu_torch.io import artifacts, dataset
from lsm_tpu_torch.io.sharded import ShardedSpikeDataset, ShardedSpikeDatasetWriter


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.cli.create_dataset",
                                description="Create a spike train dataset from audio files.")
    add_frontend_flags(p)
    add_extension_flags(p)
    p.add_argument("--output", type=str, default=artifacts.SPIKE_DATASET_FILENAME)
    p.add_argument("--sharded-output", type=str, default=None,
                   help="Write an incrementally sharded dataset directory instead of "
                        "one .npz (for 100k+ utterances).")
    p.add_argument("--shard-size", type=int, default=8192)
    p.add_argument("--no-compress", action="store_true",
                   help="Write sharded output uncompressed (~190x the disk, reads "
                        "without decompression).")
    args = p.parse_args(argv)
    setup_logging()

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.pipeline import create_spike_dataset, featurize_audio_array

    device = resolve_device(args.device)
    cfg = build_config(args)
    metrics = metrics_from_args(args)
    t0 = time.perf_counter()
    print(f"Creating dataset with filterbank: {cfg.frontend.filterbank}, "
          f"filters: {cfg.frontend.n_filters}")
    sharded = Path(args.sharded_output) if args.sharded_output else None
    if args.synthetic:
        audio, labels = dataset.synthetic_audio_batch(n_per_class=synthetic_n_per(args),
                                                      n_classes=len(cfg.commands))
        ds = artifacts.SpikeDataset(featurize_audio_array(cfg, audio, device), labels)
        if sharded is not None:
            # One write, no resume: a synthetic corpus has no file list to
            # fingerprint. The same metadata as the WAV route.
            writer = ShardedSpikeDatasetWriter(sharded, args.shard_size,
                                               compress=not args.no_compress,
                                               meta=corpus_meta(cfg))
            writer.append(np.asarray(ds.x_spikes), np.asarray(ds.y_labels))
            writer.close()
            ds = ShardedSpikeDataset(sharded)
        else:
            artifacts.save_spike_dataset(Path(args.output), ds)
    else:
        ds = create_spike_dataset(
            cfg, Path(args.data_dir), device,
            output_path=None if sharded else Path(args.output),
            sharded_output=sharded, shard_size=args.shard_size,
            compress=not args.no_compress,
        )

    print("\nDataset created successfully.")
    if sharded is not None:
        # The journal's stats: a summary line must not load the corpus.
        n, spike_total = ds.num_samples, ds.total_spikes
        print(f"  Shape: {(n,) + (ds.row_shape or ())}")
    else:
        n, spike_total = len(ds.x_spikes), int(ds.x_spikes.sum())
        print(f"  Shape: {ds.x_spikes.shape}")
    if spike_total is not None:
        print(f"  Avg spikes per sample: {spike_total / max(n, 1):.1f}")
    print(f"Saved to '{sharded if sharded is not None else args.output}'")
    if metrics:
        dt = time.perf_counter() - t0
        # A resumed sharded run counts the whole corpus in n; its rate
        # divides only what this run featurized.
        n_run = getattr(ds, "featurized_this_run", n)
        metrics.emit("stage1_wall_s", round(dt, 3), stage="create_dataset", utterances=n,
                     utt_per_sec=round(n_run / max(dt, 1e-9), 1),
                     filterbank=cfg.frontend.filterbank)
        if spike_total is not None:
            metrics.emit("avg_spikes_per_sample", round(spike_total / max(n, 1), 2),
                         stage="create_dataset")
        metrics.close()


if __name__ == "__main__":
    main()
