"""`python -m lsm_tpu_torch`: the full pipeline on one device, the port's
counterpart of the repo-root main.py.

main.py's flags (cli/common.py), plus --device (default cuda; no silent
CPU fallback) and --hard (the frozen hard synthetic corpus). Without
--synthetic it featurizes the WAV tree under --data-dir
(pipeline.create_spike_dataset); with --synthetic the corpus has one class
per resolved command. Writes the same two .npz artifacts, prints the same
sections and report, with --metrics-out appends main.py's metric records,
and with --save-model writes the model bundle (io/model.py) that
`python -m lsm_tpu_torch.cli.classify` reads.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from lsm_tpu_torch.cli.common import (
    add_extension_flags, add_extract_flags, add_frontend_flags, build_config,
    emit_extraction_metrics, emit_training_metrics, metrics_from_args, resolve_commands,
    setup_logging, synthetic_n_per,
)
from lsm_tpu_torch.io import artifacts, dataset

__all__ = ["build_config", "main", "parse_args", "resolve_commands"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m lsm_tpu_torch",
        description="Run the entire speech recognition pipeline (PyTorch/CUDA port).",
    )
    add_frontend_flags(p)
    add_extract_flags(p)
    add_extension_flags(p)
    p.add_argument("--hard", action="store_true",
                   help="With --synthetic: the frozen hard benchmark corpus "
                        "(synthetic_audio_batch_hard) instead of the easy one.")
    p.add_argument("--skip-artifacts", action="store_true",
                   help="Skip writing intermediate .npz artifacts.")
    p.add_argument("--save-model", type=str, default=None,
                   help="Persist the trained model (reservoir + scaler + readout + "
                        "frontend config) for lsm_tpu_torch.cli.classify.")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logging()

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.pipeline import (
        create_spike_dataset, extract_lsm_features, featurize_audio_array, train_and_evaluate,
    )

    device = resolve_device(args.device)
    cfg = build_config(args)
    metrics = metrics_from_args(args)

    print("--- Running Pipeline ---")
    print("\n--- Step 1: Creating Spike Train Dataset ---")
    t0 = time.perf_counter()
    spike_path = None if args.skip_artifacts else Path(artifacts.SPIKE_DATASET_FILENAME)
    if args.synthetic:
        make = dataset.synthetic_audio_batch_hard if args.hard else dataset.synthetic_audio_batch
        audio, labels = make(n_per_class=synthetic_n_per(args), n_classes=len(cfg.commands))
        ds = artifacts.SpikeDataset(x_spikes=featurize_audio_array(cfg, audio, device),
                                    y_labels=labels)
        if spike_path is not None:
            artifacts.save_spike_dataset(spike_path, ds)
    else:
        ds = create_spike_dataset(cfg, Path(args.data_dir), device, output_path=spike_path)
    print(f"  Shape: {ds.x_spikes.shape}")
    n = len(ds.x_spikes)
    if metrics:
        dt = time.perf_counter() - t0
        metrics.emit("stage1_wall_s", round(dt, 3), stage="create_dataset",
                     utterances=n, utt_per_sec=round(n / max(dt, 1e-9), 1))
        metrics.emit("avg_spikes_per_sample",
                     round(float(ds.x_spikes.sum()) / max(n, 1), 2), stage="create_dataset")

    print("\n--- Step 2: Extracting LSM Features ---")
    t0 = time.perf_counter()
    feat_path = None if args.skip_artifacts else Path(artifacts.FEATURES_FILENAME)
    ext = extract_lsm_features(cfg, ds, device, output_path=feat_path)
    if metrics:
        dt = time.perf_counter() - t0
        emit_extraction_metrics(metrics, ext, cfg, n, dt)

    print("\n--- Step 3: Training and Evaluating Classifier ---")
    t0 = time.perf_counter()
    result = train_and_evaluate(cfg, ext.artifact, device)
    if metrics:
        emit_training_metrics(metrics, result, cfg, time.perf_counter() - t0)
    print("\n--- Final Results ---")
    print(f"Test Accuracy: {result.accuracy * 100:.2f}%\n")
    print("Classification Report:")
    print(result.report.render())

    if args.save_model:
        from lsm_tpu_torch.io.model import save_model

        save_model(Path(args.save_model), reservoir=ext.reservoir, readout=result.readout,
                   scaler=ext.scaler, frontend=cfg.frontend, feature_set=cfg.feature_set,
                   class_names=cfg.commands)
        print(f"Model saved to '{args.save_model}'")
    if metrics:
        metrics.close()
    print("\n--- Pipeline Finished ---")


if __name__ == "__main__":
    main()
