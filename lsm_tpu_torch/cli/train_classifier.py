"""Stage 3: features -> trained readout and evaluation report (the port's
counterpart of the repo-root train_classifier.py, its --metrics-out records
included, plus --device).

    python -m lsm_tpu_torch.cli.train_classifier --input lsm_features_larger.npz
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from lsm_tpu_torch.cli.common import (
    add_device_flag, add_metrics_flag, add_single_device_flag, add_vocab_flags, build_config,
    emit_training_metrics, mesh_from_args, metrics_from_args, resolve_commands, setup_logging,
)
from lsm_tpu_torch.io import artifacts


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.cli.train_classifier",
                                description="Train and evaluate the readout classifier.")
    p.add_argument("--input", type=str, default=artifacts.FEATURES_FILENAME)
    add_vocab_flags(p)
    add_metrics_flag(p)
    add_single_device_flag(p)
    add_device_flag(p)
    args = p.parse_args(argv)
    setup_logging()

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.pipeline import train_and_evaluate

    device = resolve_device(args.device)
    try:
        art = artifacts.load_features(Path(args.input))
    except FileNotFoundError:
        print("Error: Dataset file not found. "
              "Please run 'extract_lsm_features.py' first.")
        return
    print(f"Loaded {len(art.x_train)} training and {len(art.x_test)} test samples.")
    print("Training the Logistic Regression classifier...")
    names = resolve_commands(args)
    n_classes = int(max(art.y_train.max(), art.y_test.max())) + 1
    if n_classes > len(names):
        # The artifact carries no class names: a smaller vocabulary would
        # train one-hot targets that zero every out-of-range label.
        print(f"Error: the feature artifact has {n_classes} classes but the CLI "
              f"vocabulary has {len(names)} names — re-run with the --vocab/--commands "
              "the features were built with.", file=sys.stderr)
        sys.exit(1)
    cfg = build_config(args)
    metrics = metrics_from_args(args)
    t0 = time.perf_counter()
    result = train_and_evaluate(cfg, art, device, class_names=names[:n_classes],
                                mesh=mesh_from_args(args))
    print("Training complete.")
    print("Evaluating performance on the test set...")
    print("\n--- Final Results ---")
    print(f"Test Accuracy: {result.accuracy * 100:.2f}%\n")
    print("Classification Report:")
    print(result.report.render())
    if metrics:
        emit_training_metrics(metrics, result, cfg, time.perf_counter() - t0)
        metrics.close()


if __name__ == "__main__":
    main()
