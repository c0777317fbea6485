"""Stage 2: spike dataset -> standardized LSM features (the port's
counterpart of the repo-root extract_lsm_features.py: the same flags,
artifacts and --metrics-out records, plus --device).

    python -m lsm_tpu_torch.cli.extract_lsm_features --input <.npz or shard dir>

With --streaming-fit it runs the fused stage 2+3 over a sharded corpus
with flat host memory (pipeline.extract_and_train_streaming) and writes a
model bundle with --save-model instead of a features artifact:

    python -m lsm_tpu_torch.cli.extract_lsm_features --input <shard dir> \
        --streaming-fit [--readout ridge|logistic] [--ridge-alpha A] \
        [--l2-c C] --save-model m.npz
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from lsm_tpu_torch.cli.common import (
    add_extension_flags, add_extract_flags, build_config, emit_extraction_metrics,
    metrics_from_args, resolve_commands, setup_logging,
)
from lsm_tpu_torch.io import artifacts


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m lsm_tpu_torch.cli.extract_lsm_features",
        description="Extract features from a spike train dataset using an LSM.")
    add_extract_flags(p)
    add_extension_flags(p)
    p.add_argument("--input", type=str, default=artifacts.SPIKE_DATASET_FILENAME,
                   help="A spike dataset: a classic .npz or a sharded directory.")
    p.add_argument("--output", type=str, default=artifacts.FEATURES_FILENAME)
    p.add_argument("--streaming-fit", action="store_true",
                   help="Constant-memory fused stage 2+3 over a sharded spike dataset "
                        "directory: train batches fold into ridge statistics on the "
                        "device, test rows stream through the solved readout; host "
                        "memory stays flat at any corpus scale. Writes a model bundle "
                        "with --save-model instead of a features artifact.")
    p.add_argument("--ridge-alpha", type=float, default=1.0,
                   help="L2 strength of the --streaming-fit ridge.")
    p.add_argument("--readout", type=str, default="ridge", choices=["ridge", "logistic"],
                   help="With --streaming-fit: 'ridge', the closed form on O(D^2) "
                        "statistics; 'logistic', the reference readout (multinomial "
                        "L-BFGS) on the train features held in device memory.")
    p.add_argument("--l2-c", type=float, default=1.0,
                   help="With --readout logistic: inverse L2 strength C.")
    p.add_argument("--save-model", type=str, default=None,
                   help="With --streaming-fit: save the trained model bundle "
                        "(reservoir + scaler + readout) here.")
    args = p.parse_args(argv)
    setup_logging()

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.pipeline import extract_lsm_features, load_spike_dataset_any

    device = resolve_device(args.device)
    cfg = build_config(args)
    if args.streaming_fit:
        _run_streaming_fit(args, cfg, device)
        return
    try:
        ds = load_spike_dataset_any(Path(args.input))
    except FileNotFoundError as e:
        print(f"Error: {e}")
        return
    print(f"Loaded {len(ds.x_spikes)} samples from '{args.input}'")
    metrics = metrics_from_args(args)
    t0 = time.perf_counter()
    ext = extract_lsm_features(cfg, ds, device, output_path=Path(args.output))
    print(f"Extraction complete. Features saved to '{args.output}'")
    if metrics:
        emit_extraction_metrics(metrics, ext, cfg, len(ds.x_spikes), time.perf_counter() - t0)
        metrics.close()


def _run_streaming_fit(args, cfg, device) -> None:
    from lsm_tpu_torch.config import frontend_from_dict
    from lsm_tpu_torch.io.model import save_model
    from lsm_tpu_torch.io.sharded import ShardedSpikeDataset
    from lsm_tpu_torch.pipeline import extract_and_train_streaming

    root = Path(args.input)
    if not root.is_dir():
        raise SystemExit(
            "--streaming-fit requires a sharded spike dataset directory "
            f"(create_dataset.py --sharded-output ...); got '{root}'. A .npz "
            "artifact is already in memory — use the default path."
        )
    source = ShardedSpikeDataset(root)
    print(f"Streaming {source.num_samples} samples from '{root}'")
    # The corpus records the vocabulary and the featurization it was built
    # with: labels index that vocabulary, and the bundle must carry the
    # frontend the spikes came from. An explicit --commands still wins (the
    # trainer then checks the label range against it).
    frontend, meta = cfg.frontend, source.meta
    if args.commands:
        names = resolve_commands(args)
    elif meta.get("class_names"):
        names = tuple(meta["class_names"])
        print(f"Vocabulary from corpus metadata: {len(names)} classes")
    else:
        names = resolve_commands(args)
    if meta.get("frontend"):
        frontend = frontend_from_dict(meta["frontend"])
        if frontend != cfg.frontend:
            print(f"Frontend from corpus metadata: {frontend.filterbank}/"
                  f"{frontend.n_filters} filters")
    else:
        print("WARNING: corpus has no frontend metadata (written by an older "
              "create_dataset.py); the saved bundle will record the default "
              f"{frontend.filterbank}/{frontend.n_filters} frontend.")
    metrics = metrics_from_args(args)
    t0 = time.perf_counter()
    result = extract_and_train_streaming(
        cfg, source, device, class_names=names, alpha=args.ridge_alpha,
        readout=args.readout, l2_c=args.l2_c,
    )
    print("\n--- Final Results ---")
    print(f"Test Accuracy: {result.accuracy * 100:.2f}%\n")
    print("Classification Report:")
    print(result.report.render())
    if args.save_model:
        save_model(Path(args.save_model), result.reservoir, result.readout, result.scaler,
                   frontend, cfg.feature_set, names)
        print(f"Model bundle saved to '{args.save_model}'")
    if metrics:
        dt = time.perf_counter() - t0
        n = result.n_train + result.n_test
        metrics.emit("streaming_fit_wall_s", round(dt, 3), stage="extract_features",
                     utterances=n, utt_per_sec=round(n / max(dt, 1e-9), 1))
        metrics.emit("w_critico", result.w_critico, stage="extract_features")
        metrics.emit("test_accuracy", result.accuracy, stage="extract_features",
                     readout=args.readout, ridge_alpha=args.ridge_alpha)
        metrics.close()


if __name__ == "__main__":
    main()
