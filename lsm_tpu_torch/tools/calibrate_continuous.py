"""Re-calibrate a trained model bundle for continuous-mode serving (the
port's counterpart of tools/calibrate_continuous.py, plus --device).

Streams the training audio through ContinuousKWS in the carried-state
condition, refits the scaler and the logistic readout on those features
(`models.continuous.fit_continuous_readout`) and writes a new bundle
tagged feature_mode="continuous", the one `cli.stream_kws --mode
continuous` expects. The reservoir and frontend are reused unchanged, so
the original bundle still serves batch and exact mode. lsm_tpu reads the
bundle too.

    python -m lsm_tpu_torch.tools.calibrate_continuous --model lsm_model.npz \
        --out lsm_model_continuous.npz --data-dir speech_commands_v0.02
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.tools.calibrate_continuous")
    ap.add_argument("--model", type=str, required=True,
                    help="Input bundle (python -m lsm_tpu_torch --save-model).")
    ap.add_argument("--out", type=str, required=True,
                    help="Output bundle (feature_mode=continuous).")
    ap.add_argument("--data-dir", type=str, default=None,
                    help="Speech Commands-style training WAV directory (class subdirs "
                         "must match the bundle's class names).")
    ap.add_argument("--synthetic", action="store_true",
                    help="Calibrate on the synthetic corpus instead (no dataset on disk "
                         "needed).")
    ap.add_argument("--samples-per-class", type=int, default=200)
    ap.add_argument("--chunk-ms", type=int, default=100)
    ap.add_argument("--norm-decay-db-per-bin", type=float, default=0.1)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu.")
    args = ap.parse_args(argv)

    from lsm_tpu_torch.cli.common import setup_logging

    setup_logging()

    import numpy as np

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io import dataset
    from lsm_tpu_torch.io.model import load_model, save_model
    from lsm_tpu_torch.io.wav import load_audio_batch
    from lsm_tpu_torch.models.continuous import fit_continuous_readout

    device = resolve_device(args.device)
    bundle = load_model(Path(args.model), device)
    fcfg = bundle.frontend
    chunk_len = fcfg.sample_rate * args.chunk_ms // 1000

    if args.synthetic:
        audio, labels = dataset.synthetic_audio_batch(
            n_per_class=args.samples_per_class, n_classes=len(bundle.class_names),
            seed=42, sample_rate=fcfg.sample_rate, duration=fcfg.duration)
    elif args.data_dir is not None:
        idx = dataset.index_speech_commands(Path(args.data_dir), bundle.class_names,
                                            args.samples_per_class)
        for w in idx.warnings:
            print(w, file=sys.stderr)
        if not idx.files:
            print("Error: no audio files found.", file=sys.stderr)
            sys.exit(1)
        audio, kept, errors = load_audio_batch(idx.files, fcfg.sample_rate, fcfg.duration)
        for path, err in errors:
            print(f"Error loading {path}: {err}", file=sys.stderr)
        labels = idx.labels[kept]
    else:
        print("Error: provide --data-dir or --synthetic.", file=sys.stderr)
        sys.exit(1)

    print(f"Calibrating on {audio.shape[0]} utterances "
          f"({args.chunk_ms} ms chunks, carried-state protocol) ...")
    readout, sc = fit_continuous_readout(
        bundle.reservoir, fcfg, audio, np.asarray(labels, np.int32),
        num_classes=len(bundle.class_names), feature_set=bundle.feature_set,
        chunk_len=chunk_len, norm_decay_db_per_bin=args.norm_decay_db_per_bin)
    save_model(Path(args.out), bundle.reservoir, readout, sc, fcfg, bundle.feature_set,
               bundle.class_names, feature_mode="continuous",
               # Serving must reuse exactly these (cli.stream_kws reads them).
               continuous_params={"chunk_len": chunk_len,
                                  "norm_decay_db_per_bin": args.norm_decay_db_per_bin})
    print(f"Continuous-calibrated bundle written to '{args.out}'")


if __name__ == "__main__":
    main()
