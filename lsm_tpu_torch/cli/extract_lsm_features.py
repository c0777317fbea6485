"""Stage 2: spike dataset -> standardized LSM features (the port's
counterpart of the repo-root extract_lsm_features.py: the same flags and
artifacts, plus --device; --streaming-fit, --ridge-alpha and --readout wait
for ROADMAP A13).

    python -m lsm_tpu_torch.cli.extract_lsm_features --input <.npz or shard dir>
"""

from __future__ import annotations

import argparse
from pathlib import Path

from lsm_tpu_torch.cli.common import (
    add_extension_flags, add_extract_flags, build_config, refuse_unported, setup_logging,
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
                   help="Constant-memory fused stage 2+3 (not ported yet).")
    p.add_argument("--ridge-alpha", type=float, default=None,
                   help="With --streaming-fit (not ported yet).")
    p.add_argument("--readout", type=str, default=None, choices=["ridge", "logistic"],
                   help="With --streaming-fit (not ported yet).")
    args = p.parse_args(argv)
    refuse_unported(args)
    setup_logging()

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.pipeline import extract_lsm_features, load_spike_dataset_any

    device = resolve_device(args.device)
    cfg = build_config(args)
    try:
        ds = load_spike_dataset_any(Path(args.input))
    except FileNotFoundError as e:
        print(f"Error: {e}")
        return
    print(f"Loaded {len(ds.x_spikes)} samples from '{args.input}'")
    extract_lsm_features(cfg, ds, device, output_path=Path(args.output))
    print(f"Extraction complete. Features saved to '{args.output}'")


if __name__ == "__main__":
    main()
