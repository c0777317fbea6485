"""Sensitivity of accuracy to the inferred reservoir semantics (the port's
counterpart of tools/sensitivity.py, plus --device).

Runs the pipeline on the frozen hard corpus (synthetic_audio_batch_hard,
12 classes, seed 42) at the reference defaults and at each perturbation of
an inferred choice (rate windows, burst ISI, input projection, weight
variance, the multiplier, heterogeneous leak), and prints accuracy, its
change from the baseline, regime and participation (docs/SENSITIVITY.md
records lsm_tpu's table).

    python -m lsm_tpu_torch.tools.sensitivity [--n-per-class 100]
        [--feature-set all] [--markdown] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

# (row label, ReservoirConfig overrides, PipelineConfig overrides), in
# lsm_tpu's order; the first row is the baseline.
PERTURBATIONS = (
    ("baseline (reference defaults)", {}, {}),
    ("n_rate_windows=2", dict(n_rate_windows=2), {}),
    ("n_rate_windows=40", dict(n_rate_windows=40), {}),
    ("burst_isi_max=1", dict(burst_isi_max=1), {}),
    ("burst_isi_max=20", dict(burst_isi_max=20), {}),
    ("input_fanout=2", dict(input_fanout=2), {}),
    ("input_fanout=32", dict(input_fanout=32), {}),
    ("input_weight=0.5", dict(input_weight=0.5), {}),
    ("input_weight=2.0", dict(input_weight=2.0), {}),
    ("weight_variance=1", dict(weight_variance=1.0), {}),
    ("weight_variance=30", dict(weight_variance=30.0), {}),
    ("multiplier=0.3 (sub-critical)", {}, dict(multiplier=0.3)),
    ("multiplier=1.0 (super-critical)", {}, dict(multiplier=1.0)),
    ("leak_variance_divisor=4", dict(leak_variance_divisor=4.0), {}),
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.tools.sensitivity")
    ap.add_argument("--n-per-class", type=int, default=100)
    ap.add_argument("--feature-set", default="all",
                    help="'all' covers every stat key incl. bursts")
    ap.add_argument("--markdown", action="store_true",
                    help="Emit a markdown table on stdout")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu.")
    args = ap.parse_args(argv)

    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import PipelineConfig, ReservoirConfig
    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io import dataset

    device = resolve_device(args.device)
    audio, labels = dataset.synthetic_audio_batch_hard(n_per_class=args.n_per_class,
                                                       n_classes=12, seed=42)
    rows = []
    for tag, rcfg_kw, pcfg_kw in PERTURBATIONS:
        cfg = PipelineConfig(reservoir=ReservoirConfig(**rcfg_kw),
                             feature_set=args.feature_set, batch_size=512, **pcfg_kw)
        t0 = time.time()
        res, ext = pipeline.run_pipeline_arrays(cfg, audio, labels, device)
        diag = ext.diagnostics
        log(f"{tag:<42} acc={res.accuracy:.4f} regime={diag.regime} "
            f"part={diag.avg_participation:.1f}% ({time.time() - t0:.0f}s)")
        rows.append((tag, res.accuracy, diag.regime, diag.avg_participation))

    base_acc = rows[0][1]
    print()
    header = f"{'perturbation':<34} {'acc':>7} {'delta':>7}  {'regime':<16} {'part%':>6}"
    print(header)
    print("-" * len(header))
    for tag, acc, regime, part in rows:
        print(f"{tag:<34} {acc:7.4f} {acc - base_acc:+7.4f}  {regime:<16} {part:6.1f}")
    if args.markdown:
        print()
        print("| perturbation | accuracy | delta vs baseline | regime | participation |")
        print("|---|---|---|---|---|")
        for tag, acc, regime, part in rows:
            print(f"| {tag} | {acc:.4f} | {acc - base_acc:+.4f} | {regime} | {part:.1f}% |")


if __name__ == "__main__":
    main()
