"""Block-sparse against dense reservoir accuracy at an equal neuron count
(the port's counterpart of tools/sparse_parity.py, plus --device).

The block-sparse reservoir differs from the dense draw in one structural
way: rewired edges land inside R random partner blocks of their source
block instead of anywhere. This runs the pipeline on the frozen hard
corpus with both, with matched calibration (w_critico depends on the input
only, so both get the same mean weight), and prints both accuracies and
their difference (docs/SENSITIVITY.md records lsm_tpu's at N = 4096). At
4096 neurons and more the dense reservoir is drawn on the device.

    python -m lsm_tpu_torch.tools.sparse_parity [--neurons 4096]
        [--n-per-class 30] [--repeats 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_one(base, sparse: bool, audio, labels, multiplier: float, device) -> tuple:
    """run_pipeline_arrays with `base` (a ReservoirConfig) dense or
    block-sparse, at the tool's batch size: (TrainResult, ExtractionResult)."""
    from lsm_tpu_torch import pipeline
    from lsm_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig(reservoir=dataclasses.replace(base, sparse=sparse), batch_size=128,
                         multiplier=multiplier)
    return pipeline.run_pipeline_arrays(cfg, audio, labels, device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.tools.sparse_parity")
    ap.add_argument("--neurons", type=int, default=4096)
    ap.add_argument("--outputs", type=int, default=400)
    ap.add_argument("--n-per-class", type=int, default=30)
    ap.add_argument("--multiplier", type=float, default=0.6,
                    help="w_critico multiplier; at N=4096 the flagship default 0.6 "
                         "lands SUB-CRITICAL.")
    ap.add_argument("--repeats", type=int, default=1,
                    help="Benchmark corpus seeds to average over.")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu.")
    args = ap.parse_args(argv)

    import numpy as np

    from lsm_tpu_torch.config import ReservoirConfig
    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io import dataset

    device = resolve_device(args.device)
    n = args.neurons
    base = ReservoirConfig(num_neurons=n, num_output_neurons=args.outputs,
                           small_world_k=int(0.10 * n * 2))
    rows = []
    for r in range(args.repeats):
        corpus_seed = 42 + r
        audio, labels = dataset.synthetic_audio_batch_hard(
            n_per_class=args.n_per_class, n_classes=12, seed=corpus_seed)
        accs = {}
        for kind in ("dense", "sparse"):
            res, ext = run_one(base, kind == "sparse", audio, labels, args.multiplier, device)
            accs[kind] = res.accuracy
            log(f"corpus_seed={corpus_seed} {kind:6s} N={n}: acc={res.accuracy:.4f} "
                f"regime={ext.diagnostics.regime} "
                f"participation={ext.diagnostics.avg_participation:.1f}% "
                f"(mean_weight={ext.mean_weight:.6f})")
        rows.append(accs)
        print(f"corpus_seed={corpus_seed}: dense={accs['dense']:.4f} "
              f"sparse={accs['sparse']:.4f} delta={accs['sparse'] - accs['dense']:+.4f}",
              flush=True)
    if len(rows) > 1:
        d = np.asarray([r["dense"] for r in rows])
        s = np.asarray([r["sparse"] for r in rows])
        print(f"mean over {len(rows)} corpora: dense={d.mean():.4f} sparse={s.mean():.4f} "
              f"delta={(s - d).mean():+.4f} (per-corpus spread dense±{d.std():.3f} "
              f"sparse±{s.std():.3f})", flush=True)


if __name__ == "__main__":
    main()
