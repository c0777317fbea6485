"""Sweep the reservoir's parameterization for the edge of chaos (the port's
counterpart of tools/calibrate.py, plus --device).

Featurizes 8 synthetic utterances a class (12 classes) at the default
frontend, then runs `models.sweep.sweep_regime` over the grid the flags
give and prints each point's participation, spikes a neuron and regime,
nearest 88 % participation first.

    python -m lsm_tpu_torch.tools.calibrate [--fanout 2 4 8] [--w-in 1.0]
        [--wvar 10] [--multiplier 0.3 0.6 1.0] [--num-neurons 1000] [--device cuda]
"""

from __future__ import annotations

import argparse

from lsm_tpu_torch.config import FrontendConfig, ReservoirConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.tools.calibrate")
    ap.add_argument("--fanout", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--w-in", type=float, nargs="+", default=[1.0])
    ap.add_argument("--wvar", type=float, nargs="+", default=[10.0])
    ap.add_argument("--multiplier", type=float, nargs="+", default=[0.3, 0.6, 1.0])
    ap.add_argument("--num-neurons", type=int, default=1000,
                    help="Reservoir size (e.g. 10240 for the scaled config).")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu.")
    args = ap.parse_args(argv)

    import torch

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io.dataset import synthetic_audio_batch
    from lsm_tpu_torch.models.frontend import featurize_batch
    from lsm_tpu_torch.models.sweep import sweep_regime

    device = resolve_device(args.device)
    audio, _ = synthetic_audio_batch(n_per_class=8, n_classes=12, seed=42)
    spikes = featurize_batch(torch.as_tensor(audio).to(device), FrontendConfig()).cpu()
    print(f"probe spikes: {tuple(spikes.shape)} density={float(spikes.float().mean()):.4f}")

    n = args.num_neurons
    base_cfg = ReservoirConfig(num_neurons=n, num_output_neurons=max(1, int(0.4 * n)),
                               small_world_k=int(0.10 * n * 2))
    points = sweep_regime(spikes, base_cfg, input_fanouts=args.fanout,
                          input_weights=args.w_in, weight_variances=args.wvar,
                          multipliers=args.multiplier, device=device)
    print(f"{'fo':>4} {'w_in':>6} {'wvar':>6} {'mult':>6} {'part%':>7} "
          f"{'spk/n':>8} regime", flush=True)
    for p in sorted(points, key=lambda p: abs(p.participation - 88)):
        print(f"{p.input_fanout:4d} {p.input_weight:6.2f} {p.weight_variance:6.1f} "
              f"{p.multiplier:6.2f} {p.participation:7.1f} {p.spikes_per_neuron:8.2f} "
              f"{p.regime}", flush=True)


if __name__ == "__main__":
    main()
