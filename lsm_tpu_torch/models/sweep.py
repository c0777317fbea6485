"""Regime sweeps over the reservoir's input and weight parameters (port of
lsm_tpu/models/sweep.py).

For each point of the (input_fanout, input_weight, weight_variance,
multiplier) grid: calibrate w_critico on the spikes, draw the reservoir
(dense or block-sparse, as the config says), simulate a probe batch and
report the participation (the share of neurons that fired) and the regime
with the diagnostics thresholds. `lsm_tpu_torch.tools.calibrate` drives it.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
from typing import List, Sequence

import torch

from lsm_tpu_torch.config import ReservoirConfig
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models.calibration import calibrate_weight
from lsm_tpu_torch.models.diagnostics import classify_regime
from lsm_tpu_torch.models.sparse import init_reservoir_sparse


@dataclasses.dataclass
class SweepPoint:
    input_fanout: int
    input_weight: float
    weight_variance: float
    multiplier: float
    participation: float      # %
    spikes_per_neuron: float
    regime: str


def sweep_regime(
    spikes,
    base_cfg: ReservoirConfig,
    input_fanouts: Sequence[int],
    input_weights: Sequence[float],
    weight_variances: Sequence[float],
    multipliers: Sequence[float] = (0.6,),
    n_probe: int = 8,
    device: torch.device | str = "cpu",
) -> List[SweepPoint]:
    """One SweepPoint per grid point, in itertools.product order. `spikes`
    (B, C, T) 0/1 (NumPy or a tensor) calibrate every point; its first
    n_probe rows are simulated on `device`."""
    dev = torch.device(device)
    spikes = torch.as_tensor(spikes)
    probe = spikes[:n_probe].to(dev)
    n_channels = spikes.shape[1]
    out: List[SweepPoint] = []
    for fo, wi, wv, mult in itertools.product(
        input_fanouts, input_weights, weight_variances, multipliers
    ):
        print(f"... sweeping fanout={fo} w_in={wi} wv={wv} mult={mult}",
              file=sys.stderr, flush=True)
        cfg = dataclasses.replace(
            base_cfg, input_fanout=fo, input_weight=wi, weight_variance=wv
        )
        _, mw = calibrate_weight(cfg, spikes, mult)
        if cfg.use_sparse():
            reservoir = init_reservoir_sparse(cfg, n_channels, mean_weight=mw, device=dev)
        else:
            reservoir = res.init_reservoir(cfg, n_channels, mean_weight=mw, device=dev)
        counts = res.simulate_batch(reservoir, probe)["all_counts"]
        part = float((counts > 0).double().mean(dim=1).mean() * 100.0)
        rate = float(counts.mean())
        out.append(SweepPoint(fo, wi, wv, mult, part, rate, classify_regime(part)[0]))
    return out
