"""Edge-of-chaos weight calibration (port of lsm_tpu/models/calibration.py).

Over the first <=500 training samples:
    avg_I = total_spikes / total_elements
    w_critico = (membrane_threshold - 2 * avg_I * refractory_period) / (k / 2)
with a 0.007 fallback for degenerate inputs. The spike sum runs in int64,
which is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from lsm_tpu_torch.config import ReservoirConfig

_FALLBACK = 0.007
_CALIB_SAMPLES = 500


def average_input_rate(spikes, max_samples: int = _CALIB_SAMPLES) -> float:
    """Mean spike density over the first <=max_samples spike trains
    (a tensor on any device, or a NumPy array)."""
    n = min(int(spikes.shape[0]), max_samples)
    elements = int(np.prod((n,) + tuple(spikes.shape[1:])))
    if elements == 0:
        return float("nan")
    total = int(torch.as_tensor(spikes[:n]).sum(dtype=torch.int64))
    return total / elements


def w_critico(cfg: ReservoirConfig, avg_input_rate: float) -> float:
    """Mean-field critical weight."""
    if not np.isfinite(avg_input_rate):
        return _FALLBACK
    beta = cfg.small_world_k / 2
    if beta == 0:
        return _FALLBACK
    numerator = cfg.membrane_threshold - 2.0 * avg_input_rate * cfg.refractory_period
    return numerator / beta


def calibrate_weight(cfg: ReservoirConfig, train_spikes, multiplier: float) -> tuple:
    """Returns (w_critico, mean_weight = w_critico * multiplier)."""
    wc = w_critico(cfg, average_input_rate(train_spikes))
    return wc, wc * multiplier
