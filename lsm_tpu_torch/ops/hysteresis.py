"""Multi-threshold hysteresis (Schmitt-trigger) spike encoder
(port of lsm_tpu/ops/hysteresis.py).

Per threshold theta (descending; index 0 is the highest) a trigger turns ON
when x > theta, OFF when x < theta - gap, and holds otherwise:

    active_t = (x_t > theta) | (active_{t-1} & (x_t >= theta - gap))

A plain loop over the T=100 bins, vectorised over (batch, threshold,
filter); the associative scan of the reference was a TPU choice. Output
columns are interleaved: column t * n_thresholds + t_idx.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def hysteresis_encode(
    spec: torch.Tensor, thresholds: Sequence[float], gap: float
) -> torch.Tensor:
    """(..., F, T) float in [0, 1] -> (..., F, T * n_thr) uint8."""
    if gap < 0:
        raise ValueError(f"hysteresis gap must be >= 0, got {gap}")
    # float32 thresholds and OFF levels, computed as the reference does
    # (f32 threshold minus f32 gap).
    thr = np.sort(np.asarray(thresholds, dtype=np.float32))[::-1].copy()
    lower = (thr - np.float32(gap)).astype(np.float32)
    n_thr = len(thr)
    dev = spec.device
    thr_t = torch.as_tensor(thr, device=dev).view(n_thr, 1, 1)
    lower_t = torch.as_tensor(lower, device=dev).view(n_thr, 1, 1)

    x = spec.unsqueeze(-3)                                  # (..., 1, F, T)
    rising = x > thr_t                                      # (..., n_thr, F, T)
    holdable = x >= lower_t
    active = torch.zeros(rising.shape[:-1], dtype=torch.bool, device=dev)
    out = torch.empty_like(rising)
    for t in range(spec.shape[-1]):
        active = rising[..., t] | (active & holdable[..., t])
        out[..., t] = active
    # (..., n_thr, F, T) -> (..., F, T, n_thr) -> interleaved columns.
    out = out.movedim(-3, -1)
    return out.reshape(out.shape[:-2] + (-1,)).to(torch.uint8)
