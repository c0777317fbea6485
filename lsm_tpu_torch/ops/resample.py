"""Linear time-axis zoom matching scipy.ndimage.zoom(order=1)
(port of lsm_tpu/ops/resample.py).

Output index i maps to input coordinate i * (in - 1) / (out - 1); the plan
(two index vectors and a float32 fraction) is built once on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def lerp_plan(in_size: int, out_size: int):
    """(lo, hi, frac) for the linear zoom; equal to lsm_tpu's _lerp_plan."""
    if out_size == 1 or in_size == 1:
        lo = np.zeros(out_size, dtype=np.int32)
        return lo, lo, np.zeros(out_size, dtype=np.float32)
    x = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.floor(x).astype(np.int64)
    lo = np.minimum(lo, in_size - 2)
    frac = (x - lo).astype(np.float32)
    return lo.astype(np.int32), (lo + 1).astype(np.int32), frac


def zoom_time_axis(spec: torch.Tensor, out_size: int) -> torch.Tensor:
    """(..., T_in) -> (..., out_size) linear interpolation on the last axis."""
    in_size = spec.shape[-1]
    if in_size == out_size:
        return spec
    lo, hi, frac = lerp_plan(in_size, out_size)
    dev = spec.device
    a = spec[..., torch.as_tensor(lo, dtype=torch.long, device=dev)]
    b = spec[..., torch.as_tensor(hi, dtype=torch.long, device=dev)]
    return a + (b - a) * torch.as_tensor(frac, device=dev)
