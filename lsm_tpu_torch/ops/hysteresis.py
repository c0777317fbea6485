"""Multi-threshold hysteresis (Schmitt-trigger) spike encoder
(port of lsm_tpu/ops/hysteresis.py).

Per threshold theta (descending; index 0 is the highest) a trigger turns ON
when x > theta, OFF when x < theta - gap, and holds otherwise:

    active_t = (x_t > theta) | (active_{t-1} & (x_t >= theta - gap))

A plain loop over the bins, vectorised over (batch, threshold, filter);
the associative scan of the reference was a TPU choice. The trigger state
can be carried across chunks (`hysteresis_encode_step`, the continuous
engine's encoder). Output columns are interleaved: column
t * n_thresholds + t_idx.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def hysteresis_encode(
    spec: torch.Tensor, thresholds: Sequence[float], gap: float
) -> torch.Tensor:
    """(..., F, T) float in [0, 1] -> (..., F, T * n_thr) uint8: the
    all-off-state special case of `hysteresis_encode_step`."""
    state = torch.zeros(spec.shape[:-2] + (len(thresholds), spec.shape[-2]),
                        dtype=torch.bool, device=spec.device)
    return hysteresis_encode_step(spec, state, thresholds, gap)[0]


def hysteresis_encode_step(
    spec: torch.Tensor, state: torch.Tensor, thresholds: Sequence[float], gap: float
):
    """Chunked encoder with an explicit carried trigger state (lsm_tpu's
    `hysteresis_encode_step`). spec (..., F, T_chunk) in [0, 1], state
    (..., n_thr, F) bool (all False at stream start) -> (spikes (..., F,
    T_chunk * n_thr) uint8 interleaved, new state (..., n_thr, F)).
    Chunks that thread the state are bit-equal to one whole-signal call."""
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
    active = state
    out = torch.empty_like(rising)
    for t in range(spec.shape[-1]):
        active = rising[..., t] | (active & holdable[..., t])
        out[..., t] = active
    # (..., n_thr, F, T) -> (..., F, T, n_thr) -> interleaved columns.
    out = out.movedim(-3, -1)
    return out.reshape(out.shape[:-2] + (-1,)).to(torch.uint8), active
