"""Multi-threshold hysteresis (Schmitt-trigger) spike encoder
(port of lsm_tpu/ops/hysteresis.py).

Per threshold theta (descending; index 0 is the highest) a trigger turns ON
when x > theta, OFF when x < theta - gap, and holds otherwise:

    active_t = (x_t > theta) | (active_{t-1} & (x_t >= theta - gap))

CUDA tensors take one kernel pass (ops/kernels/hysteresis.py); CPU tensors
take its plain twin there, a loop over the bins vectorised over (batch,
threshold, filter): the associative scan of the reference was a TPU choice.
The trigger state can be carried across chunks (`hysteresis_encode_step`,
the continuous engine's encoder). Output columns are interleaved: column
t * n_thresholds + t_idx.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from lsm_tpu_torch.ops.kernels import hysteresis as khyst


def levels(thresholds: Sequence[float], gap: float):
    """float32 thresholds sorted descending and their OFF levels, computed
    as the reference does (f32 threshold minus f32 gap); read-only arrays,
    built once per (thresholds, gap)."""
    if gap < 0:
        raise ValueError(f"hysteresis gap must be >= 0, got {gap}")
    return _levels(tuple(map(float, thresholds)), float(gap))


@functools.lru_cache(maxsize=16)
def _levels(thresholds: tuple, gap: float):
    on = np.sort(np.asarray(thresholds, dtype=np.float32))[::-1].copy()
    off = (on - np.float32(gap)).astype(np.float32)
    on.flags.writeable = off.flags.writeable = False
    return on, off


def hysteresis_encode(
    spec: torch.Tensor, thresholds: Sequence[float], gap: float
) -> torch.Tensor:
    """(..., F, T) float32 in [0, 1] -> (..., F, T * n_thr) uint8: the
    all-off-state special case of `hysteresis_encode_step`."""
    on, off = levels(thresholds, gap)
    lead, (F, T) = spec.shape[:-2], spec.shape[-2:]
    spikes = khyst.encode(spec.reshape(-1, F, T), None, on, off, want_state=False)[0]
    return spikes.view(lead + spikes.shape[-2:])


def hysteresis_encode_step(
    spec: torch.Tensor, state: torch.Tensor, thresholds: Sequence[float], gap: float
):
    """Chunked encoder with an explicit carried trigger state (lsm_tpu's
    `hysteresis_encode_step`). spec (..., F, T_chunk) float32 in [0, 1],
    state (..., n_thr, F) bool (all False at stream start) -> (spikes
    (..., F, T_chunk * n_thr) uint8 interleaved, new state (..., n_thr, F)).
    Chunks that thread the state are bit-equal to one whole-signal call."""
    on, off = levels(thresholds, gap)
    lead, (F, T) = spec.shape[:-2], spec.shape[-2:]
    if state.shape != lead + (len(on), F):
        raise ValueError(f"trigger state {tuple(state.shape)} is not "
                         f"{tuple(lead + (len(on), F))}")
    spikes, new = khyst.encode(spec.reshape(-1, F, T), state.reshape(-1, len(on), F), on, off)
    return spikes.view(lead + spikes.shape[-2:]), new.view(state.shape)
