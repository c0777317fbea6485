"""Feature standardization with StandardScaler semantics
(port of lsm_tpu/readout/scaler.py).

Two-pass (mean, then centred second moment): the one-pass form cancels
catastrophically in f32 for large-mean, small-variance features. Population
std (ddof=0); zero variance maps to scale 1. The streaming trainer, which
sees each row once, builds its scaler from shifted moments instead
(`fit_scaler_from_moments`).
"""

from __future__ import annotations

import torch
from torch import nn


class Scaler(nn.Module):
    """Per-feature mean and scale as buffers; forward standardizes."""

    def __init__(self, mean, scale):
        super().__init__()
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32))
        self.register_buffer("scale", torch.as_tensor(scale, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return transform(self, x)


def fit_scaler(x: torch.Tensor) -> Scaler:
    """(N, D) -> Scaler on x's device."""
    mean = torch.mean(x, dim=0)
    d = x - mean[None, :]
    var = torch.mean(d * d, dim=0)
    scale = torch.sqrt(var)
    scale = torch.where(scale == 0.0, 1.0, scale)
    return Scaler(mean, scale)


def fit_scaler_from_moments(sum_x: torch.Tensor, sum_x2: torch.Tensor, count: torch.Tensor,
                            shift: torch.Tensor) -> Scaler:
    """A Scaler from streamed moments (the streaming trainer cannot two-pass).

    The moments are shifted by c: sum_x = sum(x - c), sum_x2 =
    sum((x - c)^2). Then var = E[(x - c)^2] - (mean - c)^2 subtracts a
    small correction instead of cancelling two large numbers (pick c near
    the data, e.g. the first batch's mean)."""
    dmean = sum_x / count                           # mean - c
    mean = dmean + shift
    var = torch.clamp_min(sum_x2 / count - dmean * dmean, 0.0)
    scale = torch.sqrt(var)
    scale = torch.where(scale == 0.0, 1.0, scale)
    return Scaler(mean, scale)


def transform(state: Scaler, x: torch.Tensor) -> torch.Tensor:
    return (x - state.mean) / state.scale
