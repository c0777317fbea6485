"""Feature standardization with StandardScaler semantics
(port of lsm_tpu/readout/scaler.py).

Two-pass (mean, then centred second moment): the one-pass form cancels
catastrophically in f32 for large-mean, small-variance features. Population
std (ddof=0); zero variance maps to scale 1.
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


def transform(state: Scaler, x: torch.Tensor) -> torch.Tensor:
    return (x - state.mean) / state.scale
