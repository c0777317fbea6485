"""The two dB conversions (mel's power_to_db, gammatone's 20 log10 with a
floor) and per-sample min-max (port of lsm_tpu/ops/db.py).

log10 is computed as log(x) / ln(10), as the reference package does, so the
two agree to the ulp (torch.log10 rounds differently).
"""

from __future__ import annotations

import torch

_LOG10 = 2.302585092994046  # ln(10)


def _log10(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) / _LOG10


def power_to_db(
    power: torch.Tensor, amin: float = 1e-10, top_db: float = 80.0
) -> torch.Tensor:
    """librosa.power_to_db(S, ref=np.max) over the trailing two axes: the
    mel path's dB, with an 80 dB floor below the per-sample peak."""
    ref = torch.amax(power, dim=(-2, -1), keepdim=True)
    log_spec = 10.0 * _log10(torch.clamp_min(power, amin))
    log_spec = log_spec - 10.0 * _log10(torch.clamp_min(ref, amin))
    peak = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    return torch.maximum(log_spec, peak - top_db)


def amplitude_to_db_floor(
    amplitude: torch.Tensor, eps: float = 1e-9, top_db: float = 80.0
) -> torch.Tensor:
    """20*log10(S + eps), floored at the per-sample max - top_db."""
    spec_db = 20.0 * _log10(amplitude + eps)
    peak = torch.amax(spec_db, dim=(-2, -1), keepdim=True)
    return torch.maximum(spec_db, peak - top_db)


def minmax_normalize(
    spec_db: torch.Tensor, degenerate_eps: float = 1e-8
) -> torch.Tensor:
    """Per-sample min-max to [0, 1]; a degenerate range maps to zeros."""
    lo = torch.amin(spec_db, dim=(-2, -1), keepdim=True)
    hi = torch.amax(spec_db, dim=(-2, -1), keepdim=True)
    rng = hi - lo
    normed = (spec_db - lo) / (rng + degenerate_eps)
    return torch.where(rng < degenerate_eps, torch.zeros_like(normed), normed)
