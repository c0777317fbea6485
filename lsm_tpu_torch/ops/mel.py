"""Slaney mel filterbank, librosa.filters.mel's defaults
(port of lsm_tpu/ops/mel.py).

Slaney mel scale (htk=False), Slaney area normalization, fmin 0, fmax
sr / 2. The filterbank is a NumPy constant built in float64 as lsm_tpu
builds it (copied; tests hold it bit-equal), rounded to float32 once and
kept on each device it is asked for; it is applied as one float32 matmul
(TF32 stays off: device.resolve_device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_F_SP = 200.0 / 3.0           # linear region: mels per Hz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) float32 Slaney-normalized triangular filters."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: constant energy per channel.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def filterbank_on(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float | None,
                  device: torch.device) -> torch.Tensor:
    """mel_filterbank(...) as a (n_mels, n_freqs) tensor on `device`, made
    once per device."""
    return torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(device)


def apply_mel(power_spec: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """(..., n_freqs, frames) -> (..., n_mels, frames): fb (n_mels, n_freqs)
    times the power spectrogram, one float32 matmul."""
    return torch.matmul(fb, power_spec)
