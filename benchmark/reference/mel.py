"""Plain reference of the mel front end (BASELINE configs[0]: the upstream
create_dataset.py's librosa.feature.melspectrogram and power_to_db), then
the batch path's min-max, zoom and hysteresis encoder, for whole
utterances.

Computed in float64, above the configuration's float32, and with none of
the program's arithmetic:

  - center zero-padding of n_fft // 2 a side and a periodic Hann window;
  - the real DFT as one float64 product of the windowed frames with cos and
    sin tables (angles reduced modulo n_fft in integers), not an FFT;
  - the power |X|^2;
  - the Slaney mel filterbank (htk=False, area normalization), built here
    in float64 from librosa.filters.mel's published formulas: n_mels + 2
    points equally spaced on the Slaney mel scale (linear below 1 kHz at
    200/3 Hz a mel, logarithmic above at ln(6.4) / 27 a mel), a triangle
    between each three consecutive points, scaled to 2 / (its width in Hz);
  - power_to_db with ref = each utterance's max, amin 1e-10, top_db.

Then the min-max as reference/frontend.py's `Frontend.batch` writes it, and
that file's `zoom` and `hysteresis`; the reservoir is reference/
reservoir.py's and the readout engines.py's. Nothing here imports the
program.

`lower=True` makes the control, one precision below the configuration:
the DFT and the filterbank product in TF32 (each operand rounded by
`frontend.to_tf32`, float32 accumulation), float32 elsewhere in the front
end, and the reservoir and readout as engines.py's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import engines
from benchmark.reference.frontend import hysteresis, to_tf32, zoom
from benchmark.reference.reservoir import Reservoir

_HZ_PER_MEL = 200.0 / 3.0        # the Slaney scale's linear part
_BREAK_HZ = 1000.0               # where it turns logarithmic
_LOG_STEP = math.log(6.4) / 27.0  # mels to a factor of 6.4 in Hz: 27


def slaney_mel(hz: np.ndarray) -> np.ndarray:
    hz = np.asarray(hz, dtype=np.float64)
    brk = _BREAK_HZ / _HZ_PER_MEL
    above = brk + np.log(np.maximum(hz, _BREAK_HZ) / _BREAK_HZ) / _LOG_STEP
    return np.where(hz < _BREAK_HZ, hz / _HZ_PER_MEL, above)


def slaney_hz(mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    brk = _BREAK_HZ / _HZ_PER_MEL
    above = _BREAK_HZ * np.exp(_LOG_STEP * (mel - brk))
    return np.where(mel < brk, mel * _HZ_PER_MEL, above)


def mel_filterbank(sr: float, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) float64 Slaney filters: filter m rises from
    edge m to edge m + 1 and falls to edge m + 2, times 2 / (edge m + 2 -
    edge m)."""
    bins = np.arange(n_fft // 2 + 1, dtype=np.float64) * (sr / n_fft)
    edges = slaney_hz(np.linspace(slaney_mel(fmin), slaney_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, bins.size))
    for m in range(n_mels):
        left, centre, right = edges[m], edges[m + 1], edges[m + 2]
        rise = (bins - left) / (centre - left)
        fall = (right - bins) / (right - centre)
        fb[m] = np.clip(np.minimum(rise, fall), 0.0, None) * (2.0 / (right - left))
    return fb


def dft_tables(n_fft: int):
    """(cos, sin), each (n_fft, n_fft // 2 + 1) float64: X_k = sum_n x_n
    (cos - i sin)(2 pi n k / n_fft)."""
    n = np.arange(n_fft, dtype=np.int64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.int64)[None, :]
    angle = (n * k % n_fft).astype(np.float64) * (2.0 * math.pi / n_fft)
    return np.cos(angle), np.sin(angle)


class MelFrontend:
    """The configuration's mel front end on one device."""

    def __init__(self, f: dict, device, lower: bool = False):
        if f["filterbank"] != "mel":
            raise ValueError("the mel reference takes the mel filterbank")
        self.f = f
        self.n_samples = int(f["sample_rate"] * f["duration"])
        self.n_fft = int(f["n_fft"])
        self.hop = max(1, self.n_samples // f["time_bins"])
        self.n_frames = 1 + (self.n_samples + 2 * (self.n_fft // 2) - self.n_fft) // self.hop
        self.dtype = torch.float32 if lower else torch.float64
        self.q = to_tf32 if lower else (lambda t: t)
        fmax = f["mel_fmax"] if f["mel_fmax"] is not None else f["sample_rate"] / 2.0
        self.fb64 = mel_filterbank(f["sample_rate"], self.n_fft, f["n_filters"],
                                   f["mel_fmin"], fmax)
        as_dev = lambda a: torch.as_tensor(a, dtype=self.dtype, device=device)
        cos, sin = dft_tables(self.n_fft)
        self.cos, self.sin = self.q(as_dev(cos)), self.q(as_dev(sin))
        self.fb_t = self.q(as_dev(self.fb64.T.copy()))
        n = np.arange(self.n_fft, dtype=np.float64)
        self.window = as_dev(0.5 - 0.5 * np.cos(2.0 * math.pi * n / self.n_fft))

    def taps(self) -> int:
        """Nonzero weights of the filterbank."""
        return int(np.count_nonzero(self.fb64))

    def spectrogram_db(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, S) audio -> (B, n_mels, n_frames) dB, ref = each row's max."""
        pad = self.n_fft // 2
        x = torch.nn.functional.pad(audio.to(self.dtype), (pad, pad))
        frames = x.unfold(-1, self.n_fft, self.hop)[:, :self.n_frames] * self.window
        frames = self.q(frames)
        power = (frames @ self.cos) ** 2 + (frames @ self.sin) ** 2      # (B, F, K)
        mel = (self.q(power) @ self.fb_t).transpose(1, 2)                 # (B, M, F)
        amin, top_db = 1e-10, self.f["power_top_db"]
        ref = torch.amax(mel, dim=(-2, -1), keepdim=True)
        db = 10.0 * torch.log10(torch.clamp_min(mel, amin)) \
            - 10.0 * torch.log10(torch.clamp_min(ref, amin))
        return torch.maximum(db, torch.amax(db, dim=(-2, -1), keepdim=True) - top_db)

    def normalized(self, audio: torch.Tensor) -> torch.Tensor:
        """Min-max to [0, 1] per utterance, then the zoom to time_bins."""
        spec_db = self.spectrogram_db(audio)
        lo = torch.amin(spec_db, dim=(-2, -1), keepdim=True)
        hi = torch.amax(spec_db, dim=(-2, -1), keepdim=True)
        rng = hi - lo
        norm = torch.where(rng < 1e-8, 0.0, (spec_db - lo) / (rng + 1e-8))
        return zoom(norm, self.f["time_bins"])

    def batch(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, S) f32 audio -> (B, C * R, T) uint8 spikes."""
        f = self.f
        norm = self.normalized(audio)
        state = torch.zeros(audio.shape[0], len(f["spike_thresholds"]), f["n_filters"],
                            dtype=torch.bool, device=audio.device)
        spikes = hysteresis(norm, state, f["spike_thresholds"], f["hysteresis_gap"])[0]
        if f["redundancy_factor"] > 1:
            spikes = torch.repeat_interleave(spikes, f["redundancy_factor"], dim=-2)
        return spikes


class Batch(engines.Batch):
    """engines.Batch with the mel front end: the same stages, blocks of
    rows and control."""

    def __init__(self, config: dict, weights: dict, device, lower: bool = False,
                 rows: int = 600):
        engines._precise()
        self.config, self.rows = config, rows
        self.frontend = MelFrontend(config["frontend"], device, lower)
        self.reservoir = Reservoir(config["reservoir"], weights, lower)
        self.keys = tuple(config["feature_keys"])
        self.readout = engines.Readout(weights, lower)
