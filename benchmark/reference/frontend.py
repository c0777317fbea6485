"""Plain reference of the front end: the exact gammatone (ERB) filterbank
as Slaney's four-section cascade, dB, normalization and the hysteresis
spike encoder, for whole utterances (the batch path) and for 100 ms chunks
with every piece of state carried (the continuous engine).

Plain PyTorch in float32, as the configuration states, with the cascade in
block form: per sub-block of g samples, per channel, one (g+8) x (g+8)
linear map of [samples; state] worked out in float64 on the host by running
the sequential filter on basis vectors, then rounded to float32. The
builders are copies of lsm_tpu_torch/ops/gammatone.py's (Slaney,
Apple TR #35); nothing here imports the program.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_EAR_Q = 9.26449
_MIN_BW = 24.7
_LOG10 = 2.302585092994046


def _round_half_away(x: float) -> int:
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


def strides(fs: float, window_time: float, hop_time: float, n_samples: int):
    """(window, hop, columns) in samples, as the gammatone package counts."""
    nwin = _round_half_away(window_time * fs)
    hop = _round_half_away(hop_time * fs)
    return nwin, hop, int(math.floor((n_samples - nwin) / hop)) + 1


def _section_coeffs(fs: float, channels: int, f_min: float):
    """Slaney's MakeERBFilters in float64, the gain split over the four
    sections: (n0 (C,), n1 (4, C), b1 (C,), b2 (C,)); channel 0 lowest."""
    c = _EAR_Q * _MIN_BW
    cf = (-c + np.exp(np.arange(1, channels + 1) * (-np.log(fs / 2.0 + c) + np.log(f_min + c))
                      / channels) * (fs / 2.0 + c))[::-1].astype(np.float64)
    T = 1.0 / fs
    erb = cf / _EAR_Q + _MIN_BW
    B = 1.019 * 2.0 * np.pi * erb
    arg = 2.0 * cf * np.pi * T
    vec = np.exp(2j * arg)
    b1 = -2.0 * np.cos(arg) / np.exp(B * T)
    b2 = np.exp(-2.0 * B * T)
    rt_pos, rt_neg = np.sqrt(3.0 + 2.0**1.5), np.sqrt(3.0 - 2.0**1.5)
    common = -T * np.exp(-(B * T))
    ks = (np.cos(arg) + rt_pos * np.sin(arg), np.cos(arg) - rt_pos * np.sin(arg),
          np.cos(arg) + rt_neg * np.sin(arg), np.cos(arg) - rt_neg * np.sin(arg))
    gain_arg = np.exp(1j * arg - B * T)
    gain = np.abs(np.prod([vec - gain_arg * k for k in ks], axis=0)
                  * (T * np.exp(B * T) / (-1.0 / np.exp(B * T) + 1.0
                                          + vec * (1.0 - np.exp(B * T)))) ** 4)
    g4 = gain ** 0.25
    return T / g4, np.stack([common * k / g4 for k in ks]), b1, b2


@functools.lru_cache(maxsize=None)
def block_system(fs: float, channels: int, f_min: float, g: int) -> np.ndarray:
    """(C, g+8, g+8) float64: row m < g gives output sample m, row g + t the
    new state t, from z = [g samples; 8 TDF2 states (section k's s1, s2 at
    2k, 2k+1)]."""
    n0, n1, b1, b2 = _section_coeffs(fs, channels, f_min)
    N = g + 8
    x_basis = np.zeros((N, g))
    x_basis[:g] = np.eye(g)
    state = np.zeros((channels, N, 4, 2))
    for k in range(4):
        for j in range(2):
            state[:, g + 2 * k + j, k, j] = 1.0
    y_out = np.zeros((channels, N, g))
    for t in range(g):
        x = np.broadcast_to(x_basis[:, t], (channels, N)).copy()
        for k in range(4):
            s1, s2 = state[:, :, k, 0].copy(), state[:, :, k, 1].copy()
            y = n0[:, None] * x + s1
            state[:, :, k, 0] = n1[k][:, None] * x - b1[:, None] * y + s2
            state[:, :, k, 1] = -b2[:, None] * y
            x = y
        y_out[:, :, t] = x
    s_flat = state.reshape(channels, N, 8)
    k = np.zeros((channels, N, N))
    k[:, :g, :] = y_out.transpose(0, 2, 1)
    k[:, g:, :] = s_flat.transpose(0, 2, 1)
    return k


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 t rounded to TF32's 10-bit mantissa (to nearest, ties away
    from zero): what a matrix product with TF32 on reads of its operands."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Cascade:
    """The float32 block form of one filterbank on one device; with
    `lower`, the control's: its two matrix products with TF32 on, the
    precision below float32 with TF32 off."""

    def __init__(self, fs: float, channels: int, f_min: float, g: int, device,
                 lower: bool = False):
        kmat = torch.as_tensor(block_system(fs, channels, f_min, g), dtype=torch.float32,
                               device=device)
        self.q = to_tf32 if lower else (lambda t: t)
        C, g = channels, g
        self.g = g
        self.w_yx = self.q(kmat[:, :g, :g].permute(2, 1, 0).reshape(g, g * C))
        self.w_xs = self.q(kmat[:, g:, :g].permute(2, 1, 0).reshape(g, 8 * C))
        self.m_sy = kmat[:, :g, g:].permute(2, 1, 0).contiguous()     # (8, g, C)
        self.m_ss = kmat[:, g:, g:].permute(2, 1, 0).contiguous()     # (8, 8, C)

    def run(self, wave: torch.Tensor, state: torch.Tensor):
        """wave (B, n_sub*g) f32, state (B, 8, C) -> (state, sub-block
        energies (n_sub, B, C))."""
        B, S = wave.shape
        g, C = self.g, self.m_ss.shape[-1]
        blocks = self.q(wave).view(B, S // g, g).transpose(0, 1)
        out = torch.empty(S // g, B, C, dtype=torch.float32, device=wave.device)
        for k in range(S // g):
            x = blocks[k]
            y = (x @ self.w_yx).view(B, g, C)
            new = (x @ self.w_xs).view(B, 8, C)
            for s in range(8):
                col = state[:, s, :][:, None, :]
                y = y + col * self.m_sy[s][None]
                new = new + col * self.m_ss[s][None]
            out[k] = torch.sum(y * y, dim=1)
            state = new
        return state, out


def hysteresis(spec: torch.Tensor, state: torch.Tensor, thresholds, gap: float):
    """Schmitt triggers per threshold (descending): on when x > theta, off
    when x < theta - gap. spec (B, C, T) in [0, 1], state (B, n_thr, C) bool
    -> (spikes (B, C, T * n_thr) uint8, column t * n_thr + i, new state)."""
    thr = np.sort(np.asarray(thresholds, dtype=np.float32))[::-1].copy()
    lower = (thr - np.float32(gap)).astype(np.float32)
    n = len(thr)
    thr_t = torch.as_tensor(thr, device=spec.device).view(n, 1, 1)
    low_t = torch.as_tensor(lower, device=spec.device).view(n, 1, 1)
    x = spec.unsqueeze(-3)
    rising, holdable = x > thr_t, x >= low_t
    out = torch.empty_like(rising)
    active = state
    for t in range(spec.shape[-1]):
        active = rising[..., t] | (active & holdable[..., t])
        out[..., t] = active
    out = out.movedim(-3, -1)
    return out.reshape(out.shape[:-2] + (-1,)).to(torch.uint8), active


class Frontend:
    """The configuration's gammatone front end on one device."""

    def __init__(self, f: dict, device, lower: bool = False):
        if f["filterbank"] != "gammatone" or f["gammatone_method"] != "iir":
            raise ValueError("the reference front end is the exact gammatone cascade")
        self.f = f
        self.n_samples = int(f["sample_rate"] * f["duration"])
        hop_time = self.n_samples / (f["sample_rate"] * f["time_bins"])
        self.nwin, self.hop, self.n_cols = strides(f["sample_rate"], f["gt_window_time"],
                                                   hop_time, self.n_samples)
        self.g = math.gcd(self.hop, self.nwin)
        self.w_per, self.h_per = self.nwin // self.g, self.hop // self.g
        self.cascade = Cascade(f["sample_rate"], f["n_filters"], f["gt_f_min"], self.g, device,
                               lower)
        self.device = device

    def _windows(self, sub: torch.Tensor, n_cols: int) -> torch.Tensor:
        """(n_sub, B, C) sub-block energies -> (n_cols, B, C) window sums."""
        h = self.h_per
        span = (n_cols - 1) * h + 1
        win = sub[0:span:h]
        for j in range(1, self.w_per):
            win = win + sub[j:j + span:h]
        return win

    def batch(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, S) f32 audio -> (B, C * R, T) uint8 spikes."""
        f = self.f
        B, S = audio.shape
        n_sub = -(-S // self.g)
        wave = torch.nn.functional.pad(audio.float(), (0, n_sub * self.g - S))
        state = torch.zeros(B, 8, f["n_filters"], device=audio.device)
        sub = self.cascade.run(wave.contiguous(), state)[1]
        win = self._windows(sub, self.n_cols)
        spec_db = 20.0 * (torch.log(torch.sqrt(win / self.nwin).permute(1, 2, 0) + 1e-9) / _LOG10)
        peak = torch.amax(spec_db, dim=(-2, -1), keepdim=True)
        spec_db = torch.maximum(spec_db, peak - f["power_top_db"])
        lo = torch.amin(spec_db, dim=(-2, -1), keepdim=True)
        hi = torch.amax(spec_db, dim=(-2, -1), keepdim=True)
        rng = hi - lo
        norm = torch.where(rng < 1e-8, 0.0, (spec_db - lo) / (rng + 1e-8))
        norm = zoom(norm, f["time_bins"])
        state = torch.zeros(B, len(f["spike_thresholds"]), f["n_filters"], dtype=torch.bool,
                            device=audio.device)
        spikes = hysteresis(norm, state, f["spike_thresholds"], f["hysteresis_gap"])[0]
        if f["redundancy_factor"] > 1:
            spikes = torch.repeat_interleave(spikes, f["redundancy_factor"], dim=-2)
        return spikes

    def chunk(self, chunk: torch.Tensor, st: dict, decay: float):
        """One continuous-engine hop: a (B, L) f32 chunk and the carried
        iir (B, 8, C), tail (w_per - h_per, B, C) energies, hyst (B, n_thr,
        C), norm_hi/norm_lo (B,) -> (spikes (B, C*R, T_c) uint8, new leaves).
        Every bin normalizes against the chunk's extrema merged with the
        carried peak and floor aged by decay dB a bin."""
        f = self.f
        n_cols = chunk.shape[1] // self.hop
        iir, sub = self.cascade.run(chunk.contiguous(), st["iir"])
        all_e = torch.cat([st["tail"], sub], dim=0)
        win = self._windows(all_e, n_cols)
        db = 20.0 * torch.log(torch.sqrt(win / self.nwin) + 1e-9) / _LOG10   # (n_cols, B, C)
        jj = torch.arange(n_cols, dtype=torch.float32, device=chunk.device)[:, None]
        hi = torch.maximum(torch.amax(db, dim=(0, 2))[None], st["norm_hi"][None] - decay * (jj + 1))
        lo = torch.minimum(torch.amin(db, dim=(0, 2))[None], st["norm_lo"][None] + decay * (jj + 1))
        floor = hi - f["power_top_db"]
        lo_eff = torch.maximum(lo, floor)
        rng = hi - lo_eff
        x = torch.maximum(db, floor[..., None])
        norm = torch.where((rng < 1e-8)[..., None], 0.0,
                           (x - lo_eff[..., None]) / (rng + 1e-8)[..., None])
        spec = torch.clamp(norm, 0.0, 1.0).permute(1, 2, 0)
        spikes, hyst = hysteresis(spec, st["hyst"], f["spike_thresholds"], f["hysteresis_gap"])
        if f["redundancy_factor"] > 1:
            spikes = torch.repeat_interleave(spikes, f["redundancy_factor"], dim=-2)
        tail = all_e[all_e.shape[0] - (self.w_per - self.h_per):]
        return spikes, dict(iir=iir, tail=tail, hyst=hyst, norm_hi=hi[-1], norm_lo=lo[-1])


def zoom(spec: torch.Tensor, out_size: int) -> torch.Tensor:
    """Linear interpolation of the last axis to out_size points (output i
    at input coordinate i (in - 1) / (out - 1); scipy.ndimage.zoom order 1)."""
    n = spec.shape[-1]
    if n == out_size:
        return spec
    x = np.arange(out_size, dtype=np.float64) * (n - 1) / (out_size - 1)
    lo = np.minimum(np.floor(x).astype(np.int64), n - 2)
    frac = torch.as_tensor((x - lo).astype(np.float32), device=spec.device)
    lo_t = torch.as_tensor(lo, device=spec.device)
    a, b = spec[..., lo_t], spec[..., lo_t + 1]
    return a + (b - a) * frac
