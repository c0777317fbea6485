"""Exact gammatone (ERB) spectrogram (port of lsm_tpu/ops/gammatone.py).

The float64 NumPy constant builders are copied from the reference package,
whose module imports jax: `make_erb_coeffs`, `gtgram_strides`,
`_block_iir_matrices`, `_quadratic_matrices` and `_gammatone_fft_weights`
(tests assert equality with lsm_tpu's). Slaney's 4-biquad cascade runs over
sub-blocks of g = gcd(hop, window) samples with an 8-dim carried state; the
per-sub-block energies come from kernel B1 (ops/kernels/gtgram.py), which runs the cascade sample by
sample from `cascade_coeffs`, and whose plain PyTorch twin is the exact
block scan of lsm_tpu's `gtgram_iir` on `block_system`; for the continuous
engine's chunks with a carried state, from kernel B3 (`gtgram_chunk`,
`gtgram_iir_scan`). `gtgram_fft` is the FFT-weighted approximation
(gammatone_method "fft"), on torch.fft.rfft and a float32 matmul.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from lsm_tpu_torch.ops.kernels import gtgram as gtgram_kernel
from lsm_tpu_torch.ops.stft import hann_window, window_on

_EAR_Q = 9.26449
_MIN_BW = 24.7


def erb_space(low_freq: float, high_freq: float, num: int) -> np.ndarray:
    """ERB-spaced center frequencies, DESCENDING (Slaney's ErbSpace)."""
    c = _EAR_Q * _MIN_BW
    return -c + np.exp(
        np.arange(1, num + 1)
        * (-np.log(high_freq + c) + np.log(low_freq + c))
        / num
    ) * (high_freq + c)


def centre_freqs(fs: float, num: int, f_min: float) -> np.ndarray:
    """Ascending center freqs (channel 0 is the lowest frequency)."""
    return erb_space(f_min, fs / 2.0, num)[::-1].copy()


class ErbCoeffs(NamedTuple):
    """Per-channel cascade coefficients (see lsm_tpu.ops.gammatone)."""

    a0: np.ndarray
    a1: np.ndarray          # (4, C)
    b1: np.ndarray
    b2: np.ndarray
    gain: np.ndarray


@functools.lru_cache(maxsize=None)
def make_erb_coeffs(fs: float, num_channels: int, f_min: float) -> ErbCoeffs:
    """Slaney's MakeERBFilters in float64 (public formulas, Apple TR #35)."""
    cf = centre_freqs(fs, num_channels, f_min).astype(np.float64)
    T = 1.0 / fs
    erb = ((cf / _EAR_Q) ** 1.0 + _MIN_BW**1.0) ** 1.0
    B = 1.019 * 2.0 * np.pi * erb

    arg = 2.0 * cf * np.pi * T
    vec = np.exp(2j * arg)

    A0 = T * np.ones_like(cf)
    B1 = -2.0 * np.cos(arg) / np.exp(B * T)
    B2 = np.exp(-2.0 * B * T)

    rt_pos = np.sqrt(3.0 + 2.0**1.5)
    rt_neg = np.sqrt(3.0 - 2.0**1.5)
    common = -T * np.exp(-(B * T))

    k11 = np.cos(arg) + rt_pos * np.sin(arg)
    k12 = np.cos(arg) - rt_pos * np.sin(arg)
    k13 = np.cos(arg) + rt_neg * np.sin(arg)
    k14 = np.cos(arg) - rt_neg * np.sin(arg)

    A11, A12, A13, A14 = (common * k for k in (k11, k12, k13, k14))

    gain_arg = np.exp(1j * arg - B * T)
    gain = np.abs(
        (vec - gain_arg * k11)
        * (vec - gain_arg * k12)
        * (vec - gain_arg * k13)
        * (vec - gain_arg * k14)
        * (T * np.exp(B * T) / (-1.0 / np.exp(B * T) + 1.0 + vec * (1.0 - np.exp(B * T))))
        ** 4
    )

    return ErbCoeffs(
        a0=A0,
        a1=np.stack([A11, A12, A13, A14]),
        b1=B1,
        b2=B2,
        gain=gain,
    )


def _round_half_away(x: float) -> int:
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


@functools.lru_cache(maxsize=None)
def gtgram_strides(fs: float, window_time: float, hop_time: float, n_samples: int):
    """Window/hop geometry exactly as the pip package computes it."""
    nwin = _round_half_away(window_time * fs)
    hop = _round_half_away(hop_time * fs)
    n_cols = int(math.floor((n_samples - nwin) / hop)) + 1
    return nwin, hop, n_cols


def _section_coeffs(fs: float, channels: int, f_min: float):
    """(n0 (C,), n1 (4, C), b1 (C,), b2 (C,)) float64: section k is
    (n0 + n1[k] z^-1) / (1 + b1 z^-1 + b2 z^-2), the 1/gain factor split
    evenly across the four sections (gain ~1e-12; folding it into one
    section drives that section's state to ~1e10)."""
    coeffs = make_erb_coeffs(fs, channels, f_min)
    g4 = coeffs.gain ** 0.25
    return (coeffs.a0 / g4, np.stack([coeffs.a1[k] / g4 for k in range(4)]),
            coeffs.b1, coeffs.b2)


@functools.lru_cache(maxsize=None)
def cascade_coeffs(fs: float, channels: int, f_min: float) -> np.ndarray:
    """Kernel B1/B3's operand, (C, 11) float64: per channel n0, alpha1,
    alpha2, beta1[0..3], beta2[0..3] of the cascade in delta-operator
    transposed direct form II (delta = z - 1),

        y = n0 x + w1;  w1 += beta1_k x - alpha1 y + w2;  w2 += beta2_k x - alpha2 y

    with alpha1 = 2 + b1, alpha2 = 1 + b1 + b2, beta1_k = 2 n0 + n1_k and
    beta2_k = n0 + n1_k, formed here in float64 so that the float32 operand
    rounds each once. Its states relate to the TDF2 states (s1, s2) of
    `_block_iir_matrices` by w1 = s1, w2 = s1 + s2."""
    n0, n1, b1, b2 = _section_coeffs(fs, channels, f_min)
    return np.stack([n0, 2.0 + b1, 1.0 + b1 + b2, *(2.0 * n0 + n1), *(n0 + n1)], axis=1)


@functools.lru_cache(maxsize=None)
def _block_iir_matrices64(fs: float, channels: int, f_min: float, L: int):
    """Exact block-form matrices of the 4-biquad cascade, per channel:

        y_block = x_block @ M_yx + s @ M_sy
        s'      = x_block @ M_xs + s @ M_ss

    obtained in float64 by running the sequential TDF2 filter on basis
    vectors (L input impulses + 8 unit states; state 2k + j is section k's
    s_{j+1}). Returns (M_yx (C,L,L), M_sy (C,8,L), M_xs (C,L,8), M_ss
    (C,8,8)) float64.
    """
    C = channels
    a0, n1, b1, b2 = _section_coeffs(fs, channels, f_min)
    n0 = np.stack([a0] * 4)

    N = L + 8
    x_basis = np.zeros((N, L))
    x_basis[:L] = np.eye(L)
    state = np.zeros((C, N, 4, 2))
    for k in range(4):
        for j in range(2):
            state[:, L + 2 * k + j, k, j] = 1.0

    y_out = np.zeros((C, N, L))
    for t in range(L):
        x = np.broadcast_to(x_basis[:, t], (C, N)).copy()
        for k in range(4):
            s1 = state[:, :, k, 0]
            s2 = state[:, :, k, 1]
            y = n0[k][:, None] * x + s1
            state[:, :, k, 0] = n1[k][:, None] * x - b1[:, None] * y + s2
            state[:, :, k, 1] = -b2[:, None] * y
            x = y
        y_out[:, :, t] = x

    s_flat = state.reshape(C, N, 8)
    return (np.ascontiguousarray(y_out[:, :L]), np.ascontiguousarray(y_out[:, L:]),
            np.ascontiguousarray(s_flat[:, :L]), np.ascontiguousarray(s_flat[:, L:]))


@functools.lru_cache(maxsize=None)
def _block_iir_matrices(fs: float, channels: int, f_min: float, L: int):
    """`_block_iir_matrices64` rounded to float32, as lsm_tpu returns them."""
    return tuple(m.astype(np.float32) for m in _block_iir_matrices64(fs, channels, f_min, L))


@functools.lru_cache(maxsize=None)
def _quadratic_matrices(fs: float, channels: int, f_min: float, g: int):
    """Host constants of the reference's two-phase split (kept for parity
    with lsm_tpu; the fused Hopper kernel B1 does not need the split):
    w_xq (g, 16C) = [W_xs | W_w], g_quad (8, 8, C), m_ss_t (8, 8, C)."""
    m_yx, m_sy, m_xs, m_ss = [
        m.astype(np.float64) for m in _block_iir_matrices(fs, channels, f_min, g)
    ]
    C = channels
    w_w = np.einsum("csm,clm->cls", m_sy, m_yx)
    w_xs_cols = np.ascontiguousarray(m_xs.transpose(1, 2, 0)).reshape(g, 8 * C)
    w_w_cols = np.ascontiguousarray(w_w.transpose(1, 2, 0)).reshape(g, 8 * C)
    w_xq = np.concatenate([w_xs_cols, w_w_cols], axis=1).astype(np.float32)
    g_quad = np.einsum("csm,ctm->stc", m_sy, m_sy).astype(np.float32)
    m_ss_t = np.ascontiguousarray(m_ss.transpose(1, 2, 0)).astype(np.float32)
    return w_xq, g_quad, m_ss_t


@functools.lru_cache(maxsize=None)
def block_system(fs: float, channels: int, f_min: float, g: int,
                 dtype=np.float32) -> np.ndarray:
    """The four block matrices as ONE (C, g+8, g+8) system per channel,
    acting on z = [x_block (g); state (8)]:

        rows m < g:   y_m  = sum_j K[c, m, j] z_j
        rows g + t:   s'_t = sum_j K[c, g+t, j] z_j

    The plain twin's operand, in float32 (lsm_tpu's matrices) or float64
    (the exact reference chip_smoke.py holds the kernels to)."""
    m_yx, m_sy, m_xs, m_ss = _block_iir_matrices64(fs, channels, f_min, g)
    k = np.zeros((channels, g + 8, g + 8), dtype)
    k[:, :g, :g] = m_yx.transpose(0, 2, 1)       # [c, m, l] = M_yx[c, l, m]
    k[:, :g, g:] = m_sy.transpose(0, 2, 1)       # [c, m, s] = M_sy[c, s, m]
    k[:, g:, :g] = m_xs.transpose(0, 2, 1)       # [c, t, l] = M_xs[c, l, t]
    k[:, g:, g:] = m_ss.transpose(0, 2, 1)       # [c, t, s] = M_ss[c, s, t]
    return k


CONVERSION_TIME = 0.1    # s: one serving hop, the kernels' state-conversion period


def conversion_period(fs: float, g: int) -> int:
    """Sub-blocks of g samples in one serving hop (CONVERSION_TIME): 20
    at 16 kHz and g = 80. Kernels B1/B3 convert their cascade state between
    the block form's TDF2 and their delta form once a period."""
    return max(1, _round_half_away(CONVERSION_TIME * fs) // g)


@functools.lru_cache(maxsize=None)
def filterbank(fs: float, channels: int, f_min: float, g: int,
               device: torch.device, dtype: torch.dtype = torch.float32):
    """The operands of kernels B1/B3 and their twins at sub-block length g,
    made once per device: `cascade_coeffs` for the kernels and
    `block_system` for the plain twins, in float32 (or float64, the
    exact reference), and the kernels' `conversion_period`."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return gtgram_kernel.Filterbank(
        torch.as_tensor(cascade_coeffs(fs, channels, f_min).astype(np_dtype)).to(device),
        torch.as_tensor(block_system(fs, channels, f_min, g, np_dtype)).to(device),
        conversion_period(fs, g))


def gtgram_chunk(
    wave: torch.Tensor,
    state: torch.Tensor,
    fs: float,
    channels: int,
    f_min: float,
    g: int,
    conv_sub: int | None = None,
):
    """One chunk of the block scan from a carried cascade state.
    wave (B, n_sub*g) float32, state (B, 8, C) -> (final state (B, 8, C),
    sub-block energies (n_sub, B, C)): kernel B3 on CUDA, its plain twin on
    the CPU. Chunked calls that thread the state are bit-equal to one call
    over the whole signal where each chunk is a whole number of the
    kernel's conversion periods (`conv_sub` sub-blocks, default one
    serving hop)."""
    fb = filterbank(fs, channels, f_min, g, wave.device)
    return gtgram_kernel.chunk(wave.contiguous(), fb, state.contiguous(), conv_sub)


def gtgram_iir_scan(
    blocks: torch.Tensor,
    init_state: torch.Tensor,
    fs: float,
    channels: int,
    f_min: float,
    g: int,
):
    """lsm_tpu's `gtgram_iir_scan` with its layouts: blocks (n_sub, B, g)
    scan-major, init_state (B, 8, C) -> (final_state (B, 8, C),
    sub_energy (n_sub, B, C))."""
    n_sub, B, _ = blocks.shape
    wave = blocks.transpose(0, 1).reshape(B, n_sub * g)
    return gtgram_chunk(wave, init_state, fs, channels, f_min, g)


@functools.lru_cache(maxsize=None)
def _gammatone_fft_weights(fs: float, n_fft: int, channels: int, f_min: float) -> np.ndarray:
    """(C, 1 + n_fft // 2) float32 squared-magnitude response of each
    gammatone channel (complex float64 in NumPy, as lsm_tpu builds it)."""
    coeffs = make_erb_coeffs(fs, channels, f_min)
    freqs = np.linspace(0.0, fs / 2.0, 1 + n_fft // 2)
    z = np.exp(2j * np.pi * freqs / fs)
    zinv = 1.0 / z
    den = 1.0 + coeffs.b1[:, None] * zinv + coeffs.b2[:, None] * zinv**2
    h = np.ones_like(den)
    for k in range(4):
        num = coeffs.a0[:, None] + coeffs.a1[k][:, None] * zinv
        h = h * (num / den)
    h = h / coeffs.gain[:, None]
    return (np.abs(h) ** 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fft_weights_on(fs: float, n_fft: int, channels: int, f_min: float,
                    device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_gammatone_fft_weights(fs, n_fft, channels, f_min)).to(device)


def gtgram_fft(
    wave: torch.Tensor,
    fs: float,
    window_time: float,
    hop_time: float,
    channels: int,
    f_min: float,
) -> torch.Tensor:
    """The FFT-weighted gammatone approximation (`fft_gtgram`).
    wave (B, S) float32 -> (B, C, n_cols).

    A Hann-windowed STFT with the gtgram window and hop, no center padding,
    zero-padded to n_fft, the next power of two at or above the window
    (400 -> 512 at the flagship), each bin's power weighted by each
    channel's |H(f)|^2, then sqrt(band / n_fft)."""
    S = wave.shape[-1]
    nwin, hop, n_cols = gtgram_strides(fs, window_time, hop_time, S)
    n_fft = 1 << (nwin - 1).bit_length()
    frames = wave.unfold(-1, nwin, hop)[:, :n_cols] * window_on(nwin, wave.device)
    win_power = float(np.sum(hann_window(nwin) ** 2))
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2) / win_power     # (B, n_cols, n_freqs)
    weights = _fft_weights_on(fs, n_fft, channels, f_min, wave.device)
    band = torch.matmul(weights, power.transpose(-1, -2))       # (B, C, n_cols)
    return torch.sqrt(band / n_fft)


def gtgram_iir(
    wave: torch.Tensor,
    fs: float,
    window_time: float,
    hop_time: float,
    channels: int,
    f_min: float,
) -> torch.Tensor:
    """Exact gammatone spectrogram. wave: (B, S) float32 -> (B, C, n_cols).

    Sub-block energies from kernel B1 (its plain twin on CPU tensors), then
    window w sums sub-blocks [w*hop/g, w*hop/g + nwin/g) and the result is
    sqrt(energy / nwin)."""
    B, S = wave.shape
    nwin, hop, n_cols = gtgram_strides(fs, window_time, hop_time, S)
    g = math.gcd(hop, nwin)
    n_sub = -(-S // g)
    pad = n_sub * g - S
    wave = wave.to(torch.float32)
    if pad:
        wave = torch.nn.functional.pad(wave, (0, pad))
    fb = filterbank(fs, channels, f_min, g, wave.device)
    sub = gtgram_kernel.sub_energy(wave.contiguous(), fb)     # (n_sub, B, C)

    w_per, h_per = nwin // g, hop // g
    span = (n_cols - 1) * h_per + 1
    win = sub[0:span:h_per]
    for j in range(1, w_per):
        win = win + sub[j:j + span:h_per]                        # (n_cols, B, C)
    return torch.sqrt(win / nwin).permute(1, 2, 0)
