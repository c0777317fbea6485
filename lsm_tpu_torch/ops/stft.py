"""Batched power STFT (port of lsm_tpu/ops/stft.py).

librosa.stft's defaults as the reference's melspectrogram uses them:
n_fft = 2048, hop 160, win_length = n_fft, a periodic Hann window,
center=True with zero padding, power 2. The window and the frame starts are
NumPy constants copied from lsm_tpu (tests hold them bit-equal). The frames
are a strided view of the padded signal, materialized once by the window
product; the FFT is torch.fft.rfft (cuFFT on the card, pocketfft on the
CPU), which rounds differently from lsm_tpu's at ~1e-7 relative.

`counts` (as ops/_build.py's `launches`) advances with every `stft_power`
call: `frames`, the frames transformed, and `bytes`, the bytes of the
tensors the call creates, by their shapes (the padded signal, the windowed
frames, the complex spectrum, the two squares and their sum).
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch


counts: collections.Counter = collections.Counter()


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (scipy.signal.get_window('hann', n)), float32."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _frame_starts(num_samples: int, n_fft: int, hop: int) -> np.ndarray:
    # center=True pads n_fft // 2 on both sides; frame f covers
    # padded[f*hop : f*hop + n_fft]. librosa counts 1 + (padded_len - n_fft)
    # // hop frames: 1 + S // hop for even n_fft, one fewer for odd n_fft
    # (total pad n_fft - 1), where the simpler form would read one frame
    # past the padded end.
    n_frames = 1 + (num_samples + 2 * (n_fft // 2) - n_fft) // hop
    return (np.arange(n_frames) * hop).astype(np.int32)


@functools.lru_cache(maxsize=None)
def window_on(n: int, device: torch.device) -> torch.Tensor:
    """hann_window(n) as a tensor on `device`, made once per device."""
    return torch.as_tensor(hann_window(n)).to(device)


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., num_samples) -> (..., n_frames, n_fft) with center zero-padding:
    a view of the padded signal, frame f starting at _frame_starts[f]."""
    num_samples = audio.shape[-1]
    pad = n_fft // 2
    padded = torch.nn.functional.pad(audio, (pad, pad))
    n_frames = _frame_starts(num_samples, n_fft, hop).shape[0]
    return padded.unfold(-1, n_fft, hop)[..., :n_frames, :]


def stft_power(audio: torch.Tensor, n_fft: int = 2048, hop_length: int = 160) -> torch.Tensor:
    """|STFT|^2 of (..., num_samples) float32 audio ->
    (..., 1 + n_fft // 2, n_frames) float32, frequency-major as librosa."""
    frames = frame_signal(audio, n_fft, hop_length) * window_on(n_fft, audio.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    n_frames = frames.numel() // n_fft
    padded = audio.numel() // audio.shape[-1] * (audio.shape[-1] + 2 * (n_fft // 2))
    counts["frames"] += n_frames
    counts["bytes"] += 4 * (padded + frames.numel()) + (8 + 3 * 4) * spec.numel()
    return power.transpose(-1, -2)
