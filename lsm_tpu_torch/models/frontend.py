"""Stage-1 featurizer: audio batch -> spike trains
(port of lsm_tpu/models/frontend.py).

    audio -> {mel | gammatone} spectrogram -> dB (power_to_db with ref =
    max, or 20 log10 with an 80 dB floor) -> per-sample min-max -> linear
    zoom to time_bins -> 4-threshold hysteresis encoder -> redundancy repeat

Both of the reference's filterbanks and all three gammatone methods:

  - mel: `stft.stft_power` -> `mel.apply_mel` -> `db.power_to_db`;
  - gammatone "fft": `gammatone.gtgram_fft`, the FFT-weighted
    approximation;
  - gammatone "iir" and "iir-xla": the exact cascade, `gammatone.gtgram_iir`
    (kernel B1 on the card, its plain twin on the CPU). In lsm_tpu the two
    are two TPU implementations of one function at equal numerics, the
    Pallas kernel and the XLA block scan; here both run kernel B1, so that
    no plain twin sits on a user's path on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from lsm_tpu_torch.config import FrontendConfig
from lsm_tpu_torch.ops import db as db_ops
from lsm_tpu_torch.ops import gammatone as gt
from lsm_tpu_torch.ops import hysteresis, mel, resample, stft
from lsm_tpu_torch.ops.ulaw import decode_ulaw
from lsm_tpu_torch.utils import checks
from lsm_tpu_torch.utils.profiling import span


def spectrogram_db(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, S) float32 -> (B, n_filters, n_frames) dB spectrogram. The mel
    branch opens two spans of its own: `lsm.frontend.stft` (framing, window,
    rFFT, power) and `lsm.frontend.mel` (filterbank product, power_to_db)."""
    if cfg.filterbank == "mel":
        hop = max(1, cfg.num_samples // cfg.time_bins)
        with span("lsm.frontend.stft"):
            power = stft.stft_power(audio, cfg.n_fft, hop)
        with span("lsm.frontend.mel"):
            fb = mel.filterbank_on(
                cfg.sample_rate, cfg.n_fft, cfg.n_filters, cfg.mel_fmin,
                cfg.mel_fmax if cfg.mel_fmax is not None else cfg.sample_rate / 2.0,
                audio.device,
            )
            return db_ops.power_to_db(mel.apply_mel(power, fb), top_db=cfg.power_top_db)
    if cfg.filterbank != "gammatone":
        raise ValueError(f"unknown filterbank: {cfg.filterbank!r}")
    hop_time = cfg.num_samples / (cfg.sample_rate * cfg.time_bins)
    spec = _dispatch_gtgram(cfg)(
        audio, cfg.sample_rate, cfg.gt_window_time, hop_time,
        cfg.n_filters, cfg.gt_f_min,
    )
    return db_ops.amplitude_to_db_floor(spec, top_db=cfg.power_top_db)


def _dispatch_gtgram(cfg: FrontendConfig):
    """The gtgram of cfg.gammatone_method: "fft" the STFT approximation,
    "iir" and "iir-xla" the exact cascade (kernel B1 on the card)."""
    if cfg.gammatone_method == "fft":
        return gt.gtgram_fft
    if cfg.gammatone_method in ("iir", "iir-xla"):
        return gt.gtgram_iir
    raise ValueError(f"unknown gammatone_method: {cfg.gammatone_method!r}")


def featurize_batch(audio: torch.Tensor, cfg: FrontendConfig,
                    check: Optional[str] = None) -> torch.Tensor:
    """(B, num_samples) audio on any device -> (B, n_filters * R,
    time_bins * n_thresholds) uint8 spikes on the same device.

    The wire formats are the reference's three: float samples in [-1, 1],
    int16 PCM (divided by 32768 on the device) or uint8 G.711 mu-law.
    With `check` (the --check context) non-finite audio and a non-finite
    spectrogram raise (utils/checks.py)."""
    with span("lsm.frontend"):
        with span("lsm.frontend.spectrogram"):
            if audio.dtype == torch.uint8:
                audio = decode_ulaw(audio)
            elif audio.dtype == torch.int16:
                audio = audio.to(torch.float32) / 32768.0
            elif not audio.dtype.is_floating_point:
                raise TypeError(
                    f"featurize_batch audio dtype {audio.dtype} is not part of the "
                    "wire contract (float samples, int16 PCM, or uint8 mu-law)"
                )
            if check:
                checks.check_finite(audio, check, "audio samples")
            spec_db = spectrogram_db(audio.to(torch.float32), cfg)
            if check:
                checks.check_finite(spec_db, check, "spectrogram values")
        with span("lsm.frontend.normalize"):
            spec_norm = db_ops.minmax_normalize(spec_db)
            spec_norm = resample.zoom_time_axis(spec_norm, cfg.time_bins)
        with span("lsm.frontend.encode"):
            spikes = hysteresis.hysteresis_encode(
                spec_norm, cfg.spike_thresholds, cfg.hysteresis_gap
            )
            if cfg.redundancy_factor > 1:
                spikes = torch.repeat_interleave(spikes, cfg.redundancy_factor, dim=-2)
    return spikes
