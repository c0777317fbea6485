"""Stage-1 featurizer: audio batch -> spike trains
(port of lsm_tpu/models/frontend.py).

    audio -> exact gammatone spectrogram (kernel B1) -> dB with an 80 dB
    floor -> per-sample min-max -> linear zoom to time_bins -> 4-threshold
    hysteresis encoder -> redundancy repeat

Only the exact gammatone ("iir") path is ported; the mel filterbank and the
FFT gammatone approximation are ROADMAP A8.
"""

from __future__ import annotations

import torch

from lsm_tpu_torch.config import FrontendConfig
from lsm_tpu_torch.ops import db as db_ops
from lsm_tpu_torch.ops import gammatone as gt
from lsm_tpu_torch.ops import hysteresis, resample
from lsm_tpu_torch.ops.ulaw import decode_ulaw


def spectrogram_db(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, S) float32 -> (B, n_filters, n_cols) dB spectrogram."""
    if cfg.filterbank != "gammatone" or cfg.gammatone_method != "iir":
        raise NotImplementedError(
            f"filterbank={cfg.filterbank!r} gammatone_method="
            f"{cfg.gammatone_method!r} is not ported yet (ROADMAP A8: mel "
            "frontend and the FFT gammatone); use the exact gammatone 'iir'"
        )
    hop_time = cfg.num_samples / (cfg.sample_rate * cfg.time_bins)
    spec = gt.gtgram_iir(
        audio, cfg.sample_rate, cfg.gt_window_time, hop_time,
        cfg.n_filters, cfg.gt_f_min,
    )
    return db_ops.amplitude_to_db_floor(spec, top_db=cfg.power_top_db)


def featurize_batch(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, num_samples) audio on any device -> (B, n_filters * R,
    time_bins * n_thresholds) uint8 spikes on the same device.

    The wire formats are the reference's three: float samples in [-1, 1],
    int16 PCM (divided by 32768 on the device) or uint8 G.711 mu-law."""
    if audio.dtype == torch.uint8:
        audio = decode_ulaw(audio)
    elif audio.dtype == torch.int16:
        audio = audio.to(torch.float32) / 32768.0
    elif not audio.dtype.is_floating_point:
        raise TypeError(
            f"featurize_batch audio dtype {audio.dtype} is not part of the "
            "wire contract (float samples, int16 PCM, or uint8 mu-law)"
        )
    spec_db = spectrogram_db(audio.to(torch.float32), cfg)
    spec_norm = db_ops.minmax_normalize(spec_db)
    spec_norm = resample.zoom_time_axis(spec_norm, cfg.time_bins)
    spikes = hysteresis.hysteresis_encode(
        spec_norm, cfg.spike_thresholds, cfg.hysteresis_gap
    )
    if cfg.redundancy_factor > 1:
        spikes = torch.repeat_interleave(spikes, cfg.redundancy_factor, dim=-2)
    return spikes
