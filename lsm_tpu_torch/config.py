"""Configuration of the port (the fields of lsm_tpu/config.py it reads).

The port imports nothing of the reference package, so it keeps its own
copy of the config dataclasses, holding only the fields the ported slice
reads. Every default equals lsm_tpu's (tests/test_torch_config.py asserts
it field by field); lsm_tpu/config.py cites each field's source in the
original scripts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# The 12 keyword classes.
COMMANDS_12 = (
    "yes", "no", "up", "visual", "backward", "stop",
    "bird", "cat", "nine", "eight", "zero", "follow",
)

# The full Speech Commands v0.02 vocabulary (the 35-class config).
COMMANDS_35 = (
    "backward", "bed", "bird", "cat", "dog", "down", "eight", "five",
    "follow", "forward", "four", "go", "happy", "house", "learn", "left",
    "marvin", "nine", "no", "off", "on", "one", "right", "seven", "sheila",
    "six", "stop", "three", "tree", "two", "up", "visual", "wow", "yes",
    "zero",
)

# Feature-set key lists.
FEATURE_SETS = {
    "all": [
        "spike_counts", "spike_variances", "mean_spike_times",
        "first_spike_times", "last_spike_times", "mean_isi",
        "isi_variances", "burst_counts",
    ],
    "rate": ["spike_counts", "spike_variances", "burst_counts"],
    "timing": ["mean_spike_times", "first_spike_times", "last_spike_times"],
    "rhythm": ["mean_isi", "isi_variances"],
    "original": [
        "spike_counts", "spike_variances", "mean_spike_times",
        "mean_isi", "isi_variances",
    ],
}


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Featurization and spike encoding. Only the exact gammatone
    (filterbank "gammatone", method "iir") is ported (ROADMAP A8); the mel
    fields are kept, in lsm_tpu's field order, because a sharded corpus is
    fingerprinted by `repr` of this config and a model bundle stores its
    `asdict`."""

    sample_rate: int = 16000
    duration: float = 1.0
    time_bins: int = 100
    n_filters: int = 128
    filterbank: str = "gammatone"
    spike_thresholds: Tuple[float, ...] = (0.70, 0.80, 0.90, 0.95)
    hysteresis_gap: float = 0.1
    redundancy_factor: int = 1
    n_fft: int = 2048
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None   # None -> sample_rate / 2
    power_top_db: float = 80.0
    gt_window_time: float = 0.025
    gt_f_min: float = 50.0
    gammatone_method: str = "iir"

    @property
    def num_samples(self) -> int:
        return int(self.sample_rate * self.duration)

    @property
    def n_thresholds(self) -> int:
        return len(self.spike_thresholds)

    @property
    def spike_train_length(self) -> int:
        return self.time_bins * self.n_thresholds


@dataclasses.dataclass(frozen=True)
class ReservoirConfig:
    """The LIF reservoir, dense or block-sparse. Recurrent weights are drawn
    N(mean_weight, (|mean_weight| * sqrt(weight_variance))^2); each input
    channel projects to `input_fanout` random neurons with `input_weight`;
    a spike whose ISI is <= burst_isi_max is a burst; `spike_variances`
    uses n_rate_windows equal windows."""

    num_neurons: int = 1000
    num_output_neurons: int = 400
    leak_coefficient: float = 0.01
    refractory_period: int = 2
    membrane_threshold: float = 2.0
    small_world_p: float = 0.1
    small_world_k: int = 200
    mean_weight: float = 0.0           # set after w_critico calibration
    weight_variance: float = 10.0
    leak_variance_divisor: Optional[float] = None
    input_fanout: int = 8
    input_weight: float = 1.0
    burst_isi_max: int = 5
    n_rate_windows: int = 10
    # Block-sparse reservoirs (models/sparse.py): the random long-range
    # partner blocks each 128-neuron source block rewires into.
    sparse_partner_blocks: int = 4
    # None = block-sparse for >= 4096 neurons with N % 128 == 0, else dense.
    sparse: Optional[bool] = None
    seed: int = 42

    def use_sparse(self) -> bool:
        if self.sparse is not None:
            return self.sparse
        return self.num_neurons >= 4096 and self.num_neurons % 128 == 0


@dataclasses.dataclass(frozen=True)
class ReadoutConfig:
    """The logistic readout (scikit-learn's C, max_iter and lbfgs tol)."""

    l2_c: float = 1.0
    max_iter: int = 1000
    tol: float = 1e-4


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    reservoir: ReservoirConfig = dataclasses.field(default_factory=ReservoirConfig)
    readout: ReadoutConfig = dataclasses.field(default_factory=ReadoutConfig)
    feature_set: str = "original"
    multiplier: float = 0.6
    max_samples_per_class: int = 1000
    test_size: float = 0.2
    split_seed: int = 42
    commands: Tuple[str, ...] = COMMANDS_12
    batch_size: int = 512              # utterances per featurize/extract batch
    # Decoder -> device audio format of the WAV stages: "int16" PCM (exact
    # for PCM16 files, half the float32 bytes) or "ulaw" (uint8 G.711, a
    # quarter, lossy); featurize_batch takes both.
    audio_wire: str = "int16"


def frontend_to_dict(cfg: FrontendConfig) -> dict:
    """JSON-serializable FrontendConfig (sharded-dataset metadata)."""
    return dataclasses.asdict(cfg)


def corpus_meta(cfg: PipelineConfig) -> dict:
    """Sharded-dataset writer metadata: the featurization and vocabulary a
    corpus was built with (the keys lsm_tpu's writers record)."""
    return {
        "frontend": frontend_to_dict(cfg.frontend),
        "class_names": list(cfg.commands),
    }


def frontend_from_dict(d: dict) -> FrontendConfig:
    """Inverse of frontend_to_dict. Tolerates unknown keys (metadata written
    by a newer version) and turns JSON lists back into the tuple fields."""
    fields = {f.name for f in dataclasses.fields(FrontendConfig)}
    kw = {k: v for k, v in d.items() if k in fields}
    if "spike_thresholds" in kw:
        kw["spike_thresholds"] = tuple(kw["spike_thresholds"])
    return FrontendConfig(**kw)
