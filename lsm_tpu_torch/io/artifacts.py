"""The two stage artifacts the pipeline writes (the writers of
lsm_tpu/io/artifacts.py, same file names and .npz schemas, so lsm_tpu's
loaders and the reference's stage scripts read them):

- speech_spike_dataset_pure_redundancy.npz: X_spikes uint8 (N, C, T),
  y_labels int32 (N,)
- lsm_features_larger.npz: X_train_features, y_train, X_test_features,
  y_test, feature_set (str), leak_variance_divisor (NaN for None)
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

SPIKE_DATASET_FILENAME = "speech_spike_dataset_pure_redundancy.npz"
FEATURES_FILENAME = "lsm_features_larger.npz"


class SpikeDataset(NamedTuple):
    x_spikes: np.ndarray  # uint8 (N, C, T)
    y_labels: np.ndarray  # int32 (N,)


class FeatureArtifact(NamedTuple):
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    feature_set: str
    leak_variance_divisor: Optional[float]


def save_spike_dataset(path: Path, ds: SpikeDataset) -> None:
    x = np.ascontiguousarray(ds.x_spikes, dtype=np.uint8)
    y = np.ascontiguousarray(ds.y_labels, dtype=np.int32)
    if x.ndim != 3 or y.ndim != 1 or x.shape[0] != y.shape[0]:
        raise ValueError(f"bad spike dataset shapes: {x.shape}, {y.shape}")
    np.savez_compressed(path, X_spikes=x, y_labels=y)


def save_features(path: Path, art: FeatureArtifact) -> None:
    np.savez_compressed(
        path,
        X_train_features=art.x_train,
        y_train=art.y_train,
        X_test_features=art.x_test,
        y_test=art.y_test,
        feature_set=art.feature_set,
        leak_variance_divisor=(
            np.nan if art.leak_variance_divisor is None else art.leak_variance_divisor
        ),
    )
