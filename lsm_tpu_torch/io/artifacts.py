"""The two stage artifacts between the pipeline's stages (copies of
lsm_tpu/io/artifacts.py: same file names and .npz schemas, so either
package and the reference's stage scripts read what the other writes):

- speech_spike_dataset_pure_redundancy.npz: X_spikes uint8 (N, C, T),
  y_labels int32 (N,)
- lsm_features_larger.npz: X_train_features, y_train, X_test_features,
  y_test, feature_set (str), leak_variance_divisor (NaN for None)
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import logging

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


def load_spike_dataset(path: Path) -> SpikeDataset:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Dataset not found at '{path}'")
    data = np.load(path)
    return SpikeDataset(x_spikes=data["X_spikes"], y_labels=data["y_labels"])


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


def load_features(path: Path) -> FeatureArtifact:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(
            f"Dataset file not found: '{path}'. Run the feature extraction stage first."
        )
    # Pickle-free: loading a pickle from an untrusted .npz runs arbitrary
    # code, and every member this package writes is a plain array. The one
    # case that needs pickle is a reference-format artifact that saved
    # leak_variance_divisor=None as an object scalar; npz members load
    # lazily, so the ValueError fires at that member alone, which is then
    # re-read with pickle and a warning.
    data = np.load(path, allow_pickle=False)
    try:
        lvd = data["leak_variance_divisor"]
    except ValueError:
        logging.getLogger(__name__).warning(
            "'%s' stores leak_variance_divisor as a pickled object "
            "(reference-format None); re-reading that member with "
            "allow_pickle=True — only load artifacts you trust.", path,
        )
        with np.load(path, allow_pickle=True) as trusted:
            lvd = trusted["leak_variance_divisor"]
    lvd_val = None
    try:
        f = float(lvd)
        lvd_val = None if np.isnan(f) else f
    except (TypeError, ValueError):
        lvd_val = None
    return FeatureArtifact(
        x_train=data["X_train_features"],
        y_train=data["y_train"],
        x_test=data["X_test_features"],
        y_test=data["y_test"],
        feature_set=str(data["feature_set"]),
        leak_variance_divisor=lvd_val,
    )
