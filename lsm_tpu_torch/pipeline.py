"""The batch classification path as library functions
(port of lsm_tpu/pipeline.py, single device).

    audio -> featurize_audio_array -> spikes (host uint8, the stage-1
    artifact) -> extract_lsm_features (calibration, reservoir init,
    diagnostics, features, scaler) -> train_and_evaluate (L-BFGS readout,
    predictions on the test split, report)

Every function takes an explicit torch device; nothing moves to another
device silently. The reference's mesh and --check branches are not ported
(ROADMAP A14 and A15).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lsm_tpu_torch.config import FEATURE_SETS, PipelineConfig
from lsm_tpu_torch.io import artifacts
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models.calibration import calibrate_weight
from lsm_tpu_torch.models.diagnostics import DiagnosticsReport, run_network_diagnostics
from lsm_tpu_torch.models.frontend import featurize_batch
from lsm_tpu_torch.models.sparse import SparseReservoir, init_reservoir_sparse
from lsm_tpu_torch.readout import logistic, metrics, scaler

log = logging.getLogger("lsm_tpu_torch")


def _batched(n: int, batch_size: int):
    for start in range(0, n, batch_size):
        yield start, min(start + batch_size, n)


def featurize_audio_array(
    cfg: PipelineConfig, audio: np.ndarray, device: torch.device
) -> np.ndarray:
    """(N, num_samples) audio (float32, int16 or uint8 mu-law) -> (N, C, T)
    uint8 spikes on the host, featurized on `device` in cfg.batch_size
    batches."""
    out = []
    for start, stop in _batched(audio.shape[0], cfg.batch_size):
        batch = torch.as_tensor(audio[start:stop]).to(device)
        out.append(featurize_batch(batch, cfg.frontend).cpu().numpy())
    return np.concatenate(out, axis=0)


@dataclasses.dataclass
class ExtractionResult:
    artifact: artifacts.FeatureArtifact
    w_critico: float
    mean_weight: float
    diagnostics: Optional[DiagnosticsReport]
    reservoir: Union[res.Reservoir, SparseReservoir]
    scaler: scaler.Scaler


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """Per-class draw counts summing to n_draws: floor of the proportional
    share, the remainder to the largest fractional parts, ties broken by
    rng (scikit-learn's rule, so the split below equals its split)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(
    x: np.ndarray, y: np.ndarray, test_size: float, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stratified train/test split equal to scikit-learn's
    train_test_split(x, y, test_size=test_size, random_state=seed,
    stratify=y), which the reference package calls when sklearn is
    installed, re-derived in NumPy so that the split (and with it the frozen
    accuracy band) does not depend on sklearn being present. The reference's
    own NumPy fallback draws a different split."""
    n = len(y)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size must be a fraction in (0, 1), got {test_size}")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    classes, y_idx, counts = np.unique(y, return_inverse=True, return_counts=True)
    if counts.min() < 2 or min(n_train, n_test) < len(classes):
        raise ValueError(
            f"cannot stratify {n} samples of {len(classes)} classes (smallest "
            f"class {counts.min()}) into {n_train} train / {n_test} test"
        )
    class_indices = np.split(np.argsort(y_idx, kind="stable"), np.cumsum(counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(counts, n_train, rng)
    t_i = _approximate_mode(counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    train = rng.permutation(train)
    test = rng.permutation(test)
    return x[train], x[test], y[train], y[test]


def init_reservoir(cfg: PipelineConfig, n_channels: int, mean_weight: float,
                   device: torch.device) -> Union[res.Reservoir, SparseReservoir]:
    """The block-sparse reservoir where cfg.reservoir.use_sparse() (>= 4096
    neurons with N % 128 == 0 unless forced), else the dense one; a dense
    reservoir of >= 4096 neurons raises NotImplementedError and never turns
    sparse silently."""
    if cfg.reservoir.use_sparse():
        log.info("Using block-sparse reservoir (%d neurons)", cfg.reservoir.num_neurons)
        return init_reservoir_sparse(cfg.reservoir, n_channels, mean_weight=mean_weight,
                                     device=device)
    return res.init_reservoir(cfg.reservoir, n_channels, mean_weight=mean_weight,
                              device=device)


def extract_lsm_features(
    cfg: PipelineConfig,
    ds: artifacts.SpikeDataset,
    device: torch.device,
    output_path: Optional[Path] = None,
    run_diagnostics: bool = True,
) -> ExtractionResult:
    """Split, calibrate w_critico, build the reservoir, diagnose it, and
    extract standardized features for both splits."""
    x_train, x_test, y_train, y_test = stratified_split(
        ds.x_spikes, ds.y_labels, cfg.test_size, cfg.split_seed
    )
    wc, mean_weight = calibrate_weight(
        cfg.reservoir, x_train[: min(500, len(x_train))], cfg.multiplier
    )
    log.info("Theoretical w_critico: %.8f", wc)
    log.info("Using weight: %.8f (multiplier: %.2f)", mean_weight, cfg.multiplier)
    if cfg.reservoir.leak_variance_divisor:
        log.info(
            "Using Heterogeneous Leak. Divisor: %s",
            cfg.reservoir.leak_variance_divisor,
        )

    reservoir = init_reservoir(cfg, ds.x_spikes.shape[1], mean_weight, device)
    report = None
    if run_diagnostics:
        report = run_network_diagnostics(reservoir, x_train)
        log.info("\n%s", report.render())

    keys = tuple(FEATURE_SETS[cfg.feature_set])
    log.info("Extracting feature set: '%s'", cfg.feature_set)

    def extract(split: np.ndarray, desc: str) -> torch.Tensor:
        t0 = time.perf_counter()
        out = [
            res.extract_features(
                reservoir, torch.as_tensor(split[start:stop]).to(device), keys
            )
            for start, stop in _batched(split.shape[0], cfg.batch_size)
        ]
        feats = torch.cat(out, dim=0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        log.info("%s: %d samples in %.2fs (%.1f utt/s)",
                 desc, split.shape[0], dt, split.shape[0] / max(dt, 1e-9))
        return feats

    train_feat = extract(x_train, "Training")
    test_feat = extract(x_test, "Testing")
    st = scaler.fit_scaler(train_feat)
    artifact = artifacts.FeatureArtifact(
        x_train=scaler.transform(st, train_feat).cpu().numpy(),
        y_train=y_train,
        x_test=scaler.transform(st, test_feat).cpu().numpy(),
        y_test=y_test,
        feature_set=cfg.feature_set,
        leak_variance_divisor=cfg.reservoir.leak_variance_divisor,
    )
    if output_path is not None:
        artifacts.save_features(output_path, artifact)
    return ExtractionResult(
        artifact=artifact,
        w_critico=wc,
        mean_weight=mean_weight,
        diagnostics=report,
        reservoir=reservoir,
        scaler=st,
    )


@dataclasses.dataclass
class TrainResult:
    accuracy: float
    report: metrics.ClassificationReport
    readout: logistic.LogisticReadout
    n_iters: int


def train_and_evaluate(
    cfg: PipelineConfig,
    artifact: artifacts.FeatureArtifact,
    device: torch.device,
    class_names: Optional[Sequence[str]] = None,
) -> TrainResult:
    """Fit the logistic readout on the train split and score the test split."""
    names = list(class_names or cfg.commands)
    x_train = torch.as_tensor(artifact.x_train, dtype=torch.float32).to(device)
    y_train = torch.as_tensor(artifact.y_train, dtype=torch.int64).to(device)
    x_test = torch.as_tensor(artifact.x_test, dtype=torch.float32).to(device)
    readout, iters = logistic.fit_logistic(
        x_train, y_train, num_classes=len(names), l2_c=cfg.readout.l2_c,
        max_iter=cfg.readout.max_iter, tol=cfg.readout.tol,
    )
    y_pred = logistic.predict(readout, x_test).cpu().numpy()
    rep = metrics.classification_report(artifact.y_test, y_pred, names)
    log.info("Test Accuracy: %.2f%%", rep.accuracy * 100)
    return TrainResult(accuracy=rep.accuracy, report=rep, readout=readout, n_iters=iters)


def run_pipeline_arrays(
    cfg: PipelineConfig, audio: np.ndarray, labels: np.ndarray, device: torch.device
) -> Tuple[TrainResult, ExtractionResult]:
    """Audio arrays in, trained and evaluated readout out, on `device`."""
    spikes = featurize_audio_array(cfg, audio, device)
    ds = artifacts.SpikeDataset(x_spikes=spikes, y_labels=labels)
    ext = extract_lsm_features(cfg, ds, device)
    result = train_and_evaluate(cfg, ext.artifact, device)
    return result, ext
