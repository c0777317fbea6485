"""The batch classification path as library functions
(port of lsm_tpu/pipeline.py).

    WAV tree -> create_spike_dataset (or audio arrays ->
    featurize_audio_array) -> spikes (host uint8, the stage-1 artifact, in
    memory or sharded) -> extract_lsm_features (calibration, reservoir
    init, diagnostics, features, scaler) -> train_and_evaluate (L-BFGS
    readout, predictions on the test split, report)

    a spike corpus + a trained reservoir, scaler and readout ->
    classify_spikes_streaming -> predictions

    a sharded spike corpus -> extract_and_train_streaming (stage 2+3 with
    flat host memory: ridge statistics or a feature buffer on the device)
    -> a trained reservoir, scaler and readout, and the test report

Every function takes an explicit torch device; nothing moves to another
device silently. With cfg.check (--check) each stage boundary is validated
on the device where lsm_tpu validates it (utils/checks.py).

Every stage is data-parallel over the ranks of a process group by default
(lsm_tpu's convention): with more than one rank, `mesh="auto"` puts every
rank on the data axis (parallel/mesh.py), each rank featurizes and
simulates its rows of every batch (B1, B2 or B5 in each rank), and the
readout fits all-reduce their sums. Every rank calls the stage with the
same inputs and returns the same result; files are written by rank 0.
`mesh=None` forces the single-device path; a `Mesh` is used as given, and
its device is the rank's compute device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lsm_tpu_torch.config import FEATURE_SETS, PipelineConfig, corpus_meta
from lsm_tpu_torch.io import artifacts, dataset
from lsm_tpu_torch.io.sharded import ShardedSpikeDataset, ShardedSpikeDatasetWriter
from lsm_tpu_torch.io.wav import load_audio_batch
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models.calibration import calibrate_weight
from lsm_tpu_torch.models.diagnostics import DiagnosticsReport, run_network_diagnostics
from lsm_tpu_torch.models.frontend import featurize_batch
from lsm_tpu_torch.models.sparse import SparseReservoir, init_reservoir_sparse
from lsm_tpu_torch.parallel import mesh as meshlib
from lsm_tpu_torch.parallel.mesh import Mesh
from lsm_tpu_torch.parallel.sharded import extract_features_dp, featurize_dp
from lsm_tpu_torch.readout import logistic, metrics, scaler
from lsm_tpu_torch.utils import checks

log = logging.getLogger("lsm_tpu_torch")

# The `mesh` argument of the stages:
#   "auto" (default) -> every rank on the data axis when there are >1 ranks;
#   None             -> the single-device path;
#   a Mesh           -> used as given.
MeshArg = Union[str, None, Mesh]


def _resolve_mesh(mesh: MeshArg, device: torch.device) -> Optional[Mesh]:
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"unknown mesh spec: {mesh!r}")
        return meshlib.auto_mesh(device=device)
    if mesh is not None and mesh.device.type != torch.device(device).type:
        raise ValueError(f"the mesh computes on {mesh.device}, the stage was given {device}")
    return mesh


def _effective_batch(batch_size: int, mesh: Optional[Mesh]) -> int:
    """Round the compute batch up to a shard multiple of the data axis."""
    if mesh is None:
        return batch_size
    n = mesh.shape[meshlib.DATA_AXIS]
    return -(-batch_size // n) * n


def _place_batch(x: np.ndarray, mesh: Optional[Mesh], device: torch.device) -> torch.Tensor:
    """Host batch -> the device: this rank's rows under a mesh (the batch
    must divide over the data axis), else all of it."""
    if mesh is None:
        return torch.as_tensor(np.asarray(x)).to(device)
    return meshlib.shard_batch(np.asarray(x), mesh)


def _batched(n: int, batch_size: int):
    for start in range(0, n, batch_size):
        yield start, min(start + batch_size, n)


def _write(mesh: Optional[Mesh], fn, *args) -> None:
    """A file write: on rank 0 only, the other ranks waiting for it."""
    if meshlib.is_primary():
        fn(*args)
    meshlib.barrier(mesh)


def _featurize_to_host(audio: np.ndarray, fcfg, device: torch.device,
                       check: Optional[str] = None, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Featurize one batch on `device` and bring the spikes to the host.
    With `check` (the --check context) the featurizer validates its input
    and spectrogram, and the raw spikes must be 0/1 before they leave the
    device. Under a mesh each rank featurizes its rows (the batch padded to
    the data axis) and the spikes are gathered."""
    if mesh is None:
        spikes = featurize_batch(torch.as_tensor(audio).to(device), fcfg, check=check)
    else:
        padded, n_real = meshlib.pad_to_multiple(np.asarray(audio),
                                                 mesh.shape[meshlib.DATA_AXIS])
        spikes = featurize_dp(_place_batch(padded, mesh, device), fcfg, mesh, check=check)
    if check:
        checks.check_spikes(spikes, check)
    if mesh is not None:
        spikes = meshlib.host_local(spikes, mesh)[:n_real]
    return spikes.cpu().numpy()


def featurize_audio_array(
    cfg: PipelineConfig, audio: np.ndarray, device: torch.device, mesh: MeshArg = "auto"
) -> np.ndarray:
    """(N, num_samples) audio (float32, int16 or uint8 mu-law) -> (N, C, T)
    uint8 spikes on the host, featurized on `device` in cfg.batch_size
    batches (data-parallel over the mesh)."""
    mesh = _resolve_mesh(mesh, device)
    bs = _effective_batch(cfg.batch_size, mesh)
    check = "featurize_audio_array" if cfg.check else None
    out = [_featurize_to_host(audio[start:stop], cfg.frontend, device, check, mesh)
           for start, stop in _batched(audio.shape[0], bs)]
    return np.concatenate(out, axis=0)


def _fingerprint(cfg: PipelineConfig, files: Sequence[Path]) -> str:
    """What sharded spikes depend on: the frontend, the audio wire (int16
    is exact for PCM16 files, mu-law is lossy) and the input file list
    (file indices anchor a resume). lsm_tpu hashes the same bytes, so either
    package resumes the other's shards."""
    h = hashlib.sha256()
    h.update(repr(cfg.frontend).encode())
    h.update(f"audio_wire={cfg.audio_wire}".encode())
    for p in files:
        h.update(str(p).encode())
        h.update(b"\0")
    return h.hexdigest()


def create_spike_dataset(
    cfg: PipelineConfig,
    base_path: Path,
    device: torch.device,
    output_path: Optional[Path] = None,
    sharded_output: Optional[Path] = None,
    shard_size: int = 8192,
    compress: bool = True,
    mesh: MeshArg = "auto",
):
    """Featurize a Speech Commands-style tree (<base>/<command>/*.wav) into
    spike trains on `device`, cfg.batch_size files at a time, on the
    cfg.audio_wire wire. The next batch decodes on a worker thread (the
    native C++ decoder, io/native.py, where it builds; else NumPy) while
    the main thread runs the device work; results are consumed in order. A
    file that fails to decode is logged and skipped, its label with it.
    Under a mesh every rank decodes the whole batch and featurizes its rows.

    Returns an artifacts.SpikeDataset (and writes it to `output_path` if
    given), or with `sharded_output` a ShardedSpikeDataset handle over
    shards written as the batches finish (by rank 0); a rerun under the
    same fingerprint resumes after the last complete shard."""
    mesh = _resolve_mesh(mesh, device)
    idx = dataset.index_speech_commands(base_path, cfg.commands, cfg.max_samples_per_class)
    for w in idx.warnings:
        log.warning(w)
    if not idx.files:
        raise RuntimeError("No audio files were successfully processed.")

    writer = None
    first_file = 0
    if sharded_output is not None:
        if meshlib.is_primary():
            writer = ShardedSpikeDatasetWriter(
                sharded_output, shard_size, resume=True, compress=compress,
                fingerprint=_fingerprint(cfg, idx.files), meta=corpus_meta(cfg),
            )
            first_file = writer.resume_file_index + 1
            if first_file:
                log.info("Resuming featurization at file %d/%d (%d shards complete)",
                         first_file, len(idx.files), len(writer.completed_shards()))
        if mesh is not None:             # rank 0's resume point, on every rank
            first_file = int(meshlib.replicate_to_mesh(
                torch.tensor([first_file], device=mesh.device), mesh)[0])
        else:
            meshlib.barrier(None)        # rank 0 has created the directory

    fcfg = cfg.frontend
    bs = _effective_batch(cfg.batch_size, mesh)
    chunks = [(start + first_file, stop + first_file)
              for start, stop in _batched(len(idx.files) - first_file, bs)]

    def decode(start: int, stop: int):
        return load_audio_batch(idx.files[start:stop], fcfg.sample_rate, fcfg.duration,
                                dtype=cfg.audio_wire)

    spikes_out, labels_out = [], []
    n_total = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(decode, *chunks[0]) if chunks else None
        for i, (start, stop) in enumerate(chunks):
            audio, kept, errors = fut.result()
            if i + 1 < len(chunks):
                fut = pool.submit(decode, *chunks[i + 1])
            for path, err in errors:
                log.warning("Error loading %s: %s", path, err)
            if audio.shape[0] == 0:
                continue
            spikes = _featurize_to_host(audio, fcfg, device,
                                        "create_spike_dataset" if cfg.check else None, mesh)
            labels = idx.labels[start:stop][kept]
            n_total += len(kept)
            if sharded_output is not None:
                if writer is not None:
                    writer.append(spikes, labels, np.arange(start, stop)[kept])
            else:
                spikes_out.append(spikes)
                labels_out.append(labels)

    if sharded_output is not None:
        if writer is not None:
            manifest = writer.close()
            log.info("Sharded dataset: %d samples in %d shards (%.1f utt/s)",
                     manifest["num_samples"], len(manifest["shards"]),
                     n_total / max(time.perf_counter() - t0, 1e-9))
        meshlib.barrier(mesh)
        handle = ShardedSpikeDataset(sharded_output)
        # A resumed run's num_samples counts earlier runs' shards too; a
        # rate divides only what this call featurized.
        handle.featurized_this_run = n_total
        return handle
    if not spikes_out:
        raise RuntimeError("No audio files were successfully processed.")
    x = np.concatenate(spikes_out, axis=0)
    y = np.concatenate(labels_out, axis=0)
    log.info("Dataset created: shape=%s avg spikes/sample=%.1f (%.1f utt/s)",
             x.shape, x.sum() / len(x), len(x) / max(time.perf_counter() - t0, 1e-9))
    ds = artifacts.SpikeDataset(x_spikes=x, y_labels=y)
    if output_path is not None:
        _write(mesh, artifacts.save_spike_dataset, output_path, ds)
    return ds


def load_spike_dataset_any(path: Path) -> artifacts.SpikeDataset:
    """Load a classic .npz spike dataset or a sharded dataset directory."""
    path = Path(path)
    if path.is_dir():
        return ShardedSpikeDataset(path).load_all()
    return artifacts.load_spike_dataset(path)


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
    neurons with N % 128 == 0 unless forced), else the dense one (drawn on
    `device` from 4096 neurons on, as lsm_tpu draws it)."""
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
    mesh: MeshArg = "auto",
) -> ExtractionResult:
    """Split, calibrate w_critico, build the reservoir, diagnose it, and
    extract standardized features for both splits. Under a mesh the
    calibration's spike counts are all-reduced, the weights replicated from
    rank 0, and each rank simulates its rows of every batch (B2 or B5)."""
    mesh = _resolve_mesh(mesh, device)
    x_train, x_test, y_train, y_test = stratified_split(
        ds.x_spikes, ds.y_labels, cfg.test_size, cfg.split_seed
    )
    wc, mean_weight = calibrate_weight(
        cfg.reservoir, x_train[: min(500, len(x_train))], cfg.multiplier, mesh=mesh
    )
    log.info("Theoretical w_critico: %.8f", wc)
    log.info("Using weight: %.8f (multiplier: %.2f)", mean_weight, cfg.multiplier)
    if cfg.reservoir.leak_variance_divisor:
        log.info(
            "Using Heterogeneous Leak. Divisor: %s",
            cfg.reservoir.leak_variance_divisor,
        )

    dev = mesh.device if mesh is not None else device
    reservoir = init_reservoir(cfg, ds.x_spikes.shape[1], mean_weight, dev)
    if mesh is not None:
        meshlib.replicate_to_mesh(reservoir, mesh)
    report = None
    if run_diagnostics:
        report = run_network_diagnostics(reservoir, x_train)
        log.info("\n%s", report.render())

    keys = tuple(FEATURE_SETS[cfg.feature_set])
    log.info("Extracting feature set: '%s'", cfg.feature_set)
    bs = _effective_batch(cfg.batch_size, mesh)

    def extract_batch(x: np.ndarray) -> torch.Tensor:
        if mesh is None:
            return res.extract_features(reservoir, torch.as_tensor(x).to(dev), keys)
        padded, n_real = meshlib.pad_to_multiple(x, mesh.shape[meshlib.DATA_AXIS])
        local = extract_features_dp(reservoir, _place_batch(padded, mesh, dev), keys, mesh)
        return meshlib.host_local(local, mesh)[:n_real]

    def extract(split: np.ndarray, desc: str) -> torch.Tensor:
        t0 = time.perf_counter()
        out = [extract_batch(split[start:stop])
               for start, stop in _batched(split.shape[0], bs)]
        feats = torch.cat(out, dim=0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        log.info("%s: %d samples in %.2fs (%.1f utt/s)",
                 desc, split.shape[0], dt, split.shape[0] / max(dt, 1e-9))
        return feats

    train_feat = extract(x_train, "Training")
    test_feat = extract(x_test, "Testing")
    if cfg.check:
        checks.check_features(train_feat, "extract_lsm_features (train)")
        checks.check_features(test_feat, "extract_lsm_features (test)")
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
        _write(mesh, artifacts.save_features, output_path, artifact)
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
    mesh: MeshArg = "auto",
) -> TrainResult:
    """Fit the logistic readout on the train split and score the test split.
    Under a mesh the fit is data-parallel (`logistic.fit_logistic_dp`) and
    each rank predicts its rows of the test split."""
    mesh = _resolve_mesh(mesh, device)
    names = list(class_names or cfg.commands)
    if mesh is not None:
        readout, iters = logistic.fit_logistic_dp(
            artifact.x_train, artifact.y_train, num_classes=len(names), mesh=mesh,
            l2_c=cfg.readout.l2_c, max_iter=cfg.readout.max_iter, tol=cfg.readout.tol)
        xt, n_real = meshlib.pad_to_multiple(np.asarray(artifact.x_test, np.float32),
                                             mesh.shape[meshlib.DATA_AXIS])
        y_pred = meshlib.host_local(logistic.predict(readout, _place_batch(xt, mesh, device)),
                                    mesh)[:n_real].cpu().numpy()
        rep = metrics.classification_report(artifact.y_test, y_pred, names)
        log.info("Test Accuracy: %.2f%%", rep.accuracy * 100)
        return TrainResult(accuracy=rep.accuracy, report=rep, readout=readout, n_iters=iters)
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


class InMemorySource:
    """A SpikeDataset behind the `iter_batches` protocol of
    ShardedSpikeDataset, for classify_spikes_streaming."""

    def __init__(self, ds: artifacts.SpikeDataset):
        self.ds = ds

    def iter_batches(self, batch_size: int):
        x, y = self.ds.x_spikes, self.ds.y_labels
        for start, stop in _batched(x.shape[0], batch_size):
            yield artifacts.SpikeDataset(x[start:stop], y[start:stop])


def unpack_spike_bits(packed: torch.Tensor) -> torch.Tensor:
    """(B, C, T // 8) uint8, bits packed little-endian as
    np.packbits(..., bitorder="little") packs them -> (B, C, T) 0/1 uint8,
    on packed's device."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], packed.shape[1], -1)


def spikes_to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host (B, C, T) 0/1 uint8 spikes onto `device`: bit-packed on the host
    and unpacked on the device where T is a multiple of 8 (an eighth of the
    bytes cross the link), else as they are."""
    x = np.asarray(x)
    if x.shape[-1] % 8 == 0:
        packed = torch.as_tensor(np.packbits(x, axis=-1, bitorder="little"))
        return unpack_spike_bits(packed.to(device))
    return torch.tensor(x).to(device)


def classify_spikes_streaming(
    cfg: PipelineConfig,
    source,
    reservoir: Union[res.Reservoir, SparseReservoir],
    readout: logistic.LogisticReadout,
    st: scaler.Scaler,
    device: torch.device,
    mesh: MeshArg = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Classify a spike corpus batch by batch: `source.iter_batches(
    cfg.batch_size)` (a ShardedSpikeDataset streams from disk, host memory
    stays at one batch) -> reservoir features (B2, or B5 for a block-sparse
    reservoir) -> scaler -> predictions, which stay on `device` until the
    end. Batches whose T is a multiple of 8 travel bit-packed (an eighth of
    the bytes) and are unpacked on the device. Returns (predictions, labels),
    (N,) int32 each, in storage order. Under a mesh the modules are
    replicated from rank 0 and each rank classifies its rows of every
    batch; the predictions are gathered at the end."""
    mesh = _resolve_mesh(mesh, device)
    dev = mesh.device if mesh is not None else device
    if mesh is not None:
        meshlib.replicate_to_mesh((reservoir, readout, st), mesh)
    keys = tuple(FEATURE_SETS[cfg.feature_set])
    bs = _effective_batch(cfg.batch_size, mesh)
    preds_dev, n_reals, labels_out = [], [], []
    t0 = time.perf_counter()
    for chunk in source.iter_batches(bs):
        x, n_real = np.asarray(chunk.x_spikes), len(chunk.y_labels)
        if mesh is not None:
            x = meshlib.pad_to_multiple(x, mesh.shape[meshlib.DATA_AXIS])[0]
            x = x[meshlib.local_rows(x.shape[0], mesh)]
        feats = res.extract_features(reservoir, spikes_to_device(x, dev), keys)
        preds_dev.append(logistic.predict(readout, scaler.transform(st, feats)))
        n_reals.append(n_real)
        labels_out.append(np.asarray(chunk.y_labels))
        if len(preds_dev) % 8 == 0 and dev.type == "cuda":
            # Backpressure: bound the batches queued on the card.
            torch.cuda.current_stream(dev).synchronize()
    preds_dev = [meshlib.host_local(p, mesh)[:n] for p, n in zip(preds_dev, n_reals)]
    preds = torch.cat(preds_dev).to(torch.int32).cpu().numpy() if preds_dev \
        else np.zeros(0, np.int32)
    labels = np.concatenate(labels_out).astype(np.int32) if labels_out \
        else np.zeros(0, np.int32)
    dt = time.perf_counter() - t0
    log.info("Classified %d utterances in %.2fs (%.1f utt/s)",
             len(preds), dt, len(preds) / max(dt, 1e-9))
    return preds, labels


# ---------------------------------------------------------------------------
# Constant-memory training at corpus scale (streamed stage 2+3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamingTrainResult:
    accuracy: float
    report: metrics.ClassificationReport
    readout: logistic.LogisticReadout
    scaler: scaler.Scaler
    reservoir: Union[res.Reservoir, SparseReservoir]
    w_critico: float
    mean_weight: float
    n_train: int
    n_test: int
    diagnostics: Optional[DiagnosticsReport]
    # Host clock (time.perf_counter) marks: name -> (start, end) of
    # "calibrate", "fit_pass", "solve" and "eval_pass"; and the fit pass's
    # split in seconds: shard_iter, dispatch (pack + transfer + launch), sync.
    phases: dict
    fit_split: dict


def extract_and_train_streaming(
    cfg: PipelineConfig,
    source,
    device: torch.device,
    class_names: Optional[Sequence[str]] = None,
    alpha: float = 1.0,
    run_diagnostics: bool = True,
    readout: str = "ridge",
    l2_c: float = 1.0,
    max_iter: int = 1000,
    mesh: MeshArg = "auto",
) -> StreamingTrainResult:
    """Fused stage 2+3 over a sharded spike corpus with flat host memory.

    `source` is a ShardedSpikeDataset (or anything with iter_batches(bs,
    mask=), labels() and gather_rows()). Each row is featurized once:

      - the split is extract_lsm_features's (stratified_split on indices),
        the calibration subset its first <= 500 train rows, the reservoir
        `init_reservoir`'s (dense on B2, block-sparse on B5);
      - pass 1 streams the train rows, bit-packed to the device, and folds
        each batch's features into the ridge statistics on the device
        (readout/streaming_fit.py); with readout="logistic" it also writes
        them into one preallocated (n_train, D) float32 buffer on the
        device, real rows only, so the L-BFGS objective is the in-memory
        fit's;
      - finalize_ridge gives the scaler (the train moments) and the ridge
        readout; "logistic" instead standardizes the buffer in place and
        runs fit_logistic on it (the reference readout);
      - pass 2 streams the test rows through the solved readout.

    Every 8 batches the host waits for the device, which bounds the pinned
    batches in flight. The three phase timers of pass 1 (shard iteration,
    pack + transfer + dispatch, device sync) are logged as lsm_tpu logs
    them; with cfg.check every batch's features are validated (a sync a
    batch).

    Under a mesh every rank iterates the same batches (padded to the data
    axis, padding weighted 0) and extracts its rows; each rank's ridge
    statistics are all-reduced once before the solve, the logistic buffer
    holds each rank's own rows and `fit_logistic` all-reduces over them,
    and the test predictions are gathered at the end."""
    from lsm_tpu_torch.readout.streaming_fit import (
        all_reduce_accum, finalize_ridge, init_ridge_accum, update_ridge_accum,
    )

    mesh = _resolve_mesh(mesh, device)
    device = mesh.device if mesh is not None else device

    if readout not in ("ridge", "logistic"):
        raise ValueError(f"readout must be 'ridge' or 'logistic', got {readout!r}")
    names = list(class_names or cfg.commands)
    k = len(names)
    labels_all = np.asarray(source.labels())
    # torch's one_hot raises on a label outside [0, k), without naming the
    # cause; a corpus built with another vocabulary must say so.
    if labels_all.size and (labels_all.min() < 0 or labels_all.max() >= k):
        raise ValueError(
            f"corpus labels span [{labels_all.min()}, {labels_all.max()}] "
            f"but the class vocabulary has {k} entries ({names[:4]}...) — "
            "the sharded dataset was built with a different --vocab/"
            "--commands than this fit was given"
        )
    n = labels_all.shape[0]
    phases = {}
    t_cal = time.perf_counter()
    idx_tr, _, _, _ = stratified_split(np.arange(n), labels_all, cfg.test_size, cfg.split_seed)
    train_mask = np.zeros(n, bool)
    train_mask[np.asarray(idx_tr)] = True

    calib = source.gather_rows(np.asarray(idx_tr)[: min(500, len(idx_tr))])
    wc, mean_weight = calibrate_weight(cfg.reservoir, calib, cfg.multiplier, mesh=mesh)
    log.info("Theoretical w_critico: %.8f", wc)
    log.info("Using weight: %.8f (multiplier: %.2f)", mean_weight, cfg.multiplier)
    reservoir = init_reservoir(cfg, calib.shape[1], mean_weight, device)
    if mesh is not None:
        meshlib.replicate_to_mesh(reservoir, mesh)
    report = None
    if run_diagnostics:
        report = run_network_diagnostics(reservoir, calib)
        log.info("\n%s", report.render())

    keys = tuple(FEATURE_SETS[cfg.feature_set])
    bs = _effective_batch(cfg.batch_size, mesh)
    n_data = 1 if mesh is None else mesh.shape[meshlib.DATA_AXIS]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    phases["calibrate"] = (t_cal, time.perf_counter())

    def local(a: np.ndarray) -> np.ndarray:
        """This rank's rows of a batch padded to the data axis (all of it
        without a mesh)."""
        if mesh is None:
            return a
        a = meshlib.pad_to_multiple(np.asarray(a), n_data)[0]
        return a[meshlib.local_rows(a.shape[0], mesh)]

    def extract(x: np.ndarray) -> torch.Tensor:
        feats = res.extract_features(reservoir, spikes_to_device(local(x), device), keys)
        if cfg.check:
            checks.check_features(feats, "extract_and_train_streaming")
        return feats

    state = None
    feat_buf = None
    # Each rank's rows of the train split (padded batches): the buffer's rows.
    n_slots = len(idx_tr) if mesh is None else -(-len(idx_tr) // bs) * bs // n_data
    y_buf = torch.empty(n_slots, dtype=torch.int64, device=device) \
        if readout == "logistic" else None
    w_buf = torch.zeros(n_slots, dtype=torch.float32, device=device) \
        if readout == "logistic" and mesh is not None else None
    n_train = n_batches = n_rows = 0
    t_iter = t_disp = t_sync = 0.0
    t0 = time.perf_counter()
    it = iter(source.iter_batches(bs, mask=train_mask))
    while True:
        tp = time.perf_counter()
        batch = next(it, None)
        t_iter += time.perf_counter() - tp
        if batch is None:
            break
        tp = time.perf_counter()
        nb = batch.x_spikes.shape[0]
        feats = extract(batch.x_spikes)
        yb = torch.as_tensor(local(np.asarray(batch.y_labels, np.int64))).to(device)
        wb = None
        if mesh is not None:
            wb = torch.as_tensor(local(np.ones(nb, np.float32))).to(device)
        if state is None:
            if mesh is None:
                shift = torch.mean(feats, dim=0)
            else:           # the first batch's mean over every rank's real rows
                shift = meshlib.all_reduce_sum(torch.sum(feats * wb[:, None], dim=0), mesh) \
                    / meshlib.all_reduce_sum(torch.sum(wb), mesh)
            state = init_ridge_accum(shift, k)
        update_ridge_accum(state, feats, yb, wb)
        if readout == "logistic":
            if feat_buf is None:
                feat_buf = torch.empty(n_slots, feats.shape[1], dtype=torch.float32,
                                       device=device)
            m = feats.shape[0]
            feat_buf[n_rows:n_rows + m] = feats
            y_buf[n_rows:n_rows + m] = yb
            if wb is not None:
                w_buf[n_rows:n_rows + m] = wb
            n_rows += m
        n_train += nb
        n_batches += 1
        t_disp += time.perf_counter() - tp
        if n_batches % 8 == 0 and cuda:
            # Backpressure: without it the host runs ahead of the card and
            # keeps every batch in flight pinned.
            tp = time.perf_counter()
            torch.cuda.current_stream(device).synchronize()
            t_sync += time.perf_counter() - tp
    if state is None:
        raise ValueError("streaming fit: no training rows in corpus")
    if mesh is not None:
        all_reduce_accum(state, mesh)
    readout_mod, st = finalize_ridge(state, alpha=alpha)
    if cuda:
        torch.cuda.synchronize(device)
    phases["fit_pass"] = (t0, time.perf_counter())
    dt = phases["fit_pass"][1] - t0
    log.info("Streaming %s fit pass: %d train rows in %.2fs (%.1f utt/s); "
             "phases: shard-iter %.1fs, pack+H2D+dispatch %.1fs, device-sync %.1fs",
             readout, n_train, dt, n_train / max(dt, 1e-9), t_iter, t_disp, t_sync)
    if readout == "logistic":
        # The reference readout on the device-resident buffer, standardized
        # in place: the in-memory path's objective on the same rows.
        t0 = time.perf_counter()
        z = feat_buf[:n_rows].sub_(st.mean).div_(st.scale)
        feat_buf = None
        if mesh is None:
            readout_mod, iters = logistic.fit_logistic(z, y_buf, k, l2_c=l2_c,
                                                       max_iter=max_iter)
        else:
            readout_mod, iters = logistic.fit_logistic(
                z, y_buf[:n_rows], k, l2_c=l2_c, max_iter=max_iter, weights=w_buf[:n_rows],
                mesh=mesh)
        del z
        phases["solve"] = (t0, time.perf_counter())
        log.info("Streaming logistic solve: %d LBFGS iters in %.2fs",
                 int(iters), phases["solve"][1] - t0)

    preds_dev, y_true = [], []
    t0 = time.perf_counter()
    for batch in source.iter_batches(bs, mask=~train_mask):
        feats = extract(batch.x_spikes)
        preds_dev.append(logistic.predict(readout_mod, scaler.transform(st, feats)))
        y_true.append(np.asarray(batch.y_labels))
        if len(preds_dev) % 8 == 0 and cuda:          # the same backpressure
            torch.cuda.current_stream(device).synchronize()
    preds_dev = [meshlib.host_local(p, mesh)[:len(y)] for p, y in zip(preds_dev, y_true)]
    preds = torch.cat(preds_dev).cpu().numpy() if preds_dev else np.zeros(0, np.int64)
    y_test = np.concatenate(y_true) if y_true else np.zeros(0, np.int64)
    phases["eval_pass"] = (t0, time.perf_counter())
    dt = phases["eval_pass"][1] - t0
    log.info("Streaming eval: %d test rows in %.2fs (%.1f utt/s)",
             len(y_test), dt, len(y_test) / max(dt, 1e-9))
    rep = metrics.classification_report(y_test, preds, names)
    log.info("Test Accuracy: %.2f%%", rep.accuracy * 100)
    return StreamingTrainResult(
        accuracy=rep.accuracy, report=rep, readout=readout_mod, scaler=st,
        reservoir=reservoir, w_critico=wc, mean_weight=mean_weight,
        n_train=n_train, n_test=int(len(y_test)), diagnostics=report, phases=phases,
        fit_split={"shard_iter": t_iter, "dispatch": t_disp, "sync": t_sync},
    )


def run_pipeline_arrays(
    cfg: PipelineConfig, audio: np.ndarray, labels: np.ndarray, device: torch.device,
    mesh: MeshArg = "auto",
) -> Tuple[TrainResult, ExtractionResult]:
    """Audio arrays in, trained and evaluated readout out, on `device`
    (data-parallel over the mesh)."""
    spikes = featurize_audio_array(cfg, audio, device, mesh=mesh)
    ds = artifacts.SpikeDataset(x_spikes=spikes, y_labels=labels)
    ext = extract_lsm_features(cfg, ds, device, mesh=mesh)
    result = train_and_evaluate(cfg, ext.artifact, device, mesh=mesh)
    return result, ext
