"""The Speech Commands directory walk and synthetic spoken-word corpora
(copies of lsm_tpu/io/dataset.py; tests/test_torch_package.py and
tests/test_torch_io.py hold them equal to lsm_tpu's: the same files, labels
and warnings, the same arrays and WAV bytes from the same seed).

`index_speech_commands` walks <base>/<command>/*.wav as the reference's
create_dataset.py does: sorted glob, a cap per class, a warning and a skip
for a missing directory or an empty glob.

`synthetic_audio_batch` is the easy corpus (class-specific tone bundles);
`synthetic_audio_batch_hard` is the frozen hard benchmark behind the
accuracy band: classes come in pairs with the same spectrum that differ
only in a temporal cue (onset, gap, duration or modulation depth), so only
the reservoir's temporal statistics separate a pair.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DatasetIndex:
    files: List[Path]
    labels: np.ndarray            # (N,) int32
    class_names: Sequence[str]
    warnings: List[str]


def index_speech_commands(
    base_path: Path,
    commands: Sequence[str],
    max_samples_per_class: int = 1000,
) -> DatasetIndex:
    """The files under <base>/<command>/*.wav, sorted and capped per class,
    with class index = position in `commands`."""
    base_path = Path(base_path)
    files: List[Path] = []
    labels: List[int] = []
    warnings: List[str] = []
    for label_idx, command in enumerate(commands):
        command_dir = base_path / command
        if not command_dir.is_dir():
            warnings.append(f"Directory not found, skipping: {command_dir}")
            continue
        wavs = sorted(command_dir.glob("*.wav"))[:max_samples_per_class]
        if not wavs:
            warnings.append(f"No files found for '{command}'")
            continue
        files.extend(wavs)
        labels.extend([label_idx] * len(wavs))
    return DatasetIndex(
        files=files,
        labels=np.asarray(labels, np.int32),
        class_names=commands,
        warnings=warnings,
    )


def synthetic_word(
    class_idx: int,
    rng: np.random.Generator,
    sample_rate: int = 16000,
    duration: float = 1.0,
) -> np.ndarray:
    """One easy-corpus utterance: class-specific formant-like tones with
    class-dependent onset, chirp and amplitude modulation, plus noise and
    random gain and jitter."""
    n = int(sample_rate * duration)
    t = np.arange(n) / sample_rate
    base = 220.0 * (1.18 ** (class_idx % 12))
    chirp = (-1) ** class_idx * (30.0 + 12.0 * (class_idx % 5))
    onset = 0.08 + 0.02 * (class_idx % 7) + rng.uniform(-0.02, 0.02)
    dur = 0.45 + 0.04 * (class_idx % 4) + rng.uniform(-0.05, 0.05)
    am = 3.0 + (class_idx % 6)

    env = np.clip((t - onset) / 0.03, 0, 1) * np.clip((onset + dur - t) / 0.1, 0, 1)
    env = np.clip(env, 0, 1) * (0.6 + 0.4 * np.cos(2 * np.pi * am * (t - onset)) ** 2)
    jitter = rng.uniform(0.97, 1.03)
    sig = np.zeros(n)
    for h, w in ((1.0, 1.0), (2.1, 0.5), (3.3, 0.3)):
        f = base * h * jitter + chirp * t * h
        sig += w * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    sig *= env
    sig += 0.02 * rng.standard_normal(n)
    peak = np.abs(sig).max() + 1e-9
    return (0.5 * sig / peak * rng.uniform(0.7, 1.0)).astype(np.float32)


def synthetic_audio_batch(
    n_per_class: int,
    n_classes: int,
    seed: int = 42,
    sample_rate: int = 16000,
    duration: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, T) float32 audio + (N,) int32 labels, class-interleaved."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(n_classes):
        for _ in range(n_per_class):
            xs.append(synthetic_word(c, rng, sample_rate, duration))
            ys.append(c)
    return np.stack(xs), np.asarray(ys, np.int32)


def synthetic_word_hard(
    class_idx: int,
    rng: np.random.Generator,
    sample_rate: int = 16000,
    duration: float = 1.0,
    snr_db_range: Tuple[float, float] = (3.0, 12.0),
) -> np.ndarray:
    """One hard-corpus utterance. Pair p = classes (2p, 2p+1) shares one
    formant stack; the pair's cue cycles with p over onset time, a
    mid-utterance gap, duration and modulation depth, drawn from
    overlapping Gaussians. Pitch jitter, phase, AM rate and envelope
    direction are random and carry no label; noise at a random SNR."""
    n = int(sample_rate * duration)
    t = np.arange(n) / sample_rate
    pair = class_idx // 2
    variant = class_idx % 2

    base = 180.0 * (1.31 ** pair)
    harmonics = ((1.0, 1.0), (2.4, 0.55), (3.9, 0.35))

    cue = pair % 4
    onset = rng.normal(0.14, 0.02)
    dur = rng.normal(0.55, 0.04)
    gap_len = 0.0
    mod_depth = float(np.clip(rng.normal(0.5, 0.25), 0.0, 1.0))
    if cue == 0:
        onset = rng.normal((0.14, 0.30)[variant], 0.055)
    elif cue == 1:
        gap_len = max(rng.normal((0.06, 0.17)[variant], 0.038), 0.0)
    elif cue == 2:
        dur = rng.normal((0.42, 0.60)[variant], 0.062)
    else:
        mod_depth = float(
            np.clip(rng.normal((0.15, 0.85)[variant], 0.22), 0.0, 1.0)
        )
    onset = float(np.clip(onset, 0.02, 0.45))
    dur = float(np.clip(dur, 0.2, 0.9))

    am = rng.uniform(2.0, 6.0)
    ramp = np.clip((t - onset) / dur, 0, 1)
    env_dir = ramp if rng.random() < 0.5 else (1.0 - ramp)
    gate = np.clip((t - onset) / 0.02, 0, 1) * np.clip((onset + dur - t) / 0.05, 0, 1)
    # Square-ish AM of depth mod_depth with mean 1 whatever the depth, so
    # mean energy carries nothing of the depth cue.
    carrier = np.tanh(4.0 * np.cos(2 * np.pi * am * (t - onset)))
    env = np.clip(gate, 0, 1) * (0.35 + 0.65 * env_dir) * (
        1.0 + mod_depth * 0.95 * carrier
    )
    if gap_len > 0.0:
        gap_mid = onset + 0.5 * dur + rng.uniform(-0.03, 0.03)
        env = env * (1.0 - np.clip(1.0 - np.abs(t - gap_mid) / (0.5 * gap_len), 0, 1))

    jitter = rng.uniform(0.92, 1.08)
    sig = np.zeros(n)
    for h, w in harmonics:
        f = base * h * jitter
        sig += w * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    sig *= env

    sig_rms = np.sqrt(np.mean(sig**2)) + 1e-12
    snr_db = rng.uniform(*snr_db_range)
    noise_rms = sig_rms / (10 ** (snr_db / 20))
    sig = sig + noise_rms * rng.standard_normal(n)
    peak = np.abs(sig).max() + 1e-9
    return (0.5 * sig / peak * rng.uniform(0.7, 1.0)).astype(np.float32)


def synthetic_audio_batch_hard(
    n_per_class: int,
    n_classes: int = 12,
    seed: int = 42,
    sample_rate: int = 16000,
    duration: float = 1.0,
    snr_db_range: Tuple[float, float] = (3.0, 12.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """The frozen hard benchmark: (N, T) float32 audio + (N,) int32 labels."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(n_classes):
        for _ in range(n_per_class):
            xs.append(
                synthetic_word_hard(c, rng, sample_rate, duration, snr_db_range)
            )
            ys.append(c)
    return np.stack(xs), np.asarray(ys, np.int32)


def write_synthetic_corpus(
    base_path: Path,
    commands: Sequence[str],
    n_per_class: int,
    seed: int = 42,
    sample_rate: int = 16000,
) -> None:
    """Write an easy-corpus utterance per file in Speech Commands layout:
    <base>/<command>/{i:05d}.wav, 16-bit PCM."""
    from lsm_tpu_torch.io.wav import write_wav

    rng = np.random.default_rng(seed)
    base_path = Path(base_path)
    for c, command in enumerate(commands):
        d = base_path / command
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n_per_class):
            write_wav(d / f"{i:05d}.wav", synthetic_word(c, rng, sample_rate), sample_rate)
