"""Traffic: the synthetic spoken-word corpora and how a cell's audio is cut
from them.

`synthetic_word`, `synthetic_audio_batch`, `synthetic_word_hard` and
`synthetic_audio_batch_hard` are copies of lsm_tpu_torch/io/dataset.py's
(benchmark/tests/test_bench_corpus.py holds them equal): the easy corpus
and the frozen hard corpus (3-12 dB SNR) behind every speed figure of the
port. The yardstick keeps its own copy so that it does not move when the
program does.

A pool is `parts` independent sub-corpora of `per_class` utterances a
class, sub-corpus j drawn from its own seed (`part_seed(seed, j)`), made by
one worker process each (spawned, joined before the pool returns): the
draws of one corpus are sequential, so this is how the set-up uses the
host's cores. The serving schedule gives every stream a sequence of pool
utterances and a phase, so that streams cross utterance boundaries at
different hops, laid out in set-up so that a hop's chunk costs nothing to
cut.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Tuple

import numpy as np


def synthetic_word(class_idx: int, rng: np.random.Generator, sample_rate: int = 16000,
                   duration: float = 1.0) -> np.ndarray:
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


def synthetic_audio_batch(n_per_class: int, n_classes: int, seed: int = 42,
                          sample_rate: int = 16000,
                          duration: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(n_classes):
        for _ in range(n_per_class):
            xs.append(synthetic_word(c, rng, sample_rate, duration))
            ys.append(c)
    return np.stack(xs), np.asarray(ys, np.int32)


def synthetic_word_hard(class_idx: int, rng: np.random.Generator, sample_rate: int = 16000,
                        duration: float = 1.0,
                        snr_db_range: Tuple[float, float] = (3.0, 12.0)) -> np.ndarray:
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
        mod_depth = float(np.clip(rng.normal((0.15, 0.85)[variant], 0.22), 0.0, 1.0))
    onset = float(np.clip(onset, 0.02, 0.45))
    dur = float(np.clip(dur, 0.2, 0.9))

    am = rng.uniform(2.0, 6.0)
    ramp = np.clip((t - onset) / dur, 0, 1)
    env_dir = ramp if rng.random() < 0.5 else (1.0 - ramp)
    gate = np.clip((t - onset) / 0.02, 0, 1) * np.clip((onset + dur - t) / 0.05, 0, 1)
    carrier = np.tanh(4.0 * np.cos(2 * np.pi * am * (t - onset)))
    env = np.clip(gate, 0, 1) * (0.35 + 0.65 * env_dir) * (1.0 + mod_depth * 0.95 * carrier)
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


def synthetic_audio_batch_hard(n_per_class: int, n_classes: int = 12, seed: int = 42,
                               sample_rate: int = 16000, duration: float = 1.0,
                               snr_db_range: Tuple[float, float] = (3.0, 12.0)
                               ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(n_classes):
        for _ in range(n_per_class):
            xs.append(synthetic_word_hard(c, rng, sample_rate, duration, snr_db_range))
            ys.append(c)
    return np.stack(xs), np.asarray(ys, np.int32)


GENERATORS = {"easy": synthetic_audio_batch, "hard": synthetic_audio_batch_hard}


def part_seed(seed: int, part: int) -> int:
    """The seed of sub-corpus `part` of a run seeded with `seed` (any
    non-negative integer, wider than 32 bits too)."""
    return int(np.random.SeedSequence([int(seed), int(part)]).generate_state(2, np.uint32)
               .astype(np.uint64) @ np.array([1 << 32, 1], np.uint64))


def _part(kind: str, per_class: int, classes: int, seed: int) -> np.ndarray:
    return GENERATORS[kind](per_class, classes, seed=seed)[0]


class Pool:
    """(parts * per_class * classes, 16000) float32: the sub-corpora in
    order, made while the caller does other set-up. With `workers` > 1
    they are made in that many spawned processes (at most `parts`), all
    joined when the block ends; with 1, in this process by `result()`."""

    def __init__(self, kind: str, parts: int, per_class: int, classes: int, seed: int,
                 workers: int):
        self.args = [(kind, per_class, classes, part_seed(seed, j)) for j in range(parts)]
        self.workers = min(workers, parts)
        self.ex = None

    def __enter__(self):
        if self.workers > 1:
            ctx = multiprocessing.get_context("spawn")
            self.ex = ProcessPoolExecutor(max_workers=self.workers, mp_context=ctx)
            self.futures = [self.ex.submit(_part, *a) for a in self.args]
        return self

    def result(self) -> np.ndarray:
        if self.ex is None:
            return np.concatenate([_part(*a) for a in self.args])
        return np.concatenate([f.result() for f in self.futures])

    def __exit__(self, *exc):
        if self.ex is not None:
            self.ex.shutdown(wait=True, cancel_futures=True)
        return False


def to_wire(audio: np.ndarray) -> np.ndarray:
    """float samples in [-1, 1] -> int16 PCM, the serving wire."""
    return np.clip(audio * 32768.0, -32768.0, 32767.0).astype(np.int16)


class StreamSchedule:
    """Which audio each of `n_streams` streams sends at each hop: stream s
    plays `cycle_hops * chunk_len` samples of pool utterances seq[s, 0],
    seq[s, 1], ... back to back, entered at chunk phase[s] of the first,
    so utterance boundaries fall on different hops for different streams,
    and then plays them again. The tape holds every hop of the cycle as one
    contiguous (n_streams, chunk_len) chunk, so cutting a hop's chunk is
    free: `chunk(h)` is a view of the tape."""

    def __init__(self, wire: np.ndarray, n_streams: int, chunk_len: int, cycle_hops: int,
                 seed: int):
        n_utt, n_samples = wire.shape
        per_utt = n_samples // chunk_len
        chunks = wire[:, :per_utt * chunk_len].reshape(n_utt * per_utt, chunk_len)
        rng = np.random.default_rng(part_seed(seed, 1 << 20))
        self.phase = rng.integers(0, per_utt, size=n_streams)
        self.seq = rng.integers(0, n_utt, size=(n_streams, cycle_hops // per_utt + 2))
        pos = np.arange(cycle_hops)[:, None] + self.phase[None, :]        # (hops, streams)
        utt = self.seq[np.arange(n_streams)[None, :], pos // per_utt]
        self.tape = chunks[utt * per_utt + pos % per_utt]                  # (hops, streams, L)
        self.cycle_hops = cycle_hops

    def chunk(self, h: int) -> np.ndarray:
        return self.tape[h % self.cycle_hops]
