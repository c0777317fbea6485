"""Corpus-scale streaming trainer benchmark: flat host memory at any size
(the port's counterpart of tools/bench_stream_train.py).

Generates a synthetic sharded spike corpus shard by shard
(`synthetic_audio_batch` in chunks on host worker processes, a new seed a
chunk, featurized on the device, written compressed by
ShardedSpikeDatasetWriter),
then trains on it with pipeline.extract_and_train_streaming and reports:

  - peak RSS per phase (write, calibrate, fit pass, solve, eval pass) and
    the RSS each starts from, from a /proc/self/statm sampler thread,
    beside the corpus's bytes;
  - utterances/s of each pass and the fit pass's split (shard iteration,
    pack + transfer + dispatch, device sync);
  - the share of each pass the device is busy: CUDA events around every
    extract_features call, summed, over the pass's wall.

    python -m lsm_tpu_torch.tools.bench_stream_train --n-utterances 100000 \
        --root build/stream_corpus --readout ridge logistic

An existing complete --root is reused (its writing is skipped). One JSON
object goes to stdout (and to --json if given).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from lsm_tpu_torch.config import COMMANDS_12, PipelineConfig, corpus_meta

_PAGE = 4096


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * _PAGE


class RssSampler:
    """(host time, RSS bytes) every `period` seconds on a daemon thread;
    `peak(t0, t1)` is the largest sample in a window."""

    def __init__(self, period: float = 0.05):
        self.samples: list = []
        self._stop = threading.Event()
        self._period = period
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.samples.append((time.perf_counter(), rss_bytes()))
            self._stop.wait(self._period)

    def peak(self, t0: float, t1: float) -> int:
        inside = [r for t, r in list(self.samples) if t0 <= t <= t1]
        return max(inside, default=rss_bytes())

    def first(self, t0: float, t1: float) -> int:
        """The first sample in the window: the RSS a phase starts from."""
        return next((r for t, r in list(self.samples) if t0 <= t <= t1), rss_bytes())

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


@contextmanager
def extract_events(device: torch.device):
    """Wrap models.reservoir.extract_features (as the pipeline calls it) to
    record, for every call, (host time at the call, CUDA start event, CUDA
    end event); yields the list."""
    from lsm_tpu_torch.models import reservoir as res

    calls, orig = [], res.extract_features

    def timed(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        start.record()
        out = orig(*args, **kw)
        end.record()
        calls.append((t, start, end))
        return out

    res.extract_features = timed if device.type == "cuda" else orig
    try:
        yield calls
    finally:
        res.extract_features = orig


def _generate(args: tuple):
    """One chunk of synthetic_audio_batch, in a worker process."""
    from lsm_tpu_torch.io import dataset

    n_per_class, n_classes, seed = args
    return dataset.synthetic_audio_batch(n_per_class, n_classes, seed=seed)


def write_corpus(root: Path, n_utterances: int, cfg: PipelineConfig, device: torch.device,
                 shard_size: int = 2000, chunk: int = 2400, seed: int = 42) -> dict:
    """Write n_utterances rows (rounded down to a multiple of the
    len(cfg.commands) classes) of synthetic_audio_batch, `chunk` rows a
    seed (seed + the chunk's first row), featurized on `device`, into
    compressed shards under `root`. The chunks' audio is generated by
    worker processes (one a host core, up to 8) while this process
    featurizes and writes. Returns the write's seconds, rows and bytes."""
    from lsm_tpu_torch.io.sharded import ShardedSpikeDatasetWriter
    from lsm_tpu_torch.models.frontend import featurize_batch

    k = len(cfg.commands)
    if chunk % k:
        raise ValueError(f"the chunk ({chunk} rows) must be a multiple of the {k} classes")
    n_utterances -= n_utterances % k
    t0 = time.perf_counter()
    writer = ShardedSpikeDatasetWriter(root, shard_size, resume=False, compress=True,
                                       meta=corpus_meta(cfg))
    starts = list(range(0, n_utterances, chunk))
    jobs = [(min(chunk, n_utterances - s) // k, k, seed + s) for s in starts]
    wait_s = feat_s = 0.0
    workers = max(1, min(8, os.cpu_count() or 1, len(jobs)))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        chunks = pool.map(_generate, jobs)
        for done in starts:
            tg = time.perf_counter()
            audio, labels = next(chunks)
            wait_s += time.perf_counter() - tg
            tf = time.perf_counter()
            spikes = torch.cat([featurize_batch(torch.as_tensor(audio[s:s + cfg.batch_size])
                                                .to(device), cfg.frontend).cpu()
                                for s in range(0, len(labels), cfg.batch_size)]).numpy()
            feat_s += time.perf_counter() - tf
            writer.append(spikes, labels, np.arange(done, done + len(labels)))
    writer.close()
    rows = n_utterances
    nbytes = sum(p.stat().st_size for p in Path(root).glob("*.npz"))
    return {"rows": rows, "seconds": time.perf_counter() - t0, "generate_wait_s": wait_s,
            "generate_workers": workers, "featurize_s": feat_s, "bytes_on_disk": nbytes,
            "bytes_raw": rows * cfg.frontend.n_filters * cfg.frontend.spike_train_length}


def train(source, cfg: PipelineConfig, device: torch.device, readout: str,
          sampler: RssSampler) -> tuple:
    """extract_and_train_streaming with the per-pass report: (result,
    report dict)."""
    from lsm_tpu_torch.pipeline import extract_and_train_streaming

    with extract_events(device) as calls:
        result = extract_and_train_streaming(cfg, source, device, readout=readout,
                                             run_diagnostics=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rep = {"readout": readout, "accuracy": result.accuracy, "n_train": result.n_train,
           "n_test": result.n_test, "fit_split_s": result.fit_split, "passes": {}}
    rows = {"fit_pass": result.n_train, "eval_pass": result.n_test}
    for name, (t0, t1) in result.phases.items():
        wall = t1 - t0
        ph = {"seconds": wall, "peak_rss_bytes": sampler.peak(t0, t1),
              "start_rss_bytes": sampler.first(t0, t1)}
        if name in rows:
            ph["utt_per_s"] = rows[name] / max(wall, 1e-9)
            inside = [(s, e) for t, s, e in calls if t0 <= t <= t1]
            if inside:
                busy_ms = sum(s.elapsed_time(e) for s, e in inside)
                ph.update(extract_calls=len(inside), device_busy_ms=busy_ms,
                          device_busy_share=busy_ms / (wall * 1e3))
        rep["passes"][name] = ph
    return result, rep


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.tools.bench_stream_train",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--n-utterances", type=int, default=24000)
    p.add_argument("--shard-size", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--readout", nargs="+", default=["ridge"], choices=["ridge", "logistic"])
    p.add_argument("--root", type=str, default="build/stream_corpus")
    p.add_argument("--json", type=str, default=None, help="Also write the report here.")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io.sharded import ShardedSpikeDataset

    device = resolve_device(args.device)
    cfg = PipelineConfig(commands=COMMANDS_12, batch_size=args.batch_size)
    root = Path(args.root)
    sampler = RssSampler()
    report = {"card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "n_utterances": args.n_utterances}
    try:
        if (root / "manifest.json").exists():
            source = ShardedSpikeDataset(root)
            report["write"] = {"reused": True, "rows": source.num_samples}
        else:
            t0 = time.perf_counter()
            report["write"] = write_corpus(root, args.n_utterances, cfg, device, args.shard_size)
            report["write"]["peak_rss_bytes"] = sampler.peak(t0, time.perf_counter())
            source = ShardedSpikeDataset(root)
        report["runs"] = [train(source, cfg, device, r, sampler)[1] for r in args.readout]
    finally:
        sampler.stop()
    text = json.dumps(report)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
