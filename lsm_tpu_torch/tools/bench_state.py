"""Serving-state costs at production stream counts (the port's counterpart
of tools/bench_state.py).

On the flagship continuous engine at --streams streams (default 2048):
  - the step() wall (the serving hop the state operations sit beside);
  - snapshot() (the state to the host) and save_serving_state, compressed
    and not (snapshot + atomic write: the periodic checkpoint);
  - load_serving_state into a fresh engine (restart to warm);
  - migrate_streams and extract_streams of --migrate-k streams (the row
    path, which must not grow with the stream count).
Each is the median host wall of --reps calls after one untimed call, the
card synchronized around each. The port's snapshot copies the state to the
host on every call, so it is timed directly (lsm_tpu's tool subtracts a
step from step + snapshot because JAX caches an array's host copy).

    python -m lsm_tpu_torch.tools.bench_state --streams 2048 --migrate-k 8

The last line of stdout is one JSON object: tool, device, card, streams,
neurons, state_mb, step_ms, snapshot_ms, save_ms, save_raw_ms,
file_mb_raw, load_ms, migrate_ms, extract_ms, migrate_k, and
continues_bit_equal (the loaded engine's next hop against the source's).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np

from lsm_tpu_torch.tools import common


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.tools.bench_state")
    p.add_argument("--streams", type=int, default=2048)
    p.add_argument("--migrate-k", type=int, default=8)
    p.add_argument("--chunk-ms", type=int, default=100)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--num-neurons", type=int, default=1000)
    p.add_argument("--num-outputs", type=int, default=400)
    p.add_argument("--n-filters", type=int, default=128)
    p.add_argument("--state-path", type=str, default=None,
                   help="Where the state file goes (default: a temporary directory).")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from lsm_tpu_torch.config import FrontendConfig
    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io.serving_state import (
        load_serving_state, migrate_streams, save_serving_state,
    )
    from lsm_tpu_torch.models.continuous import ContinuousKWS

    device = resolve_device(args.device)
    fcfg = FrontendConfig(n_filters=args.n_filters)
    modules = common.serving_modules(args.num_neurons, False, args.n_filters, device,
                                     args.num_outputs)
    chunk_len = fcfg.sample_rate * args.chunk_ms // 1000
    n, k = args.streams, args.migrate_k

    def make(m):
        return ContinuousKWS(*modules, fcfg, n_streams=m, chunk_len=chunk_len)

    def timed(label, fn):
        med = statistics.median(common.host_walls(fn, args.reps, device))
        log(f"{label:>40s}: {med * 1e3:10.2f} ms (median of {args.reps})")
        return med * 1e3

    rng = np.random.default_rng(0)
    chunk = (rng.standard_normal((n, chunk_len)) * 0.2).astype(np.float32)
    kws = make(n)
    log(f"continuous engine, {n} streams, {args.num_neurons} neurons, {args.chunk_ms} ms chunks")
    rec = {"tool": "bench_state", **common.identity(device), "streams": n,
           "neurons": args.num_neurons, "migrate_k": k}
    rec["step_ms"] = timed("step()", lambda: kws.step(chunk))
    snap = kws.snapshot()
    rec["state_mb"] = sum(v.nbytes for v in snap.values()) / 1e6
    log(f"{'state size':>40s}: {rec['state_mb']:10.1f} MB ({len(snap)} leaves)")
    rec["snapshot_ms"] = timed("snapshot()", kws.snapshot)
    with tempfile.TemporaryDirectory(prefix="lsm_state_bench_") as tmp:
        path = Path(args.state_path) if args.state_path else Path(tmp) / "state.npz"
        rec["save_ms"] = timed("save_serving_state (compressed)",
                               lambda: save_serving_state(path, kws))
        rec["save_raw_ms"] = timed("save_serving_state (compress=False)",
                                   lambda: save_serving_state(path, kws, compress=False))
        rec["file_mb_raw"] = path.stat().st_size / 1e6
        fresh = make(n)
        rec["load_ms"] = timed("load_serving_state (fresh engine)",
                               lambda: load_serving_state(path, fresh))
        rec["continues_bit_equal"] = bool(np.array_equal(fresh.step(chunk), kws.step(chunk)))
        if args.state_path is None:
            path.unlink()
    del fresh
    dst = make(n)
    idx = np.arange(k)
    rec["migrate_ms"] = timed(f"migrate_streams (k={k} of {n})",
                              lambda: migrate_streams(kws, dst, idx, idx))
    rec["extract_ms"] = timed(f"extract_streams (k={k})", lambda: kws.extract_streams(idx))
    if not np.isfinite(kws.step(chunk)).all():
        raise SystemExit("serving produced non-finite logits after the state operations")
    common.emit(rec)
    return rec


if __name__ == "__main__":
    main()
