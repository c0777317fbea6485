"""Serve WAVs as parallel keyword-spotting streams (the port's counterpart
of the repo-root stream_kws.py, plus --device).

    python -m lsm_tpu_torch.cli.stream_kws --model lsm_model.npz --data-dir <tree>

Every WAV becomes one stream; audio is fed in fixed chunks (default
100 ms), each chunk one engine step over all streams on the device.

  --mode exact       the sliding-window engine (models/streaming.py): every
                     hop runs the batch path over the trailing 1 s; any
                     batch bundle (`python -m lsm_tpu_torch --save-model`).
  --mode continuous  the state-carrying engine (models/continuous.py); needs
                     a bundle calibrated on continuous features
                     (feature_mode "continuous"), which is enforced.

--pool serves every WAV as a session of a StreamPool (models/pool.py) with
--max-streams slots; --save-state / --restore-state write and read
serving-state files (io/serving_state.py) that lsm_tpu reads and writes
too. --metrics-out appends stream_kws.py's metric records.

Launched as several processes (parallel/mesh.py's env contract:
LSM_TPU_COORDINATOR, LSM_TPU_NUM_PROCESSES and LSM_TPU_PROCESS_ID on
each), the engine serves over the ranks: every rank loads the same WAVs
and feeds its own stream rows, the static batch is padded to a multiple of
the ranks (the pool's slot count rounded up to one), and rank 0 alone
prints, writes the metric records, --output and --save-state.
--single-device serves on each process's own device instead.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np

from lsm_tpu_torch.cli.common import (
    add_device_flag, add_metrics_flag, add_single_device_flag, metrics_from_args, setup_logging,
)
from lsm_tpu_torch.io.model import MODEL_FILENAME


def _to_wire(chunk: np.ndarray, wire: str) -> np.ndarray:
    """Encode an f32 chunk into the requested ingest wire format (the CLI
    stands in for a network producer; the decode happens on the device)."""
    if wire == "pcm16":
        from lsm_tpu_torch.io.wav import to_pcm16_wire

        return to_pcm16_wire(chunk)
    if wire == "ulaw":
        from lsm_tpu_torch.ops.ulaw import encode_ulaw_f32

        return encode_ulaw_f32(chunk)
    return chunk


def _serve_pool(args, pool, files, fcfg, chunk_len, n_chunks, names, metrics, checkpoint,
                pid0: bool):
    """Session-churn serving over a StreamPool: WAV i is session i,
    admitted first come first served when a slot frees, fed its own chunks,
    finished (slot recycled) after its last one. Audio decodes at admit
    time and is dropped at finish, so host memory follows the slot count,
    not the corpus; a file that fails to decode is skipped (served=False).
    Only the connected sessions' rows go to the device each hop. Returns
    (preds, margins, checkpointed on the final hop, served mask), one
    decision per served session — in exact mode equal to the static
    one-slot-per-file run's, since a slot's state depends only on its own
    session's audio after the admit reset. Over a mesh every rank runs the
    same loop on the same files; rank 0 (`pid0`) prints."""
    from lsm_tpu_torch.io.wav import load_audio_batch

    n_sessions = len(files)
    queue = deque(range(n_sessions))
    active: dict = {}  # session id -> next chunk index to feed
    cache: dict = {}   # session id -> its decoded (window,) f32 audio
    served = np.zeros(n_sessions, bool)
    preds = np.full(n_sessions, -1, np.int32)
    margins = np.zeros(n_sessions, np.float32)
    hop = 0
    ckpt_hop = -1
    while queue or active:
        while queue and pool.n_active < pool.capacity:
            sid = queue.popleft()
            row, kept, errors = load_audio_batch([files[sid]], fcfg.sample_rate, fcfg.duration)
            if not kept:
                for path, err in errors:
                    print(f"Error loading {path}: {err}", file=sys.stderr)
                continue
            cache[sid] = row[0]
            served[sid] = True
            pool.admit(sid)
            active[sid] = 0
            if args.per_chunk and pid0:
                print(f"  hop {hop + 1:4d}: admit session {sid} -> slot {pool.slot_of(sid)}")
        sids = sorted(active)
        if not sids:
            continue    # every queued session failed to decode this round
        rows = _to_wire(np.stack([
            cache[s][active[s] * chunk_len:(active[s] + 1) * chunk_len] for s in sids
        ]), args.wire)
        res = pool.step(dict(zip(sids, rows)))
        hop += 1
        if args.check_decisions:
            m = np.asarray([res[s][1] for s in sids], np.float32)
            if not (np.isfinite(m).all() and (m >= 0).all()):
                raise SystemExit(
                    f"--check: non-finite or negative decision margin at "
                    f"hop {hop} — the reservoir or readout produced "
                    "NaN/Inf on this hop"
                )
        for s in sids:
            active[s] += 1
            if active[s] == n_chunks:
                preds[s], margins[s] = res[s]
                pool.finish(s)
                del active[s]
                del cache[s]
                if args.per_chunk and pid0:
                    print(f"  hop {hop:4d}: finish session {s} -> {names[preds[s]]}")
        if args.save_state_every and hop % args.save_state_every == 0:
            checkpoint()
            ckpt_hop = hop
        if args.diagnostics_every and pool.n_active and hop % args.diagnostics_every == 0:
            rep, _ = pool.diagnostics()         # a collective: every rank
            if pid0:
                print(rep.render())
            if metrics:
                # The static path's record (chunk=): one schema for both modes.
                metrics.emit("serving_participation_pct", round(rep.avg_participation, 2),
                             regime=rep.regime, scope=rep.scope, chunk=hop)
    if metrics:
        metrics.emit("serving_pool_sessions", int(served.sum()), slots=pool.capacity, hops=hop)
    return preds, margins, ckpt_hop == hop, served


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.cli.stream_kws",
                                description="Serve WAVs as parallel keyword-spotting streams.")
    p.add_argument("--model", type=str, default=MODEL_FILENAME)
    p.add_argument("--data-dir", type=str, required=True,
                   help="Directory of WAVs (recursed); each file is one stream. "
                        "Class-named parent dirs provide labels for the accuracy line.")
    p.add_argument("--mode", type=str, default=None, choices=["exact", "continuous"],
                   help="Default: the bundle's feature_mode.")
    p.add_argument("--chunk-ms", type=int, default=100)
    p.add_argument("--max-streams", type=int, default=1024)
    p.add_argument("--output", type=str, default="stream_predictions.npz")
    p.add_argument("--wire", type=str, default="f32", choices=["f32", "pcm16", "ulaw"],
                   help="Wire format fed to step(): f32 samples, int16 PCM (2x fewer "
                        "ingest bytes) or uint8 G.711 mu-law (4x fewer), decoded on "
                        "the device.")
    p.add_argument("--per-chunk", action="store_true",
                   help="Print the running prediction after every chunk "
                        "(default: final prediction per stream).")
    p.add_argument("--compact", action="store_true",
                   help="Use the compact decision egress (step_compact): the device "
                        "returns packed [top-1 class, f16 top-1/top-2 margin], 4 bytes "
                        "a stream. Predictions equal the argmax of the full logits; "
                        "margins are written to the output file.")
    p.add_argument("--pool", action="store_true",
                   help="Session-churn serving (StreamPool, models/pool.py): every WAV "
                        "is one session, --max-streams is the slot capacity, and "
                        "sessions are admitted first come first served as slots free "
                        "up. Decisions come from the compact egress at each session's "
                        "last chunk; in exact mode they equal the static run's. "
                        "Continuous-mode sessions start cold (~1 s of warm-up). "
                        "Sessions decode at admit and are dropped at finish.")
    add_single_device_flag(p)
    p.add_argument("--save-state", type=str, default=None,
                   help="After serving, snapshot all cross-chunk stream state to this "
                        ".npz (io/serving_state.py): --restore-state continues every "
                        "stream bit-exactly, warm-up included.")
    p.add_argument("--state-no-compress", action="store_true",
                   help="Write state snapshots uncompressed: faster checkpoint writes "
                        "for big engines, at about the state's size on disk.")
    p.add_argument("--save-state-every", type=int, default=0, metavar="N",
                   help="With --save-state: also checkpoint every N chunks during "
                        "serving (atomic temp+rename write, so a kill mid-checkpoint "
                        "keeps the previous snapshot).")
    # Its own dest, as it checks the served decisions, not the stage
    # boundaries that the other entry points' --check validates.
    p.add_argument("--check", dest="check_decisions", action="store_true",
                   help="Validate every hop's decisions: finite logits and, in compact "
                        "and pool modes, finite non-negative margins; a NaN reservoir "
                        "or readout fails at the hop that produced it.")
    add_metrics_flag(p)
    p.add_argument("--diagnostics-every", type=int, default=0, metavar="N",
                   help="Every N chunks, print the live reservoir health report "
                        "(participation and regime with the batch diagnostics' "
                        "thresholds) over the served streams.")
    p.add_argument("--restore-state", type=str, default=None,
                   help="Before serving, restore a --save-state snapshot (validated "
                        "against this bundle's weights and the engine geometry). "
                        "Replaces the continuous-mode pre-roll: restored streams are "
                        "already warm.")
    add_device_flag(p)
    args = p.parse_args(argv)
    if args.save_state_every and not args.save_state:
        print("Error: --save-state-every needs --save-state <path>.", file=sys.stderr)
        sys.exit(1)
    if args.max_streams < 1:
        print("Error: --max-streams must be >= 1.", file=sys.stderr)
        sys.exit(1)
    setup_logging()

    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.io.model import load_model
    from lsm_tpu_torch.io.serving_state import load_serving_state, save_serving_state
    from lsm_tpu_torch.io.wav import load_audio_batch
    from lsm_tpu_torch.parallel import mesh as meshlib

    device = resolve_device(args.device)
    mesh = None if args.single_device else meshlib.auto_mesh(device=device)
    if mesh is not None:
        device = mesh.device
    # Rank 0 owns every informational print, the metric records and the
    # files; errors fail loudly on every rank.
    pid0 = meshlib.is_primary()
    try:
        bundle = load_model(Path(args.model), device)
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)

    mode = args.mode or ("continuous" if bundle.feature_mode == "continuous" else "exact")
    if mode == "continuous" and bundle.feature_mode != "continuous":
        print("Error: --mode continuous needs a continuous-calibrated bundle "
              "(this one is feature_mode='batch' — its readout loses ~0.3 "
              "accuracy on continuous features). Re-calibrate with "
              "tools/calibrate_continuous.py.", file=sys.stderr)
        sys.exit(1)
    if mode == "exact" and bundle.feature_mode == "continuous":
        print("Error: this bundle is calibrated for continuous-mode features; "
              "use --mode continuous (or an exact/batch bundle).", file=sys.stderr)
        sys.exit(1)

    fcfg = bundle.frontend
    # Pool mode serves every file as a session over --max-streams slots;
    # static mode serves at most --max-streams files, one slot each.
    all_files = sorted(Path(args.data_dir).rglob("*.wav"))
    files = all_files if args.pool else all_files[: args.max_streams]
    if not files:
        print(f"Error: no WAVs under '{args.data_dir}'.", file=sys.stderr)
        sys.exit(1)
    if args.pool:
        if args.restore_state:
            print("Error: --pool replays files as fresh sessions; a "
                  "restored session table has no files to resume. Use "
                  "StreamPool.restore from the library for real "
                  "failover.", file=sys.stderr)
            sys.exit(1)
        audio = None
        n_real = len(files)          # sessions
        n_streams = args.max_streams  # engine width = slot capacity
        if mesh is not None:
            n_data = mesh.shape[meshlib.DATA_AXIS]
            n_streams = -(-n_streams // n_data) * n_data
    else:
        audio, kept, errors = load_audio_batch(files, fcfg.sample_rate, fcfg.duration)
        for path, err in errors:
            print(f"Error loading {path}: {err}", file=sys.stderr)
        files = [files[i] for i in kept]
        n_real = audio.shape[0]
        if mesh is not None:
            audio, n_real = meshlib.pad_to_multiple(audio, mesh.shape[meshlib.DATA_AXIS])
        n_streams = audio.shape[0]

    chunk_len = fcfg.sample_rate * args.chunk_ms // 1000
    if mode == "continuous":
        # The calibration's distribution-shaping knobs ride in the bundle
        # and override the CLI.
        cp = bundle.continuous_params or {}
        if cp.get("chunk_len") and cp["chunk_len"] != chunk_len and pid0:
            print(f"note: using the bundle's calibrated chunk length "
                  f"({cp['chunk_len']} samples) instead of --chunk-ms.")
        if cp.get("chunk_len"):
            chunk_len = int(cp["chunk_len"])
    window = int(fcfg.sample_rate * fcfg.duration)
    n_chunks = window // chunk_len
    if n_chunks == 0:
        print(f"Error: chunk length {chunk_len} samples exceeds the "
              f"{window}-sample analysis window.", file=sys.stderr)
        sys.exit(1)
    dropped = window - n_chunks * chunk_len
    if dropped and pid0:
        print(f"note: chunk length {chunk_len} does not divide the "
              f"{window}-sample window — the last {dropped} samples "
              "of every file are not served (pick a dividing --chunk-ms to "
              "cover the full utterance).")

    if mode == "continuous":
        from lsm_tpu_torch.models.continuous import ContinuousKWS

        kws = ContinuousKWS(
            bundle.reservoir, bundle.readout, bundle.scaler, fcfg, bundle.feature_set,
            n_streams=n_streams, chunk_len=chunk_len,
            norm_decay_db_per_bin=float(
                (bundle.continuous_params or {}).get("norm_decay_db_per_bin", 0.1)),
            mesh=mesh,
        )
    else:
        from lsm_tpu_torch.models.streaming import StreamingKWS

        kws = StreamingKWS(bundle.reservoir, bundle.readout, bundle.scaler, fcfg,
                           bundle.feature_set, n_streams=n_streams, mesh=mesh)

    names = list(bundle.class_names)
    served_ms = 1000 * chunk_len // fcfg.sample_rate
    on_mesh = f", mesh x{mesh.shape[meshlib.DATA_AXIS]}" if mesh is not None else ""
    if pid0 and args.pool:
        print(f"Serving {n_real} sessions over {n_streams} pool slots "
              f"in {mode} mode ({served_ms} ms chunks, {n_chunks} chunks per session{on_mesh})")
    elif pid0:
        print(f"Serving {n_real} streams in {mode} mode "
              f"({served_ms} ms chunks, {n_chunks} chunks{on_mesh})")
    if args.restore_state:
        try:
            load_serving_state(Path(args.restore_state), kws)
        except (FileNotFoundError, ValueError) as e:
            print(f"Error restoring state: {e}", file=sys.stderr)
            sys.exit(1)
        if pid0:
            print(f"Stream state restored from '{args.restore_state}'")
    # Every rank feeds the rows of its data coordinate (all of them on one
    # device).
    rows = kws.rows
    if mode == "continuous" and not args.restore_state and not args.pool:
        # Continuous mode is calibrated for always-on streams; a
        # file-per-stream run starts cold, so each stream is pre-rolled with
        # another utterance's audio, the protocol fit_continuous_readout
        # trains on (a fixed-seed permutation: the file walk is
        # class-dir-major, and a roll would give most streams a same-class
        # predecessor).
        preroll = audio[np.random.default_rng(12345).permutation(n_streams)][rows]
        for c in range(n_chunks):
            kws.step(_to_wire(preroll[:, c * chunk_len:(c + 1) * chunk_len], args.wire))
    pool = None
    if args.pool:
        from lsm_tpu_torch.models.pool import StreamPool

        pool = StreamPool(kws, chunk_len=chunk_len)

    def _checkpoint() -> None:
        compress = not args.state_no_compress
        if pool is not None:
            # Pool checkpoints carry the session table too.
            pool.save(Path(args.save_state), compress=compress)
        else:
            save_serving_state(Path(args.save_state), kws, compress=compress)

    metrics = metrics_from_args(args) if pid0 else None
    t_serve = time.perf_counter()
    preds = margins = None
    last_ckpt_chunk = -1
    if args.pool:
        preds, margins, ckpt_on_last, served = _serve_pool(
            args, pool, files, fcfg, chunk_len, n_chunks, names, metrics, _checkpoint, pid0)
        files = [f for f, ok in zip(files, served) if ok]
        preds = preds[served]
        margins = margins[served]
        n_real = len(files)
        last_ckpt_chunk = n_chunks - 1 if ckpt_on_last else -1
    for c in range(0 if args.pool else n_chunks):
        wire_chunk = _to_wire(audio[rows, c * chunk_len:(c + 1) * chunk_len], args.wire)
        if args.compact:
            preds, margins = kws.step_compact(wire_chunk)
            preds, margins = preds[:n_real], margins[:n_real]
            if args.check_decisions and not (np.isfinite(margins).all() and (margins >= 0).all()):
                raise SystemExit(
                    f"--check: non-finite or negative decision margin at "
                    f"chunk {c + 1} — the reservoir or readout produced "
                    "NaN/Inf on this hop"
                )
        else:
            logits = kws.step(wire_chunk)[:n_real]
            if args.check_decisions and not np.isfinite(logits).all():
                bad = int((~np.isfinite(logits)).any(axis=-1).sum())
                raise SystemExit(
                    f"--check: non-finite logits for {bad} stream(s) at "
                    f"chunk {c + 1} — the reservoir or readout produced "
                    "NaN/Inf on this hop"
                )
            preds = np.argmax(logits, axis=-1)
        if args.per_chunk and pid0:
            head = " ".join(names[q] for q in preds[:8])
            print(f"  chunk {c + 1:3d}/{n_chunks}: {head}{' ...' if n_real > 8 else ''}")
        if args.save_state_every and (c + 1) % args.save_state_every == 0:
            _checkpoint()
            last_ckpt_chunk = c
        if args.diagnostics_every and (c + 1) % args.diagnostics_every == 0:
            # A collective on a mesh: every rank computes, rank 0 prints;
            # the real streams only (padding rows are silence).
            rep = kws.diagnostics(stream_idx=np.arange(n_real))
            if pid0:
                print(rep.render())
            if metrics:
                metrics.emit("serving_participation_pct", round(rep.avg_participation, 2),
                             regime=rep.regime, scope=rep.scope, chunk=c + 1)
    wall = time.perf_counter() - t_serve
    if metrics:
        metrics.emit("serving_stream_chunks_per_sec", round(n_chunks * n_real / wall, 2),
                     mode=mode, streams=n_real, chunks=n_chunks, chunk_ms=served_ms,
                     wire=args.wire, wall_s=round(wall, 3))
    if pid0:
        print(f"Served {n_real} {'sessions' if args.pool else 'streams'} x {n_chunks} chunks "
              f"in {wall:.3f} s ({n_real * n_chunks / wall:.1f} stream-chunks/s, "
              f"{n_real / wall:.1f} {'sessions' if args.pool else 'streams'}/s) on {device}"
              f"{on_mesh}")

    if args.save_state:
        # The state is unchanged since a periodic checkpoint on the last
        # chunk: skip the duplicate write.
        if last_ckpt_chunk != n_chunks - 1:
            _checkpoint()
        if pid0:
            print(f"Stream state snapshot -> '{args.save_state}'")
    if not pid0:
        # Every rank holds the full predictions; rank 0 writes them.
        return

    class_idx = {c: i for i, c in enumerate(names)}
    labels = np.asarray([class_idx.get(f.parent.name, -1) for f in files], np.int32)
    out = dict(
        predictions=preds.astype(np.int32),
        labels=labels,
        files=np.asarray([str(f) for f in files]),
        class_names=np.asarray(names),
    )
    if margins is not None:
        out["margins"] = np.asarray(margins[:n_real], np.float32)
    np.savez_compressed(Path(args.output), **out)
    print(f"Final predictions for {n_real} streams -> '{args.output}'")
    counts = np.bincount(preds, minlength=len(names))
    for name, cnt in zip(names, counts):
        if cnt:
            print(f"  {name:>10s}: {cnt}")
    known = labels >= 0
    if known.any():
        acc = float((preds[known] == labels[known]).mean())
        print(f"Accuracy vs directory labels ({int(known.sum())} streams): {acc * 100:.2f}%")
        if metrics:
            metrics.emit("serving_accuracy", round(acc, 4), streams=int(known.sum()), mode=mode)
    if metrics:
        metrics.close()


if __name__ == "__main__":
    main()
