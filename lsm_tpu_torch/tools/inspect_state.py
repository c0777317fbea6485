"""Inspect serving-state snapshots without building an engine (the port's
counterpart of tools/inspect_state.py).

Prints a snapshot's identity header (format, engine, streams, frontend,
feature keys, weights checksum, geometry, the pool's session table) from
`io.serving_state.read_snapshot_meta` and its state-leaf inventory, or
diffs two snapshots field by field. Reads files only: no device, no
engine. Snapshots of either package read alike.

    python -m lsm_tpu_torch.tools.inspect_state snap.npz [more.npz ...]
    python -m lsm_tpu_torch.tools.inspect_state --diff a.npz b.npz
"""

from __future__ import annotations

import argparse
import signal
import sys
from pathlib import Path

import numpy as np

from lsm_tpu_torch.io.serving_state import read_snapshot_meta


def describe(path: Path) -> dict:
    """{"meta": the identity header, "leaves": {name: (shape, dtype,
    bytes)}, "file_bytes": size on disk}."""
    meta = read_snapshot_meta(path)
    with np.load(path, allow_pickle=False) as data:
        leaves = {k.replace("seg__", "seg:"): (data[k].shape, str(data[k].dtype), data[k].nbytes)
                  for k in data.files if k != "meta"}
    return {"meta": meta, "leaves": leaves, "file_bytes": path.stat().st_size}


def render(path: Path, info: dict) -> str:
    meta, leaves = info["meta"], info["leaves"]
    fe = meta.get("frontend", {})
    lines = [
        f"{path}  ({info['file_bytes'] / 1e6:.2f} MB on disk)",
        f"  format:      {meta.get('format')}",
        f"  engine:      {meta.get('engine')}  ({meta.get('n_streams')} streams)",
        f"  frontend:    {fe.get('filterbank')} x{fe.get('n_filters')}",
        f"  feature set: {len(meta.get('feature_keys', []))} keys {meta.get('feature_keys')}",
        f"  weights_crc: {meta.get('weights_crc'):#010x}",
    ]
    if meta.get("engine") == "continuous":
        lines.append(f"  geometry:    chunk_len={meta.get('chunk_len')} "
                     f"norm_decay={meta.get('norm_decay_db_per_bin')} "
                     f"gtgram_two_phase={meta.get('gtgram_two_phase')}")
    pool = meta.get("pool")
    if pool:
        sess = pool.get("sessions", [])
        lines.append(f"  pool:        {len(sess)} connected session(s), "
                     f"{len(pool.get('free', []))} free slot(s), "
                     f"wire={pool.get('wire_dtype')} chunk_len={pool.get('chunk_len')}")
        for s, slot in sess[:8]:
            lines.append(f"      slot {slot}: session {s!r}")
        if len(sess) > 8:
            lines.append(f"      ... ({len(sess) - 8} more)")
    state_bytes = sum(b for _, _, b in leaves.values())
    lines.append(f"  state:       {len(leaves)} leaves, {state_bytes / 1e6:.2f} MB uncompressed")
    for k in sorted(leaves):
        shape, dt, _ = leaves[k]
        lines.append(f"      {k:14s} {dt}{list(shape)}")
    return "\n".join(lines)


def diff(a: Path, b: Path) -> int:
    """Print every differing header field and leaf geometry; 0 if none."""
    ia, ib = describe(a), describe(b)
    n_diff = 0
    for k in sorted(set(ia["meta"]) | set(ib["meta"])):
        va, vb = ia["meta"].get(k), ib["meta"].get(k)
        if va != vb:
            n_diff += 1
            print(f"  meta[{k}]: {va!r}  !=  {vb!r}")
    for k in sorted(set(ia["leaves"]) | set(ib["leaves"])):
        la, lb = ia["leaves"].get(k), ib["leaves"].get(k)
        if la is None or lb is None or la[:2] != lb[:2]:
            n_diff += 1
            print(f"  leaf {k}: {la and (la[1], list(la[0]))}  !=  "
                  f"{lb and (lb[1], list(lb[0]))}")
    if n_diff == 0:
        print(f"identical identity/geometry: {a} vs {b} (state VALUES not compared)")
    return 0 if n_diff == 0 else 1


def main(argv=None) -> None:
    # Piped into `head`, exit quietly instead of a BrokenPipeError traceback.
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    ap = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.tools.inspect_state",
                                 description="Inspect serving-state snapshot files "
                                             "(engine-free).")
    ap.add_argument("paths", nargs="+", type=Path)
    ap.add_argument("--diff", action="store_true",
                    help="Compare exactly two snapshots' identity headers and leaf "
                         "geometry; exit 1 on any difference.")
    args = ap.parse_args(argv)
    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff takes exactly two snapshot paths")
        sys.exit(diff(*args.paths))
    ok = True
    for p in args.paths:
        try:
            print(render(p, describe(p)))
        except (FileNotFoundError, ValueError) as e:
            ok = False
            print(f"{p}: INVALID — {e}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
