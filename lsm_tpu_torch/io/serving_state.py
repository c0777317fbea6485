"""Serving-state checkpoints for the streaming engines (port of
lsm_tpu/io/serving_state.py; the same file format, read and written by
either package).

The engines carry per-stream state across chunks (StreamingKWS: the
sample ring buffer; ContinuousKWS: IIR cascade, hysteresis triggers,
normalization peak/floor, membrane, segment and rate-window rings — about
1 s of warm-up to rebuild from cold), so a restart without a snapshot
costs every connected stream its context.

The file is one .npz holding the engine's snapshot() leaves (segment-ring
leaves 'seg:<stat>' stored as members 'seg__<stat>') and a JSON `meta`
header. Loading validates the header against the live engine — engine
kind, stream count, frontend, feature set, chunk geometry, the gammatone
dispatch and a weights checksum — so a snapshot installs only into an
engine that continues it bit-exactly; anything else raises ValueError.
`migrate_streams` moves individual live streams between two such engines.

A mesh engine (one process a device, models/streaming.py) saves and loads
the same files: every rank takes the snapshot (a gather) and rank 0 alone
writes; every rank reads the file and installs its own streams. A file
written by several ranks loads into one process and the reverse, and
migration runs between a mesh engine and a single-device one either way.

The weights checksum (`_weights_crc`) is lsm_tpu's, bit for bit: CRC32
over the text JAX gives the parameters' tree structure, then a digest of
every weight leaf's values in lsm_tpu's leaf order. The port renders that
text itself (`_treedef_text`).
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

from lsm_tpu_torch.config import frontend_from_dict, frontend_to_dict

# v2: the weight digest is position-weighted and independent of where the
# leaf lives; the identity holds gtgram_two_phase.
_FORMAT = "lsm_tpu.serving_state.v2"

# Leaves of at least this many elements are digested by a position-weighted
# modular sum over their bit patterns (lsm_tpu computes it on its device);
# smaller ones by their bytes. The flagship's 1024 x 1024 w_rec is exactly
# this size, so it takes the sum.
_LARGE_LEAF = 1 << 20

# Knuth's golden-ratio multiplier: position-weights the modular digest so
# permuted weight matrices do not collide (a plain sum is order-blind).
_DIGEST_MULT = 0x9E3779B1


def _leaf_fingerprint(a) -> bytes:
    """Digest of a leaf's values (a tensor on any device or an ndarray),
    lsm_tpu's exactly. Large leaves: digest = sum_i (i*MULT + 1) * bits_i
    mod 2^32 over the raw bit patterns (4-byte dtypes as uint32 words,
    others as little-endian bytes), then the shape; computed on a host
    NumPy copy in uint32 arithmetic that wraps as lsm_tpu's does. Small
    leaves: their exact bytes."""
    arr = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    if arr.size >= _LARGE_LEAF:
        flat = np.ascontiguousarray(arr).reshape(-1)
        bits = flat.view(np.uint32) if flat.dtype.itemsize == 4 else flat.view(np.uint8)
        total = 0
        step = 1 << 22
        for off in range(0, bits.size, step):
            chunk = bits[off:off + step].astype(np.uint32)
            w = (np.arange(off, off + chunk.size, dtype=np.uint32)
                 * np.uint32(_DIGEST_MULT) + np.uint32(1))
            total = total + int(np.sum(chunk * w, dtype=np.uint32))
        total &= 0xFFFFFFFF
        return total.to_bytes(8, "little") + str(arr.shape).encode()
    return np.ascontiguousarray(arr).tobytes()


def _weight_leaves(kws):
    """The reservoir's float32 buffers (never the kernels' bf16 copies),
    then the readout's and the scaler's, in lsm_tpu's order: dense w_rec,
    w_in, leak; sparse w_blocks, src_idx, w_in, leak; readout w, b; scaler
    mean, scale."""
    from lsm_tpu_torch.models.sparse import SparseReservoir

    r = kws.reservoir
    names = (("w_blocks", "src_idx", "w_in", "leak") if isinstance(r, SparseReservoir)
             else ("w_rec", "w_in", "leak"))
    return ([getattr(r, n) for n in names] + [kws.readout.w, kws.readout.b]
            + [kws.scaler_state.mean, kws.scaler_state.scale])


def _treedef_text(kws) -> str:
    """What str(jax.tree_util.tree_flatten((params, readout, scaler))[1])
    gives for lsm_tpu's parameters of the same reservoir: the static
    fields as Python ints and floats (a NumPy scalar would print as
    np.float32(2.0) and change the checksum)."""
    from lsm_tpu_torch.models.sparse import SparseReservoir

    r = kws.reservoir
    static = (int(r.n_neurons), int(r.n_outputs), int(r.n_channels), float(r.threshold),
              int(r.refractory), int(r.burst_isi_max), int(r.n_rate_windows))
    if isinstance(r, SparseReservoir):
        node = f"SparseReservoirParams[{static + (int(r.n_band),)!r}], [*, *, *, *]"
    else:
        node = f"ReservoirParams[{static!r}], [*, *, *]"
    return (f"PyTreeDef((CustomNode({node}), CustomNode(namedtuple[LogisticParams], [*, *]), "
            "CustomNode(namedtuple[ScalerState], [*, *])))")


def _weights_crc(kws) -> int:
    """CRC32 identity over everything the continued trajectory depends on:
    the tree-structure text (the static dynamics fields and dense/sparse
    structure), then every weight leaf's digest. Cached on the engine
    (swap_readout drops it), so save/load/migrate digest once."""
    cached = getattr(kws, "_serving_weights_crc", None)
    if cached is not None:
        return cached
    crc = zlib.crc32(_treedef_text(kws).encode())
    for a in _weight_leaves(kws):
        crc = zlib.crc32(_leaf_fingerprint(a), crc)
    kws._serving_weights_crc = crc
    return crc


def _engine_meta(kws) -> dict:
    from lsm_tpu_torch.models.continuous import ContinuousKWS
    from lsm_tpu_torch.models.streaming import StreamingKWS

    if isinstance(kws, ContinuousKWS):
        engine = "continuous"
        geometry = {
            "chunk_len": int(kws.chunk_len),
            "norm_decay_db_per_bin": float(kws.norm_decay_db_per_bin),
            # B3 and its plain twin agree to rounding, not bits: carried
            # state from one must not continue under the other.
            "gtgram_two_phase": bool(kws.gtgram_two_phase),
        }
    elif isinstance(kws, StreamingKWS):
        engine = "exact"
        geometry = {}
    else:
        raise TypeError(f"not a streaming engine: {type(kws).__name__}")
    return {
        "format": _FORMAT,
        "engine": engine,
        "n_streams": int(kws.n_streams),
        "frontend": frontend_to_dict(kws.fcfg),
        "feature_keys": list(kws.keys),
        "weights_crc": _weights_crc(kws),
        **geometry,
    }


def write_snapshot(path: Path, kws, snap: dict, compress: bool = True,
                   extra_meta: dict | None = None) -> None:
    """Write an already-taken snapshot() to `path` (.npz), atomically: a
    temp file in the same directory, then a rename, so a server killed
    mid-checkpoint keeps the previous snapshot. `compress=False` writes the
    members stored, for periodic checkpoints of big engines, where zlib's
    time is the binding cost; the reader takes either. `extra_meta` rides
    in the header untouched (StreamPool's session table). For a mesh
    engine every rank calls it with the same snapshot; rank 0 writes and
    the others wait for it."""
    if kws.mesh is not None:
        from lsm_tpu_torch.parallel.mesh import barrier, is_primary

        if is_primary():
            _write(path, kws, snap, compress, extra_meta)
        barrier(kws.mesh)
        return
    _write(path, kws, snap, compress, extra_meta)


def _write(path: Path, kws, snap: dict, compress: bool, extra_meta: dict | None) -> None:
    arrays = {k.replace("seg:", "seg__"): v for k, v in snap.items()}
    meta = _engine_meta(kws)
    if extra_meta:
        meta.update(extra_meta)
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    writer = np.savez_compressed if compress else np.savez
    with open(tmp, "wb") as f:   # a file handle: numpy would append '.npz' to a name
        writer(f, meta=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def save_serving_state(path: Path, kws, compress: bool = True) -> None:
    """Snapshot `kws`'s cross-chunk stream state to `path` (.npz). On a
    mesh every rank calls it (the snapshot is a collective)."""
    write_snapshot(path, kws, kws.snapshot(), compress=compress)


def read_snapshot_meta(path: Path) -> dict:
    """Read and format-check a snapshot's meta header without touching any
    engine. Raises ValueError for an unreadable or foreign file."""
    try:
        with np.load(Path(path), allow_pickle=False) as data:
            if "meta" not in data.files:
                raise ValueError(f"'{path}' is not a serving-state snapshot")
            meta = json.loads(str(data["meta"]))
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, OSError, json.JSONDecodeError) as e:
        raise ValueError(
            f"'{path}' is corrupt or truncated (not a readable "
            f"serving-state snapshot): {e}"
        ) from e
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"'{path}' has format {meta.get('format')!r} "
            f"(this build reads: {_FORMAT})"
        )
    return meta


def load_serving_state(path: Path, kws) -> dict:
    """Validate `path` against `kws`'s identity and install the state.

    Raises ValueError on any mismatch: engine mode, stream count, feature
    set, chunk geometry, normalization decay, gammatone dispatch,
    frontend or weights. After it returns, `kws` continues the saved
    streams bit-exactly. Returns the snapshot's meta dict (engine identity
    plus extension rows such as StreamPool's session table). On a mesh
    every rank calls it and installs its own streams."""
    meta = read_snapshot_meta(path)
    try:
        with np.load(Path(path), allow_pickle=False) as data:
            arrays = {k.replace("seg__", "seg:"): data[k] for k in data.files if k != "meta"}
    except (zipfile.BadZipFile, OSError) as e:
        # A server killed mid-save leaves a truncated .npz.
        raise ValueError(
            f"'{path}' is corrupt or truncated (not a readable "
            f"serving-state snapshot): {e}"
        ) from e
    want = _engine_meta(kws)
    for key, label in (
        ("engine", "engine mode"),
        ("n_streams", "stream count"),
        ("feature_keys", "feature set"),
        ("chunk_len", "chunk length"),
        ("norm_decay_db_per_bin", "normalization decay"),
        ("gtgram_two_phase", "gammatone dispatch (two-phase kernel)"),
    ):
        if meta.get(key) != want.get(key):
            raise ValueError(
                f"snapshot {label} mismatch: saved "
                f"{meta.get(key)!r}, engine has {want.get(key)!r}"
            )
    if frontend_from_dict(meta["frontend"]) != kws.fcfg:
        raise ValueError("snapshot frontend configuration does not match this engine's")
    if meta["weights_crc"] != want["weights_crc"]:
        raise ValueError(
            "snapshot was taken under different model weights — restoring "
            "it would not continue the streams the snapshot recorded"
        )
    kws.restore(arrays)
    return meta


def migrate_streams(src, dst, src_idx, dst_idx) -> None:
    """Move live stream state between engines: dst slot `dst_idx[i]`
    continues src stream `src_idx[i]` bit-exactly, other dst slots
    untouched. The engines must be identical up to stream count — same
    kind, frontend, feature set, chunk geometry and weights, validated as
    load_serving_state validates. Source slots keep their state; call
    src.reset(src_idx) afterwards to recycle them. Only the moved rows
    travel (extract_streams gathers them on the source's device,
    install_streams scatters them on the destination's). Either engine may
    be a mesh engine: then every rank calls it with the same indices."""
    a, b = _engine_meta(src), _engine_meta(dst)
    for key, label in (
        ("engine", "engine mode"),
        ("feature_keys", "feature set"),
        ("chunk_len", "chunk length"),
        ("norm_decay_db_per_bin", "normalization decay"),
        ("gtgram_two_phase", "gammatone dispatch (two-phase kernel)"),
        ("frontend", "frontend configuration"),
        ("weights_crc", "model weights"),
    ):
        if a.get(key) != b.get(key):
            raise ValueError(
                f"cannot migrate streams between engines with different {label}"
            )
    src_idx = np.atleast_1d(np.asarray(src_idx, np.int64))
    dst_idx = np.atleast_1d(np.asarray(dst_idx, np.int64))
    if src_idx.shape != dst_idx.shape:
        raise ValueError(
            f"src_idx has {src_idx.shape[0]} streams, dst_idx "
            f"{dst_idx.shape[0]} — must pair up one-to-one"
        )
    if (src_idx < 0).any() or (src_idx >= src.n_streams).any():
        raise ValueError(f"src_idx out of range for {src.n_streams} streams")
    if (dst_idx < 0).any() or (dst_idx >= dst.n_streams).any():
        raise ValueError(f"dst_idx out of range for {dst.n_streams} streams")
    if len(set(dst_idx.tolist())) != dst_idx.shape[0]:
        raise ValueError("dst_idx has duplicate slots")
    dst.install_streams(dst_idx, src.extract_streams(src_idx))
