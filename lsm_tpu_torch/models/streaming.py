"""Streaming keyword spotting: the exact engine `StreamingKWS` and the
ingest, egress and stream-index helpers both serving engines share, with
their carried state written once over a leaf table (`CarriedState`) (port
of lsm_tpu/models/streaming.py, one device).

The exact engine keeps a ring buffer of the trailing 1 s of audio per
stream; every hop runs the batch path over that window (featurize_batch,
kernel B1; extract_features, kernel B2 for a dense reservoir or B5 for a
block-sparse one; the scaler; the readout), so a hop's prediction is the
batch path's on the same window. `ContinuousKWS` (models/continuous.py)
carries state across hops instead.

Over several ranks (`mesh=`, parallel/mesh.py: one process a device),
both engines hold the stream rows of their data coordinate
(`mesh.local_rows`): every state tensor is this rank's rows, each rank's
chunks carry its own rows, and the kernels run on them. Every rank calls
each method with the same arguments (SPMD, lsm_tpu's multi-host
contract); outputs come back whole, `(n_streams, ...)` on every rank,
through one gather a hop (`gather_streams`). Row-addressed calls
(step_active, reset, extract_streams / install_streams) take global
stream indices; each rank acts on the ones it owns.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from lsm_tpu_torch.config import FEATURE_SETS, FrontendConfig
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models.diagnostics import ServingDiagnosticsReport, serving_report
from lsm_tpu_torch.models.frontend import featurize_batch
from lsm_tpu_torch.models.sparse import SparseReservoir
from lsm_tpu_torch.ops.ulaw import decode_ulaw
from lsm_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, deliver_rows, gather_rows, local_rows, local_stream_rows,
    place_stream_chunk, replicate_to_mesh,
)
from lsm_tpu_torch.readout import logistic, scaler
from lsm_tpu_torch.utils.profiling import span

_WIRE_DTYPES = (torch.float32, torch.int16, torch.uint8)
_NP_OF = {torch.float32: np.float32, torch.int16: np.int16, torch.uint8: np.uint8,
          torch.int32: np.int32, torch.bool: np.bool_}


def normalize_ingest_chunk(
    chunk: np.ndarray, n_streams: int, max_len: int, fixed_len: bool
) -> np.ndarray:
    """The shared ingest policy (shape + dtype). Float inputs are cast to
    f32 ([-1, 1] samples); int16 stays int16 (decoded on the device with the
    exact /32768); uint8 is G.711 mu-law and stays uint8 (decoded on the
    device); other integer dtypes are rejected rather than cast unscaled.
    Exact mode rejects chunks longer than the analysis window; continuous
    mode (fixed_len) requires exactly its configured chunk length."""
    chunk = np.asarray(chunk)
    if chunk.ndim == 1:
        chunk = chunk[None, :]
    if chunk.shape[0] != n_streams:
        raise ValueError(f"expected {n_streams} streams, got {chunk.shape[0]}")
    if fixed_len:
        if chunk.shape[-1] != max_len:
            raise ValueError(
                f"continuous mode ingests fixed {max_len}-sample chunks, "
                f"got {chunk.shape[-1]}"
            )
    elif chunk.shape[-1] > max_len:
        raise ValueError(
            f"chunk length {chunk.shape[-1]} exceeds the analysis "
            f"window ({max_len} samples)"
        )
    if chunk.dtype == np.int16 or chunk.dtype == np.uint8:
        return chunk
    if np.issubdtype(chunk.dtype, np.integer):
        raise TypeError(
            "integer PCM chunks must be int16 (linear) or uint8 (mu-law), "
            f"got {chunk.dtype}"
        )
    return chunk.astype(np.float32)


def bind_mesh(kws, mesh: Optional[Mesh], indivisible: str) -> None:
    """Set up an engine's stream rows: `kws.mesh`, `kws.rows` (the global
    slice of streams this rank holds: all of them without a mesh) and
    `kws.n_local`. On a mesh the stream count must divide over the data
    axis (`indivisible` is the error, lsm_tpu's wording), the reservoir
    must live on the mesh's device, and the weights are broadcast from
    rank 0 so that every rank serves the same bits."""
    kws.mesh = mesh
    if mesh is None:
        kws.rows = slice(0, kws.n_streams)
    else:
        n_data = mesh.shape[DATA_AXIS]
        if kws.n_streams % n_data:
            raise ValueError(indivisible.format(n_streams=kws.n_streams, n_data=n_data))
        if mesh.device != kws.device:
            raise ValueError(f"the reservoir lives on {kws.device}, the mesh computes on "
                             f"{mesh.device}")
        replicate_to_mesh((kws.reservoir, kws.readout, kws.scaler_state), mesh)
        kws.rows = local_rows(kws.n_streams, mesh)
    kws.n_local = local_stream_rows(kws.n_streams, mesh)


def gather_streams(kws, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's stream rows of a result (stream axis `dim`) -> all
    n_streams rows, on every rank, under the span `lsm.kws.gather`; x
    itself without a mesh (and no span)."""
    if kws.mesh is None:
        return x
    with span("lsm.kws.gather"):
        return gather_rows(x, kws.mesh, DATA_AXIS, dim)


def owned(kws, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(positions in idx, local slots) of the global stream indices this
    rank holds, in idx's order."""
    pos = np.nonzero((idx >= kws.rows.start) & (idx < kws.rows.stop))[0]
    return pos, (idx[pos] - kws.rows.start).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One tensor of an engine's carried stream state: its snapshot name,
    the axis that indexes streams, its value in a fresh stream, its
    dtype."""

    name: str
    axis: int = 0
    fresh: Union[float, int, bool] = 0.0
    dtype: torch.dtype = torch.float32

    def shape(self, row_shape: tuple, n: int) -> tuple:
        """The leaf's shape at n streams."""
        return (*row_shape[:self.axis], n, *row_shape[self.axis:])


class CarriedState:
    """The serving engines' carried stream state, written once over one
    leaf table. An engine lists its leaves in `LEAVES` (snapshot order),
    gives each one's shape per stream without the stream axis
    (`_row_shapes`), and reads and replaces them as a name -> tensor dict
    (`_leaves`, `_set_leaves`). On a mesh each leaf holds this rank's rows
    (`rows`) along its stream axis."""

    LEAVES: Tuple[Leaf, ...] = ()

    def _pairs(self) -> list:
        cur = self._leaves()
        return [(lf, cur[lf.name]) for lf in self.LEAVES]

    def _reset(self, mask: Optional[np.ndarray] = None) -> None:
        """Every leaf back at its fresh value: for all this rank's rows, or
        only for the streams a (n_streams,) bool mask names (global), the
        others untouched."""
        if mask is None:
            rows = self._row_shapes()
            self._set_leaves({lf.name: torch.full(lf.shape(rows[lf.name], self.n_local),
                                                  lf.fresh, dtype=lf.dtype, device=self.device)
                              for lf in self.LEAVES})
            return
        m = torch.as_tensor(mask[self.rows], device=self.device)
        new = {}
        for lf, cur in self._pairs():
            shape = [1] * cur.dim()
            shape[lf.axis] = m.shape[0]
            fresh = torch.full((), lf.fresh, dtype=lf.dtype, device=self.device)
            new[lf.name] = torch.where(m.view(shape), fresh, cur)
        self._set_leaves(new)

    def _checked(self, arrays: dict, n: int, what: str, needs: str) -> dict:
        """arrays[name] of every leaf, each checked for its shape at n
        streams and its dtype."""
        rows, out = self._row_shapes(), {}
        for lf in self.LEAVES:
            a = np.asarray(arrays[lf.name])
            want = (lf.shape(rows[lf.name], n), np.dtype(_NP_OF[lf.dtype]))
            if (a.shape, a.dtype) != want:
                raise ValueError(f"{what} {lf.name!r} is {a.dtype}{a.shape}; this engine "
                                 f"needs {want[1]}{want[0]} — {needs}")
            out[lf.name] = a
        return out

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Host copy of every state leaf (lsm_tpu's leaves, shapes, dtypes
        and axes), all n_streams on every rank (a collective on a mesh).
        Restoring it into a fresh engine with the same weights continues
        every stream bit-exactly, warm-up included (the serving-state files
        hold it)."""
        return {lf.name: gather_streams(self, cur, lf.axis).to("cpu", copy=True).numpy()
                for lf, cur in self._pairs()}

    def restore(self, snap: dict) -> None:
        """Inverse of snapshot(): install a saved state (full arrays, the
        same on every rank; each takes its streams). Unknown segment stats,
        missing leaves and leaves of another shape or dtype (another
        stream count, frontend, reservoir or chunking) raise and leave the
        state as it was."""
        names = [lf.name for lf in self.LEAVES]
        families = {n.split(":")[0] for n in names if ":" in n}           # 'seg:<stat>'
        extra = sorted(k for k in snap
                       if ":" in k and k.split(":")[0] in families and k not in names)
        if extra:
            raise ValueError(f"snapshot has segment stats {extra} this engine does not track "
                             "(different feature set)")
        for n in names:
            if n not in snap:
                raise ValueError(f"snapshot is missing state leaf {n!r} — not a "
                                 f"{type(self).__name__} snapshot, or one from an "
                                 "incompatible build")
        full = self._checked(snap, self.n_streams, "snapshot leaf",
                             "the snapshot was taken with a different stream count, "
                             "frontend, reservoir, or chunk geometry")
        self._set_leaves({lf.name: torch.tensor(full[lf.name][(slice(None),) * lf.axis
                                                              + (self.rows,)], device=self.device)
                          for lf in self.LEAVES})

    def extract_streams(self, stream_idx) -> Dict[str, np.ndarray]:
        """snapshot() restricted to the named stream slots: each leaf's
        rows are gathered on the device, so only they leave it (on a mesh
        the owning rank fills them into a zeroed buffer and one all_reduce
        delivers them to every rank). The unit migrate_streams moves."""
        idx = validate_stream_idx(stream_idx, self.n_streams, "extract_streams").astype(np.int64)
        pos, slots = owned(self, idx)
        pos_t, slots_t = (torch.as_tensor(a).to(self.device) for a in (pos, slots))
        parts = []
        for lf, cur in self._pairs():
            picked = cur.index_select(lf.axis, slots_t)
            if self.mesh is not None:
                shape = list(cur.shape)
                shape[lf.axis] = idx.shape[0]
                picked = torch.zeros(shape, dtype=cur.dtype, device=cur.device).index_copy_(
                    lf.axis, pos_t, picked)
            parts.append(picked)
        if self.mesh is not None:
            parts = deliver_rows(parts, self.mesh)
        return {lf.name: p.cpu().numpy() for lf, p in zip(self.LEAVES, parts)}

    def install_streams(self, stream_idx, rows: dict) -> None:
        """Inverse of extract_streams: scatter donor stream state into the
        named slots (other slots untouched). `rows` carries one row per
        index along each leaf's stream axis, the leaves and dtypes of
        extract_streams; all are checked before any state changes. Each
        rank writes the slots it holds."""
        idx = validate_stream_idx(stream_idx, self.n_streams, "install_streams",
                                  unique=True).astype(np.int64)
        missing = sorted(lf.name for lf in self.LEAVES if lf.name not in rows)
        if missing:
            raise ValueError(f"donor rows are missing state leaves {missing}")
        clean = self._checked(rows, idx.shape[0], "donor leaf",
                              "the donor engine has a different geometry")
        pos, slots = owned(self, idx)
        slots_t = torch.as_tensor(slots).to(self.device)
        self._set_leaves({lf.name: cur.index_copy(lf.axis, slots_t, torch.tensor(
            np.take(clean[lf.name], pos, axis=lf.axis), device=self.device))
            for lf, cur in self._pairs()})


def place_chunk(kws, chunk, fixed_len: bool) -> torch.Tensor:
    """A host chunk through the ingest policy onto the engine's device; a
    tensor must already be a (n_local, L) f32, int16 or uint8 tensor on
    that device with L within the engine's chunk contract. On a mesh a
    chunk holds this rank's rows (`kws.rows`)."""
    max_len = kws.chunk_len if fixed_len else kws.fcfg.num_samples
    if not torch.is_tensor(chunk):
        chunk = normalize_ingest_chunk(chunk, kws.n_local, max_len, fixed_len)
        return place_stream_chunk(chunk, kws.device)
    n = chunk.shape[-1] if chunk.dim() == 2 else -1
    if chunk.dim() != 2 or chunk.shape[0] != kws.n_local or chunk.dtype not in _WIRE_DTYPES \
            or chunk.device != kws.device or not (n == max_len if fixed_len else 0 < n <= max_len):
        want = f"{max_len}" if fixed_len else f"1..{max_len}"
        raise ValueError(
            f"a tensor chunk must be ({kws.n_local}, {want}) float32/int16/uint8 on "
            f"{kws.device}, got {chunk.dtype}{tuple(chunk.shape)} on {chunk.device}"
        )
    return chunk


def decode_pcm_device(chunk: torch.Tensor) -> torch.Tensor:
    """On-device ingest decode: f32 passes through, int16 is linear PCM
    (the decoders' exact /32768), uint8 is G.711 mu-law (ops/ulaw.py)."""
    if chunk.dtype == torch.int16:
        return chunk.to(torch.float32) / 32768.0
    if chunk.dtype == torch.uint8:
        return decode_ulaw(chunk)
    return chunk


def compact_output_device(logits: torch.Tensor) -> torch.Tensor:
    """(B, K) logits -> (B, 2) int16 packed [pred, margin] on the logits'
    device; the host views the words as uint16 (`unpack_compact_output`).

    The decision in 4 bytes a stream: the top-1 class and the top-1/top-2
    logit margin cast to float16, bitcast to 16 bits. lsm_tpu takes both
    from `lax.top_k`, which breaks ties to the lower index; `torch.topk`
    promises no order among ties, so the top-1 is `argmax` (the first
    maximal index, as `step(...).argmax(-1)` gives it) and the second best
    the maximum with that column masked. Torch's uint16 support is partial,
    hence int16 on the device."""
    pred = torch.argmax(logits, dim=-1)
    top1 = torch.gather(logits, 1, pred[:, None])[:, 0]
    masked = logits.scatter(1, pred[:, None], float("-inf"))
    margin = (top1 - torch.amax(masked, dim=-1)).to(torch.float16).view(torch.int16)
    return torch.stack([pred.to(torch.int16), margin], dim=-1)


def unpack_compact_output(packed) -> Tuple[np.ndarray, np.ndarray]:
    """(B, 2) packed [pred, margin] words -> (preds int32, margin f32)."""
    if torch.is_tensor(packed):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed).view(np.uint16)
    preds = packed[:, 0].astype(np.int32)
    margin = packed[:, 1].copy().view(np.float16).astype(np.float32)
    return preds, margin


def wire_silence(dtype) -> int | float:
    """The value a silent stream's producer would have sent, per wire
    format (a NumPy or torch dtype): 0.0 (f32), 0 (int16 PCM), 0xFF (G.711
    mu-law encodes 0 as 0xFF). `step_active` synthesizes silent rows from
    this on the device, so skipping a silent stream's wire bytes is
    bit-equal to sending them."""
    dt = np.dtype(_NP_OF.get(dtype, dtype))
    if dt == np.uint8:
        return 0xFF
    if dt in (np.int16, np.float32):
        return 0
    raise ValueError(f"not an ingest wire dtype: {dt}")


def expand_active_rows(rows: torch.Tensor, idx: torch.Tensor, n_streams: int) -> torch.Tensor:
    """(k, L) active rows + (k,) slot indices -> (n_streams, L) full wire
    chunk with silence everywhere else, on the rows' device."""
    full = torch.full((n_streams, rows.shape[-1]), wire_silence(rows.dtype),
                      dtype=rows.dtype, device=rows.device)
    full[idx] = rows
    return full


def swap_readout_on(kws, readout, scaler_state=None) -> None:
    """Hot readout cutover on a live engine: install a new readout (and
    optionally new scaler moments) without touching stream state. Shapes
    and dtypes must match the live readout: a different feature set or
    class count needs a new engine (and `migrate_streams` into it). The new
    modules are moved to the engine's device. The serving-state weights
    checksum cached on the engine is dropped: snapshots taken after the
    swap digest the new weights, and a snapshot from before it no longer
    loads into this engine."""
    pairs = [("w", readout.w, kws.readout.w), ("b", readout.b, kws.readout.b)]
    if scaler_state is not None:
        pairs += [("mean", scaler_state.mean, kws.scaler_state.mean),
                  ("scale", scaler_state.scale, kws.scaler_state.scale)]
    for name, new, cur in pairs:
        if tuple(new.shape) != tuple(cur.shape) or new.dtype != cur.dtype:
            raise ValueError(
                f"swap_readout {name}: {new.dtype}{tuple(new.shape)} does "
                f"not match the live engine's {cur.dtype}{tuple(cur.shape)} "
                "— a different feature set or class count needs a new engine "
                "(+ migrate_streams)"
            )
    kws.readout = readout.to(kws.device)
    if scaler_state is not None:
        kws.scaler_state = scaler_state.to(kws.device)
    if kws.mesh is not None:
        replicate_to_mesh((kws.readout, kws.scaler_state), kws.mesh)
    kws.__dict__.pop("_serving_weights_crc", None)


def validate_stream_idx(stream_idx, n_streams: int, what: str,
                        unique: bool = False) -> np.ndarray:
    """Host-side validation for row-addressed engine entry points
    (reset, extract_streams, install_streams): an off-by-one from a
    session table must fail loudly instead of moving or clearing the
    wrong stream's state."""
    idx = np.atleast_1d(np.asarray(stream_idx))
    if idx.ndim != 1 or idx.size == 0:
        raise ValueError(f"{what} needs a non-empty 1-D stream index list, "
                         f"got shape {idx.shape}")
    if not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"{what} stream indices must be integers, "
                         f"got {idx.dtype}")
    if idx.min() < 0 or idx.max() >= n_streams:
        raise ValueError(
            f"{what} stream index out of range for {n_streams} streams: "
            f"{idx[(idx < 0) | (idx >= n_streams)][:4].tolist()}"
        )
    if unique and len(set(idx.tolist())) != idx.shape[0]:
        raise ValueError(f"{what} has duplicate stream indices")
    return idx


def _validate_active(rows: np.ndarray, idx: np.ndarray, n_streams: int,
                     chunk_len: Optional[int], max_len: Optional[int] = None) -> None:
    if idx.ndim != 1 or rows.ndim != 2 or rows.shape[0] != idx.shape[0]:
        raise ValueError(
            f"step_active needs rows (k, chunk_len) + idx (k,); got "
            f"rows {rows.shape}, idx {idx.shape}"
        )
    if idx.size and not np.issubdtype(idx.dtype, np.integer):
        # A float index array would truncate to the wrong slots. (An empty
        # idx list arrives as float64 from np.asarray([]) and is harmless.)
        raise ValueError(f"active idx must be integers, got {idx.dtype}")
    if chunk_len is not None and rows.shape[1] != chunk_len:
        raise ValueError(
            f"active rows are {rows.shape[1]} samples; this engine steps "
            f"in {chunk_len}-sample chunks"
        )
    if max_len is not None and not (0 < rows.shape[1] <= max_len):
        # An over-window chunk would change the ring buffer's length.
        raise ValueError(
            f"active rows are {rows.shape[1]} samples; chunks must be "
            f"1..{max_len} (the analysis window)"
        )
    if idx.size and (idx.min() < 0 or idx.max() >= n_streams):
        raise ValueError(f"active idx out of range for {n_streams} streams")
    if len(set(idx.tolist())) != idx.shape[0]:
        raise ValueError("active idx has duplicate slots")


def prepare_active_rows(kws, rows, idx, chunk_len: Optional[int] = None,
                        max_len: Optional[int] = None):
    """Host-side front half of step_active, shared by both engines:
    validate (rows, global slot indices and the wire dtype), keep the rows
    whose slots this rank holds, re-based to its local slots, and place
    them and their int64 slots on the engine's device. lsm_tpu also pads
    k to a power of two there, to bound XLA's compile cache; eager
    PyTorch compiles nothing per shape, so the port passes k rows as
    they are."""
    rows = np.asarray(rows)
    idx = np.asarray(idx)            # dtype validated before any cast
    _validate_active(rows, idx, kws.n_streams, chunk_len, max_len)
    if rows.dtype == np.float64:     # lsm_tpu's jnp.asarray casts it so
        rows = rows.astype(np.float32)
    wire_silence(rows.dtype)         # any other dtype is no wire format
    pos, slots = owned(kws, idx.astype(np.int64))
    return (torch.as_tensor(rows[pos]).to(kws.device), torch.as_tensor(slots).to(kws.device))


def _to_host_async(out: torch.Tensor):
    """Start the D2H copy of a step's output without blocking: (host
    tensor, event to wait on, or None on the CPU)."""
    if out.device.type != "cuda":
        return out, None
    host = out.to("cpu", non_blocking=True)        # pinned, stream-ordered
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def stream_pipelined(kws, chunks, depth: int = 2):
    """Pipelined serving driver shared by both engines.

    Yields one (n_streams, n_classes) logits array per chunk, bit-equal to
    calling `kws.step(chunk)` serially (the same step, in the same order),
    but with up to `depth` steps in flight: chunk k+1's H2D copy and step
    k+1's launches are enqueued before the host waits for step k's logits,
    whose D2H copy is itself asynchronous (pinned memory, one event a
    step). `chunks` is any iterable of host chunks (the shared
    `normalize_ingest_chunk` contract) or device tensors (trusted after a
    shape/dtype/device check). Do not call reset()/step() on `kws` while
    the generator is live: state advances as chunks are dispatched,
    `depth - 1` steps ahead of what has been yielded."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    pending: deque = deque()

    def pop():
        host, ev = pending.popleft()
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    for chunk in chunks:
        out = gather_streams(kws, kws._step_device(kws._place_chunk(chunk)))
        pending.append(_to_host_async(out))
        if len(pending) >= depth:
            yield pop()
    while pending:
        yield pop()


class StreamingKWS(CarriedState):
    """Stateful sliding-window keyword spotter over B parallel streams.

    `reservoir` is the port's dense `Reservoir` or block-sparse
    `SparseReservoir`, `readout` a `LogisticReadout` and `scaler_state` a
    `Scaler`. The engine runs on the reservoir's device and moves the
    readout and scaler there. Its one piece of stream state is `buffer`,
    the (n_streams, num_samples) float32 trailing window. Chunks of 1 to
    num_samples samples arrive as float32 samples in [-1, 1], int16 PCM or
    uint8 mu-law, host arrays or device tensors. With `mesh=`, `buffer`
    holds this rank's rows and chunks carry them (module docstring)."""

    def __init__(
        self,
        reservoir: Union[res.Reservoir, SparseReservoir],
        readout: logistic.LogisticReadout,
        scaler_state: scaler.Scaler,
        fcfg: FrontendConfig,
        feature_set: str = "original",
        n_streams: int = 1,
        mesh: Optional[Mesh] = None,
    ):
        if not isinstance(reservoir, (res.Reservoir, SparseReservoir)):
            raise TypeError(
                f"unsupported reservoir {type(reservoir).__name__}: the engine "
                "runs the port's Reservoir or SparseReservoir (lsm_tpu_torch.convert "
                "carries lsm_tpu's parameters across)"
            )
        self.device = reservoir.w_in.device
        self.reservoir = reservoir
        self.readout = readout.to(self.device)
        self.scaler_state = scaler_state.to(self.device)
        self.fcfg = fcfg
        self.keys = tuple(FEATURE_SETS[feature_set])
        self.n_streams = int(n_streams)
        bind_mesh(self, mesh, "n_streams={n_streams} must be divisible by the mesh data "
                              "axis ({n_data}) so stream shards are equal")
        self._reset()

    LEAVES = (Leaf("buffer"),)

    def _row_shapes(self) -> dict:
        return {"buffer": (self.fcfg.num_samples,)}

    def _leaves(self) -> Dict[str, torch.Tensor]:
        return {"buffer": self.buffer}

    def _set_leaves(self, leaves: dict) -> None:
        self.buffer = leaves["buffer"]

    def _evaluate(self, buffer: torch.Tensor) -> torch.Tensor:
        """The batch path over the (B, num_samples) windows: logits (B, K)."""
        spikes = featurize_batch(buffer, self.fcfg)
        feats = res.extract_features(self.reservoir, spikes, self.keys)
        sc, ro = self.scaler_state, self.readout
        return (feats - sc.mean) / sc.scale @ ro.w + ro.b

    def _step_device(self, chunk: torch.Tensor) -> torch.Tensor:
        """One hop on a device-resident wire chunk: push it into the ring
        buffer and evaluate; returns the (B, K) logits on the device."""
        chunk = decode_pcm_device(chunk)
        n = chunk.shape[-1]
        self.buffer = torch.cat([self.buffer[:, n:], chunk], dim=-1)
        return self._evaluate(self.buffer)

    def _place_chunk(self, chunk) -> torch.Tensor:
        return place_chunk(self, chunk, fixed_len=False)

    def push(self, chunk) -> None:
        """Append a (n_streams, chunk_len) chunk to the ring buffer (same
        ingest contract as step())."""
        chunk = decode_pcm_device(self._place_chunk(chunk))
        self.buffer = torch.cat([self.buffer[:, chunk.shape[-1]:], chunk], dim=-1)

    def logits(self) -> np.ndarray:
        """Evaluate the current trailing window: (n_streams, n_classes)."""
        return gather_streams(self, self._evaluate(self.buffer)).cpu().numpy()

    def predict(self) -> np.ndarray:
        return np.argmax(self.logits(), axis=-1)

    def step(self, chunk) -> np.ndarray:
        """push + logits in one call: (n_streams, n_classes) on the host.
        int16 PCM and float32 samples of the same values (pcm / 32768) give
        the same bits."""
        return gather_streams(self, self._step_device(self._place_chunk(chunk))).cpu().numpy()

    def step_compact(self, chunk) -> Tuple[np.ndarray, np.ndarray]:
        """step() with the compact decision output (compact_output_device):
        (preds int32 (B,), margin f32 (B,)), 4 bytes a stream off the
        device; preds equal step(chunk).argmax(-1)."""
        return unpack_compact_output(gather_streams(
            self, compact_output_device(self._step_device(self._place_chunk(chunk)))))

    def step_active(self, rows, active_idx, compact: bool = False):
        """step() with only the active streams' audio on the wire: `rows`
        (k, chunk_len) in any ingest wire format for the k slots
        `active_idx`. The other streams advance on wire silence synthesized
        on the device, so the logits are bit-equal to step() on the full
        chunk with silence in the inactive rows. compact=True returns
        (preds, margin) as step_compact does. On a mesh every rank passes
        the same global rows and slots."""
        rows_d, idx_d = prepare_active_rows(self, rows, active_idx,
                                            max_len=self.fcfg.num_samples)
        out = self._step_device(expand_active_rows(rows_d, idx_d, self.n_local))
        if compact:
            return unpack_compact_output(gather_streams(self, compact_output_device(out)))
        return gather_streams(self, out).cpu().numpy()

    def stream(self, chunks, depth: int = 2):
        """Pipelined serving loop: yields per-chunk logits, bit-equal to
        serial step() calls (see stream_pipelined)."""
        return stream_pipelined(self, chunks, depth=depth)

    def steps_fused(self, chunk, k: int) -> float:
        """k consecutive step() calls on the same chunk, with one host
        transfer at the end: the last hop's logit sum. The state advances
        exactly as k step() calls on that chunk."""
        dev = self._place_chunk(chunk)
        for _ in range(int(k)):
            out = self._step_device(dev)
        return float(torch.sum(gather_streams(self, out), dtype=torch.float32))

    def diagnostics(self, stream_idx=None) -> ServingDiagnosticsReport:
        """Reservoir health on live traffic: re-simulates each stream's
        trailing window and reports full-reservoir participation, dead
        neurons and mean rate with the batch diagnostics' thresholds.
        `stream_idx` selects the streams the verdict averages over (None =
        all). One whole-window simulation a call; on a mesh a collective
        that gives every rank the same report."""
        spikes = featurize_batch(self.buffer, self.fcfg)
        counts = res.simulate_batch(self.reservoir, spikes)["all_counts"]
        active = torch.sum(counts > 0, dim=1).to(torch.int32)
        total = torch.sum(counts, dim=1)
        return serving_report(gather_streams(self, active).cpu().numpy(),
                              gather_streams(self, total).cpu().numpy(),
                              self.reservoir.n_neurons, "full", stream_idx)

    def swap_readout(self, readout, scaler_state=None) -> None:
        """Hot readout cutover on the live engine (see swap_readout_on)."""
        swap_readout_on(self, readout, scaler_state)

    def reset(self, stream_idx=None) -> None:
        """Zero the window of all streams (None) or of the named slots
        (global indices; each rank clears the ones it holds)."""
        mask = None
        if stream_idx is not None:
            mask = np.zeros(self.n_streams, np.bool_)
            mask[validate_stream_idx(stream_idx, self.n_streams, "reset")] = True
        self._reset(mask)
