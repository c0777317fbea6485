"""Stream-slot pool: the session layer for always-on serving (port of
lsm_tpu/models/pool.py).

The engines (StreamingKWS, ContinuousKWS) are fixed-width programs over
`n_streams` slots; a deployment's sessions come and go. The pool composes
what the engines already offer — per-slot reset, partial-activity stepping
(`step_active`: only connected sessions' audio crosses to the device, with
the compact decision egress) and row-level migration
(`serving_state.migrate_streams`) — into the admit/step/finish lifecycle a
server runs. Every path is bit-equal to driving the engine directly.

Over a mesh engine every rank makes the same calls with the same
arguments: the slot table is host state and stays identical on every
rank, since the admit/step/finish sequence is the same everywhere; the
engine calls underneath (step_active on global rows, reset, diagnostics,
snapshot, migration) are the engine's collectives, and save() writes on
rank 0.
"""

from __future__ import annotations

from typing import Dict, Hashable, Optional, Sequence

import numpy as np


class PoolFullError(RuntimeError):
    """No free slots: scale out (another engine) or finish sessions."""


class StreamPool:
    """Maps session ids onto engine stream slots.

    - `admit(session_id)` claims a free slot, freshly reset (the engine's
      cold-start state, what a new stream must see).
    - `step(audio_by_session)` advances all slots one chunk: connected
      sessions' rows ride the wire (any ingest format), every other slot —
      free or connected but silent this hop — advances on wire silence
      synthesized on the device. Returns per-session (pred, margin) from
      the compact egress.
    - `finish(session_id)` recycles the slot (masked reset; other slots
      untouched).
    - `drain(session_ids, dst_pool)` migrates live sessions to another
      pool's engine bit-exactly, then recycles the local slots.
    """

    def __init__(self, kws, chunk_len: Optional[int] = None, wire_dtype=None):
        """`chunk_len`: the deployment's hop in samples. Defaults to the
        engine's own (continuous mode); needed for the exact engine if an
        all-silent hop can come before the first fed one (the pool must
        know how far silence advances time). Otherwise taken from the first
        fed hop. `wire_dtype`: the deployment's ingest format (float32,
        int16 or uint8 mu-law), taken from the first fed hop if not given;
        an all-silent hop before any fed one uses it (float32 if unknown)."""
        self.kws = kws
        self._free = list(range(kws.n_streams - 1, -1, -1))  # pop -> slot 0 first
        self._slot_of: Dict[Hashable, int] = {}
        self._chunk_len = chunk_len or getattr(kws, "chunk_len", None)
        self._wire_dtype = np.dtype(wire_dtype) if wire_dtype else None

    @property
    def capacity(self) -> int:
        return self.kws.n_streams

    @property
    def n_active(self) -> int:
        return len(self._slot_of)

    def slot_of(self, session_id: Hashable) -> int:
        return self._slot_of[session_id]

    def _claim(self, session_id: Hashable) -> int:
        """Bookkeeping half of admit: take a free slot without resetting it
        (drain() overwrites every state leaf by migration)."""
        if session_id in self._slot_of:
            raise ValueError(f"session {session_id!r} is already admitted")
        if not self._free:
            raise PoolFullError(f"all {self.capacity} slots are serving sessions")
        slot = self._free.pop()
        self._slot_of[session_id] = slot
        return slot

    def admit(self, session_id: Hashable) -> int:
        slot = self._claim(session_id)
        # A new session starts from the engine's cold state, whatever the
        # slot's previous tenant (or the silence feed) left behind.
        self.kws.reset(slot)
        return slot

    def finish(self, session_id: Hashable) -> None:
        slot = self._slot_of.pop(session_id)
        self.kws.reset(slot)
        self._free.append(slot)

    def step(self, audio_by_session: Dict[Hashable, np.ndarray]):
        """Advance every slot one chunk; only `audio_by_session`'s rows go
        to the device. Sessions absent from the dict (and free slots)
        advance on wire silence. Returns {session_id: (pred int, margin
        float)} for every connected session, fed this hop or not. All rows
        share one dtype (one wire format a hop)."""
        unknown = [s for s in audio_by_session if s not in self._slot_of]
        if unknown:
            raise KeyError(f"sessions not admitted: {unknown[:4]}")
        sessions = sorted(self._slot_of, key=lambda s: self._slot_of[s])
        if audio_by_session:
            fed = sorted(audio_by_session, key=lambda s: self._slot_of[s])
            idx = np.asarray([self._slot_of[s] for s in fed], np.int64)
            arrs = [np.asarray(audio_by_session[s]) for s in fed]
            dtypes = {a.dtype for a in arrs}
            if len(dtypes) > 1:
                # np.stack would promote (int16 rows read as f32 enter the
                # featurizer 32768x too loud).
                raise ValueError(
                    f"mixed wire dtypes in one hop: {sorted(map(str, dtypes))}"
                    " — transcode producers to one format per step"
                )
            rows = np.stack(arrs)
        else:
            # Nobody spoke this hop: free and silent slots still advance,
            # by one hop of the deployment's cadence, in its wire dtype.
            if self._chunk_len is None:
                raise ValueError(
                    "all-silent hop before any fed hop on an exact-mode "
                    "pool: pass chunk_len to StreamPool so silence "
                    "advances time by the deployment's real hop size"
                )
            dt = np.float32 if self._wire_dtype is None else self._wire_dtype
            rows = np.zeros((0, self._chunk_len), dt)
            idx = np.zeros((0,), np.int64)
        preds, margins = self.kws.step_active(rows, idx, compact=True)
        if rows.shape[0]:
            # Cache the silent-hop geometry only after the engine accepted
            # the rows: a malformed hop raises in step_active first.
            self._chunk_len = rows.shape[1]
            self._wire_dtype = rows.dtype
        return {s: (int(preds[self._slot_of[s]]), float(margins[self._slot_of[s]]))
                for s in sessions}

    def diagnostics(self):
        """Reservoir health over the connected sessions only (free slots
        are fed silence): (the engine's ServingDiagnosticsReport over the
        connected slots, {session_id: (participation %, spikes/neuron)}).
        Raises ValueError on an empty pool. A collective on a mesh."""
        sessions = sorted(self._slot_of, key=lambda s: self._slot_of[s])
        rep = self.kws.diagnostics(stream_idx=[self._slot_of[s] for s in sessions])
        per_session = {s: (float(rep.participation[i]), float(rep.spikes_per_neuron[i]))
                       for i, s in enumerate(sessions)}
        return rep, per_session

    def save(self, path, compress: bool = True) -> None:
        """Checkpoint the whole serving unit: the engine's stream state (a
        serving-state file, validated as such on restore) plus this pool's
        session table — slot map, free-slot order, hop length and wire
        dtype. Session ids must be JSON scalars (str, int, bool, None). On a
        mesh every rank calls it; rank 0 writes."""
        from lsm_tpu_torch.io.serving_state import write_snapshot

        for s in self._slot_of:
            if not isinstance(s, (str, int, bool)) and s is not None:
                raise TypeError(
                    f"session id {s!r} is not a JSON scalar — StreamPool."
                    "save() persists ids as str/int/bool/None; map richer "
                    "ids to strings before admitting them"
                )
        pool_meta = {
            "pool": {
                "sessions": [[s, slot] for s, slot in self._slot_of.items()],
                "free": list(self._free),
                "chunk_len": self._chunk_len,
                "wire_dtype": str(self._wire_dtype) if self._wire_dtype is not None else None,
            }
        }
        write_snapshot(path, self.kws, self.kws.snapshot(), compress=compress,
                       extra_meta=pool_meta)

    @classmethod
    def restore(cls, path, kws) -> "StreamPool":
        """Rebuild a pool from a save()d file onto a fresh engine: the
        engine state installs bit-exactly (load_serving_state's
        validation) and the session table comes back as written — the
        same slot per session, the same free-list order, hop length and
        wire dtype. The table is validated before the engine is touched,
        so a rejected file leaves the engine as it was."""
        from lsm_tpu_torch.io.serving_state import load_serving_state, read_snapshot_meta

        pm = read_snapshot_meta(path).get("pool")
        if pm is None:
            raise ValueError(
                "snapshot has no pool session table (it was written with "
                "save_serving_state, not StreamPool.save) — restore the "
                "engine with load_serving_state and re-admit sessions"
            )
        slot_of = {s: int(slot) for s, slot in pm["sessions"]}
        free = [int(i) for i in pm["free"]]
        claimed = list(slot_of.values())
        if sorted(claimed + free) != list(range(kws.n_streams)):
            raise ValueError(
                "pool session table is corrupt: claimed slots "
                f"{sorted(claimed)} + free {sorted(free)} do not "
                f"partition {kws.n_streams} slots"
            )
        load_serving_state(path, kws)
        pool = cls(kws, chunk_len=pm["chunk_len"], wire_dtype=pm["wire_dtype"])
        pool._slot_of = slot_of
        pool._free = free
        return pool

    def drain(self, session_ids: Sequence[Hashable], dst_pool: "StreamPool") -> None:
        """Move live sessions to `dst_pool` bit-exactly (row-level migration
        into claimed destination slots) and recycle the local slots with one
        reset. On any failure — capacity, duplicate ids, engine mismatch —
        the claims roll back and nothing has moved."""
        from lsm_tpu_torch.io.serving_state import migrate_streams

        session_ids = list(session_ids)
        if not session_ids:
            return
        if len(set(session_ids)) != len(session_ids):
            raise ValueError("duplicate session ids in drain()")
        src_idx = [self._slot_of[s] for s in session_ids]  # KeyError early
        claimed = []
        try:
            dst_idx = []
            for s in session_ids:
                dst_idx.append(dst_pool._claim(s))
                claimed.append(s)
            migrate_streams(self.kws, dst_pool.kws, src_idx, dst_idx)
        except Exception:
            # Claims are bookkeeping only: undo them in reverse claim order
            # (_claim pops from the list's tail), so the free list is as it
            # was and a later admit() lands in the same slot.
            for s in reversed(claimed):
                dst_pool._free.append(dst_pool._slot_of.pop(s))
            raise
        self.kws.reset(np.asarray(src_idx))
        for s in session_ids:
            self._free.append(self._slot_of.pop(s))
