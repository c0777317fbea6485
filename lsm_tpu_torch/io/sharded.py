"""Sharded spike datasets for corpora too large for one .npz (a copy of
lsm_tpu/io/sharded.py: the same format tag, file names, journal and
manifest, so either package reads and resumes the other's shards).

A dataset is a directory of `shard_{i:05d}.npz` files (each a spike-dataset
.npz with the reference's keys, so any shard loads with the classic
loader), a `journal.jsonl` appended after every shard flush, and a
`manifest.json` written on close. The journal is the incremental manifest:
an interrupted run loses only its unflushed buffer, and a rerun with
`resume=True` continues after the last journaled shard (each entry records
the index of the last input file its shard consumed).
"""

from __future__ import annotations

import json
import struct
import zipfile
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from lsm_tpu_torch.io.artifacts import SpikeDataset

_MANIFEST = "manifest.json"
_JOURNAL = "journal.jsonl"
_FORMAT = "lsm_tpu.sharded_spike_dataset.v1"


def _mmap_npz_member(path: Path, member: str) -> Optional[np.ndarray]:
    """A read-only np.memmap of an UNCOMPRESSED .npz member, or None (the
    caller then uses np.load) for a compressed member, a Fortran-order or
    object array, or unexpected container bytes. A stored member's .npy
    bytes sit contiguously in the zip, so the view skips zipfile's copy and
    CRC pass and faults in only the pages a reader touches."""
    try:
        with zipfile.ZipFile(path) as zf:
            try:
                info = zf.getinfo(member + ".npy")
            except KeyError:
                return None
            if info.compress_type != zipfile.ZIP_STORED:
                return None
            header_offset = info.header_offset
        with open(path, "rb") as f:
            f.seek(header_offset)
            hdr = f.read(30)
            if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
                return None
            name_len, extra_len = struct.unpack("<HH", hdr[26:30])
            f.seek(header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                return None
            if fortran or dtype.hasobject:
                return None
            array_offset = f.tell()
        return np.memmap(path, dtype=dtype, mode="r", offset=array_offset,
                         shape=shape)
    except (OSError, ValueError, zipfile.BadZipFile):
        return None


class ShardedSpikeDatasetWriter:
    """Append batches; each flush writes one shard and one journal line.

    With `resume=True` an existing journal is replayed: complete shards
    (journal entry present and shard file on disk) are kept, and
    `resume_file_index` gives the last input-file index already featurized.
    Entries without file indices cannot anchor a resume and force a fresh
    start, and so does a journal written under another `fingerprint` (the
    config and input file list the shard contents depend on). `meta`
    (the featurization and vocabulary, config.corpus_meta) goes into the
    journal header and the manifest; a resumed run keeps the stored one.
    """

    def __init__(
        self,
        root: Path,
        shard_size: int = 8192,
        resume: bool = False,
        compress: bool = True,
        fingerprint: Optional[str] = None,
        meta: Optional[dict] = None,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.shard_size = shard_size
        # Spike trains compress ~190:1 under zlib; compress=False trades the
        # disk for reads without decompression.
        self.compress = compress
        self.fingerprint = fingerprint
        self.meta = dict(meta or {})
        self._x: List[np.ndarray] = []
        self._y: List[np.ndarray] = []
        self._f: List[np.ndarray] = []
        self._off = 0              # read offset into the FIRST buffer entry
        self._buffered = 0
        self._shards: List[dict] = []
        self._header_written = False
        self.resume_file_index = -1

        if resume:
            self._load_journal()
        if not resume or self.resume_file_index < 0:
            # Fresh run (or rejected resume): drop stale state so a crash of
            # this run cannot be confused with the previous one's.
            (self.root / _JOURNAL).unlink(missing_ok=True)
            (self.root / _MANIFEST).unlink(missing_ok=True)
            self._shards = []
            self.resume_file_index = -1
            self._header_written = False

    def _load_journal(self) -> None:
        journal = self.root / _JOURNAL
        if not journal.exists():
            return
        entries = []
        header_fp = None
        header_meta: Optional[dict] = None
        for line in journal.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                break  # truncated trailing line from a crash mid-append
            if "header" in e:
                header_fp = e["header"].get("fingerprint")
                header_meta = e["header"].get("meta")
                continue
            if not (self.root / e["file"]).exists():
                break  # journal ahead of disk
            if e.get("last_file_index", -1) < 0:
                entries = []   # an entry without a resume anchor
                break
            entries.append(e)
        if entries and header_fp != self.fingerprint:
            entries = []       # shards of another config or input list
        if entries:
            self._shards = entries
            self.resume_file_index = entries[-1]["last_file_index"]
            self._header_written = True
            if header_meta is not None:
                self.meta = header_meta
            # Rewrite the journal to exactly the validated prefix, dropping
            # any truncated or orphaned tail.
            with open(journal, "w") as f:
                f.write(json.dumps(self._header()) + "\n")
                for e in entries:
                    f.write(json.dumps(e) + "\n")

    def _header(self) -> dict:
        h = {"fingerprint": self.fingerprint}
        if self.meta:
            h["meta"] = self.meta
        return {"header": h}

    def completed_shards(self) -> List[dict]:
        return list(self._shards)

    def append(
        self,
        x_spikes: np.ndarray,
        y_labels: np.ndarray,
        file_indices: Optional[np.ndarray] = None,
    ) -> None:
        """Buffer one batch. `file_indices` (per-sample indices into the
        caller's input file list) anchor a resume; without them the shards
        are written but the run cannot resume."""
        if x_spikes.shape[0] != y_labels.shape[0]:
            raise ValueError("batch length mismatch")
        if file_indices is None:
            file_indices = np.full(x_spikes.shape[0], -1, np.int64)
        elif len(file_indices) != x_spikes.shape[0]:
            raise ValueError("file_indices length mismatch")
        self._x.append(np.asarray(x_spikes, np.uint8))
        self._y.append(np.asarray(y_labels, np.int32))
        self._f.append(np.asarray(file_indices, np.int64))
        self._buffered += x_spikes.shape[0]
        while self._buffered >= self.shard_size:
            self._flush_shard(self.shard_size)

    def _take(self, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pop exactly n buffered rows through sliced views and a read
        offset (one copy of the rows, not of the whole buffer)."""
        parts_x, parts_y, parts_f = [], [], []
        need = n
        while need:
            x0 = self._x[0]
            take = min(need, x0.shape[0] - self._off)
            sl = slice(self._off, self._off + take)
            parts_x.append(x0[sl])
            parts_y.append(self._y[0][sl])
            parts_f.append(self._f[0][sl])
            need -= take
            if self._off + take == x0.shape[0]:
                self._x.pop(0)
                self._y.pop(0)
                self._f.pop(0)
                self._off = 0
            else:
                self._off += take
        self._buffered -= n
        if len(parts_x) == 1:
            return parts_x[0], parts_y[0], parts_f[0]
        return (np.concatenate(parts_x, axis=0),
                np.concatenate(parts_y, axis=0),
                np.concatenate(parts_f, axis=0))

    def _flush_shard(self, n: int) -> None:
        shard_x, shard_y, shard_f = self._take(n)
        idx = len(self._shards)
        name = f"shard_{idx:05d}.npz"
        save = np.savez_compressed if self.compress else np.savez
        save(self.root / name, X_spikes=shard_x, y_labels=shard_y)
        entry = {
            "file": name,
            "num_samples": int(shard_x.shape[0]),
            "last_file_index": int(shard_f[-1]) if shard_f.shape[0] else -1,
            "spikes": int(shard_x.sum(dtype=np.int64)),
            "row_shape": list(shard_x.shape[1:]),
        }
        self._shards.append(entry)
        # Journal the shard the moment it exists.
        with open(self.root / _JOURNAL, "a") as jf:
            if not self._header_written:
                jf.write(json.dumps(self._header()) + "\n")
                self._header_written = True
            jf.write(json.dumps(entry) + "\n")
            jf.flush()

    def close(self) -> dict:
        if self._buffered:
            self._flush_shard(self._buffered)
        manifest = {
            "format": _FORMAT,
            "num_samples": int(sum(s["num_samples"] for s in self._shards)),
            "shards": self._shards,
        }
        if self.meta:
            manifest["meta"] = self.meta
        (self.root / _MANIFEST).write_text(json.dumps(manifest, indent=2))
        return manifest


class ShardedSpikeDataset:
    """Reader: shards or fixed-size batches without loading the whole
    corpus. Without a manifest it reads the journal of a crashed run and
    keeps its valid prefix: it stops at a truncated line or at an entry
    whose shard file is missing."""

    def __init__(self, root: Path):
        self.root = Path(root)
        manifest_path = self.root / _MANIFEST
        if manifest_path.exists():
            self.manifest = json.loads(manifest_path.read_text())
            if self.manifest.get("format") != _FORMAT:
                raise ValueError("unknown sharded dataset format")
        elif (self.root / _JOURNAL).exists():
            shards: List[dict] = []
            journal_meta: Optional[dict] = None
            for line in (self.root / _JOURNAL).read_text().splitlines():
                if not line.strip():
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    break                      # truncated tail: stop here
                if "header" in e:
                    journal_meta = e["header"].get("meta")
                    continue
                if not (self.root / e["file"]).exists():
                    break
                shards.append(e)
            self.manifest = {
                "format": _FORMAT,
                "num_samples": int(sum(s["num_samples"] for s in shards)),
                "shards": shards,
                "partial": True,
            }
            if journal_meta:
                self.manifest["meta"] = journal_meta
        else:
            raise FileNotFoundError(f"no manifest or journal at {self.root}")

    @property
    def num_samples(self) -> int:
        return self.manifest["num_samples"]

    @property
    def meta(self) -> dict:
        """Writer-recorded metadata ({} if none): 'frontend' (a
        FrontendConfig dict, config.frontend_from_dict) and 'class_names'."""
        return self.manifest.get("meta", {})

    @property
    def is_partial(self) -> bool:
        return bool(self.manifest.get("partial", False))

    @property
    def total_spikes(self) -> Optional[int]:
        """Corpus spike count from the per-shard journal stats; None for
        datasets written without them."""
        shards = self.manifest["shards"]
        if not shards:
            return 0
        if any("spikes" not in s for s in shards):
            return None
        return int(sum(s["spikes"] for s in shards))

    @property
    def row_shape(self) -> Optional[tuple]:
        """(channels, time) of one spike row from the journal stats, or None."""
        shards = self.manifest["shards"]
        if shards and "row_shape" in shards[0]:
            return tuple(shards[0]["row_shape"])
        return None

    @property
    def x_spikes(self) -> np.ndarray:
        """The materialized spike tensor (a cached load_all); corpus-scale
        consumers stream with iter_batches instead."""
        return self._materialized().x_spikes

    @property
    def y_labels(self) -> np.ndarray:
        return self._materialized().y_labels

    def _materialized(self) -> SpikeDataset:
        cached = getattr(self, "_all", None)
        if cached is None:
            cached = self._all = self.load_all()
        return cached

    def _load_shard(self, s: dict) -> SpikeDataset:
        path = self.root / s["file"]
        x = _mmap_npz_member(path, "X_spikes")
        y = _mmap_npz_member(path, "y_labels")
        if x is not None and y is not None:
            return SpikeDataset(x_spikes=x, y_labels=np.asarray(y))
        data = np.load(path)
        return SpikeDataset(x_spikes=data["X_spikes"], y_labels=data["y_labels"])

    def iter_shards(self) -> Iterator[SpikeDataset]:
        """Yield shards in order."""
        for s in self.manifest["shards"]:
            yield self._load_shard(s)

    def iter_batches(self, batch_size: int) -> Iterator[SpikeDataset]:
        """Re-chunk shards into batches of exactly batch_size rows (the last
        may be short), each shard loaded once."""
        pending: List[Tuple[np.ndarray, np.ndarray, int]] = []
        n_pending = 0

        def pop(n: int) -> SpikeDataset:
            nonlocal n_pending
            parts_x, parts_y = [], []
            need = n
            while need:
                x, y, off = pending[0]
                take = min(need, x.shape[0] - off)
                parts_x.append(x[off : off + take])
                parts_y.append(y[off : off + take])
                need -= take
                n_pending -= take
                if off + take == x.shape[0]:
                    pending.pop(0)
                else:
                    pending[0] = (x, y, off + take)
            if len(parts_x) == 1:
                return SpikeDataset(parts_x[0], parts_y[0])
            return SpikeDataset(
                np.concatenate(parts_x, axis=0), np.concatenate(parts_y, axis=0)
            )

        for shard in self.iter_shards():
            pending.append((shard.x_spikes, shard.y_labels, 0))
            n_pending += shard.x_spikes.shape[0]
            while n_pending >= batch_size:
                yield pop(batch_size)
        if n_pending:
            yield pop(n_pending)

    def load_all(self) -> SpikeDataset:
        xs, ys = [], []
        for shard in self.iter_shards():
            xs.append(shard.x_spikes)
            ys.append(shard.y_labels)
        return SpikeDataset(np.concatenate(xs), np.concatenate(ys))
