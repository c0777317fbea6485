"""ctypes binding to the native C++ batch WAV decoder (csrc/wavio.cpp), the
port of lsm_tpu/io/native.py.

The library builds with g++ at first use (ops/_build.py `build_wavio`).
Where it cannot be built or loaded, `available()` is False and
io/wav.py's `load_audio_batch` decodes in NumPy instead, so the package has
no hard native dependency. `batches` counts the batches this decoder
decoded, so a caller can tell which decoder ran.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None

batches = 0          # batches decoded by the native decoder

# The three entry points: wire dtype -> (symbol, ctypes element type).
_ENTRIES = {
    "float32": ("wavio_decode_batch", ctypes.c_float),
    "int16": ("wavio_decode_batch_i16", ctypes.c_int16),
    "ulaw": ("wavio_decode_batch_ulaw", ctypes.c_uint8),
}


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            from lsm_tpu_torch.ops import _build

            lib = ctypes.CDLL(str(_build.build_wavio()))
            for symbol, elem in _ENTRIES.values():
                fn = getattr(lib, symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                               ctypes.c_double, ctypes.c_int, ctypes.POINTER(elem),
                               ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            if lib.wavio_abi_version() != 1:
                raise OSError("wavio ABI mismatch")
            _lib = lib
        except (OSError, AttributeError, RuntimeError) as e:
            _load_error = str(e)
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the decoder could not be built or loaded (None if it was)."""
    _load()
    return _load_error


def supports_i16() -> bool:
    return available()


def supports_ulaw() -> bool:
    return available()


def load_audio_batch(
    paths: Sequence[Path],
    sample_rate: int = 16000,
    duration: float = 1.0,
    n_threads: int = 0,
    dtype: str = "float32",
) -> Tuple[np.ndarray, List[int], List[Tuple[Path, str]]]:
    """io/wav.py `load_audio_batch`'s contract on the native decoder, on
    n_threads worker threads (0: one a core). dtype "int16" copies mono
    PCM16 files at the target rate straight into the wire and quantizes the
    rest as `to_pcm16_wire`; "ulaw" is `encode_ulaw` of that wire, with
    0xFF (silence) padding."""
    global batches
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native wavio unavailable: {_load_error}")
    if dtype not in _ENTRIES:
        raise ValueError(f"unknown audio wire {dtype!r}")
    symbol, elem = _ENTRIES[dtype]
    n = len(paths)
    target = int(sample_rate * duration)
    ok = np.zeros(n, dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
    if dtype == "ulaw":
        out = np.full((n, target), 0xFF, dtype=np.uint8)
    else:
        out = np.zeros((n, target), dtype=np.dtype(dtype))
    getattr(lib, symbol)(c_paths, n, sample_rate, duration, target,
                         out.ctypes.data_as(ctypes.POINTER(elem)),
                         ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    batches += 1
    kept = [i for i in range(n) if ok[i]]
    errors = [(Path(paths[i]), _describe_failure(paths[i])) for i in range(n) if not ok[i]]
    return out[kept], kept, errors


def _describe_failure(path) -> str:
    """A failed file's message: a recognizable FLAC/Ogg/MP3 head gets the
    unsupported-container message, anything else "decode failed"."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError as e:
        return str(e)
    from lsm_tpu_torch.io.wav import unsupported_container_error

    msg = unsupported_container_error(head)
    return msg if msg is not None else "decode failed"
