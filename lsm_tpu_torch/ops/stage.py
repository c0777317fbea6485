"""The serving engines' staging copy: a host chunk's rows copied into
page-locked memory in row blocks, by the calling thread and a process-wide
pool of helper threads together (csrc/stage.cpp, plain C++ built by g++ at
first use), so that the caller can issue each block's host-to-device copy
as soon as that block has landed (models/streaming.py `IngestSlots`).

One copy runs at a time in a process; a second caller waits for the first
to end. The helpers are started at the first copy that needs them and live
as long as the process. The plain twin is `np.copyto`.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Iterator

import numpy as np

from lsm_tpu_torch.ops import _build

_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_native(_build.STAGE_SOURCE)))
            lib.lsm_stage_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int]
            lib.lsm_stage_begin.restype = ctypes.c_int
            lib.lsm_stage_wait.argtypes = [ctypes.c_int]
            lib.lsm_stage_wait.restype = None
            lib.lsm_stage_end.argtypes = []
            lib.lsm_stage_end.restype = None
            _lib = lib
        return _lib


@contextlib.contextmanager
def copy_rows(dst: np.ndarray, src: np.ndarray, per_block: int,
              threads: int) -> Iterator[Callable[[int], None]]:
    """Copy the (rows, n) array `src` (rows any distance apart, each row
    contiguous) into the C-contiguous `dst` of the same shape and dtype, in
    blocks of `per_block` rows, on `threads` host threads, the calling one
    included. Yields `landed(b)`, which returns once block b (rows
    b * per_block onwards) is in `dst`, the calling thread copying blocks
    no one has taken meanwhile. Every block has landed when the block
    exits, and `src` is not read after that."""
    if dst.shape != src.shape or dst.dtype != src.dtype or src.ndim != 2:
        raise ValueError(f"cannot stage {src.dtype}{src.shape} into {dst.dtype}{dst.shape}")
    if not dst.flags.c_contiguous or (src.shape[1] > 1 and src.strides[1] != src.itemsize):
        raise ValueError("staging needs a C-contiguous destination and contiguous source rows")
    lib = _library()
    n = lib.lsm_stage_begin(dst.ctypes.data, src.ctypes.data, src.shape[0],
                            src.shape[1] * src.itemsize, src.strides[0], per_block, threads)
    if n < 0:
        raise ValueError(f"cannot stage {src.shape[0]} rows in blocks of {per_block} "
                         f"on {threads} threads")
    try:
        yield lib.lsm_stage_wait
    finally:
        lib.lsm_stage_end()
