"""The continuous serving readout's window fold (csrc/fold.cu).

It replaces no TPU kernel: lsm_tpu's `fold_segment_stats` and
`features_from_stats` are jnp code. The kernel is one bytes-bound pass over
the serving engine's carried rings (models/continuous.py): it pushes a
hop's segment summary into the nine (n_ring, B, no) segment rings and its
rate-window counts into the (B, no, n_win) window ring, writing both to new
tensors, folds the rings into whole-window statistics and writes the
(B, len(keys) * no) window features; with no hop segment it folds the rings
as they are (`ContinuousKWS.features`, `fit_continuous_readout`). The
feature keys travel as launch arguments, so every `FEATURE_SETS` entry
takes it.

The plain twin `fold_plain` is the engine's op-by-op path (torch.cat ring
pushes, `reservoir.fold_segment_stats`, `reservoir.features_from_stats`);
CPU tensors take it. On the card the kernel keeps the twin's op order and
rounds each operation on its own, so its rings and features are the twin's
bits there.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lsm_tpu_torch.config import FEATURE_SETS
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops.kernels.lif import SEG_KEYS

FEATURE_CODES = {k: i for i, k in enumerate(FEATURE_SETS["all"])}   # the kernel's key codes
MAX_KEYS = 16
MAX_WINDOWS = 454        # a CTA's 128 window rows of n_win floats in 227 KB of shared memory

launches = 0             # kernel launches (the plain twin does not count)
_fn = None               # the C entry point, bound at first use


def fold_plain(segs: Dict[str, torch.Tensor], win_ring: torch.Tensor, seg_len: int,
               burst_isi_max: int, keys: Sequence[str], new_seg=None, win_new=None):
    """Plain PyTorch twin of the kernel: (segs, win_ring, features)."""
    if new_seg is not None:
        segs = {k: torch.cat([segs[k][1:], new_seg[k][None]], dim=0) for k in SEG_KEYS}
        win_ring = torch.cat([win_ring[..., win_new.shape[1]:], win_new.transpose(1, 2)], dim=-1)
    stats = res.fold_segment_stats(segs, seg_len, burst_isi_max)
    stats["win_counts"] = win_ring
    return segs, win_ring, res.features_from_stats(stats, tuple(keys))


def _check(segs, win_ring, keys, new_seg, win_new) -> None:
    if set(segs) != set(SEG_KEYS):
        raise ValueError(f"segment rings {sorted(segs)} are not {list(SEG_KEYS)}")
    ring = segs["counts"]
    if ring.dim() != 3 or ring.shape[0] < 1:
        raise ValueError(f"segment ring {tuple(ring.shape)} is not (n_ring >= 1, B, no)")
    for k in SEG_KEYS:
        t = segs[k]
        if t.dtype != torch.float32:
            raise TypeError(f"segment ring {k!r} must be float32, got {t.dtype}")
        if t.shape != ring.shape or t.device != ring.device:
            raise ValueError(f"segment ring {k!r} is {tuple(t.shape)} on {t.device}; "
                             f"'counts' is {tuple(ring.shape)} on {ring.device}")
    _, B, no = ring.shape
    if win_ring.dtype != torch.float32:
        raise TypeError(f"window ring must be float32, got {win_ring.dtype}")
    if (win_ring.dim() != 3 or tuple(win_ring.shape[:2]) != (B, no) or win_ring.shape[2] < 1
            or win_ring.device != ring.device):
        raise ValueError(f"window ring {tuple(win_ring.shape)} on {win_ring.device} is not "
                         f"({B}, {no}, n_win >= 1) on {ring.device}")
    if (new_seg is None) != (win_new is None):
        raise ValueError("a push takes both the hop's segment and its window counts")
    if new_seg is not None:
        if set(new_seg) != set(SEG_KEYS):
            raise ValueError(f"hop segment {sorted(new_seg)} is not {list(SEG_KEYS)}")
        for k in SEG_KEYS:
            t = new_seg[k]
            if t.dtype != torch.float32:
                raise TypeError(f"hop segment {k!r} must be float32, got {t.dtype}")
            if tuple(t.shape) != (B, no) or t.device != ring.device:
                raise ValueError(f"hop segment {k!r} is {tuple(t.shape)} on {t.device}, "
                                 f"not ({B}, {no}) on {ring.device}")
        if win_new.dtype != torch.float32:
            raise TypeError(f"hop window counts must be float32, got {win_new.dtype}")
        if (win_new.dim() != 3 or win_new.shape[0] != B or win_new.shape[2] != no
                or not 1 <= win_new.shape[1] <= win_ring.shape[2]
                or win_new.device != ring.device):
            raise ValueError(f"hop window counts {tuple(win_new.shape)} are not ({B}, "
                             f"1..{win_ring.shape[2]}, {no}) on {ring.device}")
    if not 0 < len(keys) <= MAX_KEYS:
        raise ValueError(f"the fold writes 1 to {MAX_KEYS} features, got {len(keys)}")
    unknown = [k for k in keys if k not in FEATURE_CODES]
    if unknown:
        raise ValueError(f"unknown feature keys {unknown}")


def fold(segs: Dict[str, torch.Tensor], win_ring: torch.Tensor, seg_len: int,
         burst_isi_max: int, keys: Sequence[str], new_seg: Optional[Dict[str, torch.Tensor]] = None,
         win_new: Optional[torch.Tensor] = None):
    """(segs, win_ring, features (B, len(keys) * no) float32) of the serving
    engine's rings: segs maps SEG_KEYS to (n_ring, B, no) float32 rings
    (ring[0] oldest, segment-relative times, seg_len steps a segment),
    win_ring is (B, no, n_win). With new_seg (SEG_KEYS -> (B, no)) and
    win_new (B, n_new, no) the rings are pushed first and the new rings
    returned; without, the rings come back as they are. The kernel on CUDA,
    the plain twin on CPU; the inputs are never written."""
    global launches, _fn
    _check(segs, win_ring, keys, new_seg, win_new)
    dev = win_ring.device
    if dev.type == "cpu":
        return fold_plain(segs, win_ring, seg_len, burst_isi_max, keys, new_seg, win_new)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_ring, B, no = segs["counts"].shape
    n_win = win_ring.shape[2]
    if n_win > MAX_WINDOWS:
        raise ValueError(f"the fold kernel takes up to {MAX_WINDOWS} rate windows, got {n_win}")
    seg_in = [segs[k].contiguous() for k in SEG_KEYS]
    win_in = win_ring.contiguous()
    feats = torch.empty(B, len(keys) * no, dtype=torch.float32, device=dev)
    push = new_seg is not None
    if push:
        fresh = [new_seg[k].contiguous() for k in SEG_KEYS]
        win_fresh = win_new.contiguous()
        outs = torch.empty(len(SEG_KEYS), n_ring, B, no, dtype=torch.float32,
                           device=dev).unbind(0)
        segs, win_ring = dict(zip(SEG_KEYS, outs)), torch.empty_like(win_in)
    if B * no == 0:
        return segs, win_ring, feats

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

    codes = (ctypes.c_int * len(keys))(*[FEATURE_CODES[k] for k in keys])
    # PyTorch's CUDA mean is sum * float(outputs) / numel, in float32.
    factor = float(np.float32(B * no) / np.float32(B * no * n_win))
    if _fn is None:
        _fn = _build.function("lsm_fold_window", [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
            ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = _fn(ptrs(seg_in), ptrs(fresh) if push else None, ptrs(outs) if push else None,
                  n_ring, B * no, no, int(seg_len), float(burst_isi_max), win_in.data_ptr(),
                  win_fresh.data_ptr() if push else None, win_ring.data_ptr() if push else None,
                  n_win, win_new.shape[1] if push else 0, factor, codes, len(keys),
                  feats.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lsm_fold_window")
    launches += 1
    return segs, win_ring, feats
