"""The hysteresis spike encoder's kernel (csrc/hysteresis.cu).

It replaces no TPU kernel: lsm_tpu/ops/hysteresis.py is jnp code. The
kernel is one bytes-bound pass that reads the (B, F, T) float32
spectrogram at any element strides (the batch path's contiguous tensor and
the serving engine's permuted view alike) and writes the interleaved uint8
spikes (B, F, T * n_thr) and, when asked, the new trigger state; see the
source for the design. The thresholds and OFF levels travel as launch
arguments, so a call copies nothing to the device.

The plain twin `encode_plain` is the port's first encoder, a loop over the
bins; CPU tensors take it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lsm_tpu_torch.ops import _build

MAX_THRESHOLDS = 32      # the kernel keeps a (row, filter)'s triggers in one 32-bit mask

launches = 0             # kernel launches (the plain twin does not count)
_fn = None               # the C entry point, bound at first use


def encode_plain(spec: torch.Tensor, state: torch.Tensor, on: np.ndarray, off: np.ndarray):
    """Plain PyTorch twin of the kernel: spec (..., F, T), state (...,
    n_thr, F) bool -> (spikes (..., F, T * n_thr) uint8, new state)."""
    n_thr = len(on)
    dev = spec.device
    thr_t = torch.tensor(on, device=dev).view(n_thr, 1, 1)
    lower_t = torch.tensor(off, device=dev).view(n_thr, 1, 1)

    x = spec.unsqueeze(-3)                                  # (..., 1, F, T)
    rising = x > thr_t                                      # (..., n_thr, F, T)
    holdable = x >= lower_t
    active = state
    out = torch.empty_like(rising)
    for t in range(spec.shape[-1]):
        active = rising[..., t] | (active & holdable[..., t])
        out[..., t] = active
    # (..., n_thr, F, T) -> (..., F, T, n_thr) -> interleaved columns.
    out = out.movedim(-3, -1)
    return out.reshape(out.shape[:-2] + (-1,)).to(torch.uint8), active


def _check(spec: torch.Tensor, state, n_thr: int) -> None:
    if spec.dtype != torch.float32:
        raise TypeError(f"the hysteresis encoder wants a float32 spectrogram, got {spec.dtype}")
    if spec.dim() != 3:
        raise ValueError(f"spectrogram {tuple(spec.shape)} is not (B, F, T)")
    if not 0 < n_thr <= MAX_THRESHOLDS:
        raise ValueError(f"the hysteresis encoder takes 1 to {MAX_THRESHOLDS} thresholds, "
                         f"got {n_thr}")
    if state is not None:
        if state.dtype != torch.bool:
            raise TypeError(f"trigger state must be bool, got {state.dtype}")
        B, F, _ = spec.shape
        if tuple(state.shape) != (B, n_thr, F):
            raise ValueError(f"trigger state {tuple(state.shape)} is not ({B}, {n_thr}, {F})")
        if state.device != spec.device:
            raise ValueError(f"trigger state on {state.device}, spectrogram on {spec.device}")


def encode(spec: torch.Tensor, state, on: np.ndarray, off: np.ndarray,
           want_state: bool = True):
    """(spikes (B, F, T * n_thr) uint8, new state (B, n_thr, F) bool or
    None) of spec (B, F, T) float32, from `state` (None: all off): the
    kernel on CUDA, the plain twin on CPU. on/off: the float32 thresholds,
    descending, and their OFF levels. The input state is never written."""
    global launches, _fn
    n_thr = len(on)
    _check(spec, state, n_thr)
    dev = spec.device
    if dev.type == "cpu":
        if state is None:
            state = torch.zeros(spec.shape[0], n_thr, spec.shape[1], dtype=torch.bool)
        out, new = encode_plain(spec, state, on, off)
        return out, (new if want_state else None)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, F, T = spec.shape
    out = torch.empty(B, F, T * n_thr, dtype=torch.uint8, device=dev)
    state_out = (torch.empty(B, n_thr, F, dtype=torch.bool, device=dev)
                 if want_state else None)
    if B * F == 0:
        return out, state_out
    if state is not None:
        state = state.contiguous()
    on_c = (ctypes.c_float * n_thr)(*np.asarray(on, np.float32).tolist())
    off_c = (ctypes.c_float * n_thr)(*np.asarray(off, np.float32).tolist())
    if _fn is None:
        _fn = _build.function("lsm_hysteresis_encode", [ctypes.c_void_p] + [
            ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [
            ctypes.c_int] + [ctypes.c_void_p] * 4)
    with torch.cuda.device(dev):
        err = _fn(spec.data_ptr(), *spec.stride(), B, F, T, on_c, off_c, n_thr,
                 None if state is None else state.data_ptr(),
                 None if state_out is None else state_out.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lsm_hysteresis_encode")
    launches += 1
    return out, state_out
