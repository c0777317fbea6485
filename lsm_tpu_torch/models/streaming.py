"""Ingest helpers shared by the streaming engines (the part of
lsm_tpu/models/streaming.py the continuous engine uses).

The exact-mode engine `StreamingKWS` is not ported yet (ROADMAP A9); this
module holds the ingest policy, the on-device PCM decode and the hot
readout swap that `ContinuousKWS` shares with it.
"""

from __future__ import annotations

import numpy as np
import torch

from lsm_tpu_torch.ops.ulaw import decode_ulaw


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


def decode_pcm_device(chunk: torch.Tensor) -> torch.Tensor:
    """On-device ingest decode: f32 passes through, int16 is linear PCM
    (the decoders' exact /32768), uint8 is G.711 mu-law (ops/ulaw.py)."""
    if chunk.dtype == torch.int16:
        return chunk.to(torch.float32) / 32768.0
    if chunk.dtype == torch.uint8:
        return decode_ulaw(chunk)
    return chunk


def swap_readout_on(kws, readout, scaler_state=None) -> None:
    """Hot readout cutover on a live engine: install a new readout (and
    optionally new scaler moments) without touching stream state. Shapes
    and dtypes must match the live readout: a different feature set or
    class count needs a new engine. The new modules are moved to the
    engine's device."""
    pairs = [("w", readout.w, kws.readout.w), ("b", readout.b, kws.readout.b)]
    if scaler_state is not None:
        pairs += [("mean", scaler_state.mean, kws.scaler_state.mean),
                  ("scale", scaler_state.scale, kws.scaler_state.scale)]
    for name, new, cur in pairs:
        if tuple(new.shape) != tuple(cur.shape) or new.dtype != cur.dtype:
            raise ValueError(
                f"swap_readout {name}: {new.dtype}{tuple(new.shape)} does "
                f"not match the live engine's {cur.dtype}{tuple(cur.shape)} "
                "— a different feature set or class count needs a new engine"
            )
    kws.readout = readout.to(kws.device)
    if scaler_state is not None:
        kws.scaler_state = scaler_state.to(kws.device)
