"""Turn lsm_tpu parameters into the port's modules.

Each function takes the reference package's parameter object
(`ReservoirParams`, `SparseReservoirParams`, `ScalerState`,
`LogisticParams`, the continuous engine's `ContinuousState`, the exact
engine's ring buffer, the streaming trainer's `RidgeAccumState`, the
multi-device train step's `ReadoutState`) or anything with the same
attributes; every array
goes through `np.asarray`, so this module needs no jax. Tests use it to
make both packages compute with the same weights and from the same stream
state. Serving-state files (io/serving_state.py) carry stream state across
in both directions too.
"""

from __future__ import annotations

import numpy as np
import torch

from lsm_tpu_torch.models.continuous import ContinuousState
from lsm_tpu_torch.models.reservoir import Reservoir
from lsm_tpu_torch.models.sparse import SparseReservoir
from lsm_tpu_torch.parallel.train_step import ReadoutState
from lsm_tpu_torch.readout.logistic import LogisticReadout
from lsm_tpu_torch.readout.scaler import Scaler
from lsm_tpu_torch.readout.streaming_fit import RidgeAccumState


def _f32(a) -> np.ndarray:
    return np.array(a, dtype=np.float32)      # a writable copy the module owns


def reservoir(params, device: torch.device | str = "cpu") -> Reservoir:
    """lsm_tpu ReservoirParams (w_rec, w_in, leak + static fields)."""
    return Reservoir(
        _f32(params.w_rec), _f32(params.w_in), _f32(params.leak),
        n_neurons=params.n_neurons,
        n_outputs=params.n_outputs,
        n_channels=params.n_channels,
        threshold=params.threshold,
        refractory=params.refractory,
        burst_isi_max=params.burst_isi_max,
        n_rate_windows=params.n_rate_windows,
    ).to(device)


def sparse_reservoir(params, device: torch.device | str = "cpu") -> SparseReservoir:
    """lsm_tpu SparseReservoirParams (w_blocks, src_idx, w_in, leak + static
    fields, n_band included)."""
    return SparseReservoir(
        _f32(params.w_blocks), np.array(params.src_idx, dtype=np.int32),
        _f32(params.w_in), _f32(params.leak),
        n_neurons=params.n_neurons,
        n_outputs=params.n_outputs,
        n_channels=params.n_channels,
        threshold=params.threshold,
        refractory=params.refractory,
        burst_isi_max=params.burst_isi_max,
        n_rate_windows=params.n_rate_windows,
        n_band=params.n_band,
    ).to(device)


def scaler(state, device: torch.device | str = "cpu") -> Scaler:
    """lsm_tpu ScalerState (mean, scale)."""
    return Scaler(_f32(state.mean), _f32(state.scale)).to(device)


def readout(params, device: torch.device | str = "cpu") -> LogisticReadout:
    """lsm_tpu LogisticParams (w (D, K), b (K,))."""
    return LogisticReadout(_f32(params.w), _f32(params.b)).to(device)


def streaming_buffer(buffer, device: torch.device | str = "cpu") -> torch.Tensor:
    """lsm_tpu StreamingKWS.buffer, the exact engine's one state leaf
    ((n_streams, num_samples) f32 trailing window) -> the port's."""
    return torch.as_tensor(_f32(buffer)).to(device)


def continuous_state(state, device: torch.device | str = "cpu") -> ContinuousState:
    """lsm_tpu ContinuousState (gammatone or mel; dense or block-sparse reservoir)
    -> the port's, on `device`, with the same dtypes (f32, int32 refrac,
    bool triggers)."""
    def put(a):
        return torch.as_tensor(np.array(a)).to(device)

    return ContinuousState(
        iir=put(state.iir), tail=put(state.tail), hyst=put(state.hyst),
        norm_hi=put(state.norm_hi), norm_lo=put(state.norm_lo),
        v=put(state.v), refrac=put(state.refrac), s_prev=put(state.s_prev),
        segs={k: put(v) for k, v in state.segs.items()},
        win_ring=put(state.win_ring),
    )


def ridge_accum(state, device: torch.device | str = "cpu") -> RidgeAccumState:
    """lsm_tpu RidgeAccumState (shift, gram, xte, s1, s2, cnt, n) -> the
    port's, float32 on `device`."""
    return RidgeAccumState(*(torch.as_tensor(_f32(getattr(state, f))).to(device)
                             for f in RidgeAccumState._fields))


def readout_state(state, device: torch.device | str = "cpu") -> ReadoutState:
    """lsm_tpu's train-step ReadoutState (w (D, K), b (K,)) -> the port's."""
    return ReadoutState(torch.as_tensor(_f32(state.w)).to(device),
                        torch.as_tensor(_f32(state.b)).to(device))


def readout_state_arrays(state: ReadoutState) -> tuple:
    """The port's ReadoutState -> (w, b) float32 NumPy arrays, the fields of
    lsm_tpu's ReadoutState (which wraps them in jax arrays)."""
    return _f32(state.w.detach().cpu()), _f32(state.b.detach().cpu())
