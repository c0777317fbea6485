"""The trained-model bundle: everything standalone inference needs, in one
.npz (port of lsm_tpu/io/model.py, the same members, dtypes, shapes, JSON
`meta` and format tags, so either package loads the other's bundles).

Members: `meta` (JSON), `w_in`, `leak`, `readout_w`, `readout_b`,
`scaler_mean`, `scaler_scale`, and `w_rec` (dense: lsm_tpu.model.v1) or
`w_blocks` + `src_idx` (block-sparse: lsm_tpu.model.v2-sparse). The dense
arrays are the reservoir's padded buffers (N and C rounded up to 128),
float32; the kernels' bf16 copies are not part of the bundle.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from lsm_tpu_torch.config import FrontendConfig, frontend_from_dict
from lsm_tpu_torch.models.reservoir import Reservoir
from lsm_tpu_torch.models.sparse import SparseReservoir
from lsm_tpu_torch.readout.logistic import LogisticReadout
from lsm_tpu_torch.readout.scaler import Scaler

MODEL_FILENAME = "lsm_model.npz"
# Sparse bundles carry their own tag, so a loader that knows only dense
# bundles refuses them by name.
_FORMAT_DENSE = "lsm_tpu.model.v1"
_FORMAT_SPARSE = "lsm_tpu.model.v2-sparse"
_KNOWN_FORMATS = (_FORMAT_DENSE, _FORMAT_SPARSE)


class ModelBundle(NamedTuple):
    reservoir: Union[Reservoir, SparseReservoir]
    readout: LogisticReadout
    scaler: Scaler
    frontend: FrontendConfig
    feature_set: str
    class_names: tuple
    # The feature distribution the readout and scaler were fitted on:
    # "batch" (the pipeline's windowed features) or "continuous" (the
    # carried-state engine's, models/continuous.fit_continuous_readout).
    feature_mode: str = "batch"
    # For "continuous": the knobs that shaped that distribution (chunk_len,
    # norm_decay_db_per_bin), which serving must reuse; None for "batch".
    continuous_params: "dict | None" = None


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_model(
    path: Path,
    reservoir: Union[Reservoir, SparseReservoir],
    readout: LogisticReadout,
    scaler: Scaler,
    frontend: FrontendConfig,
    feature_set: str,
    class_names: Sequence[str],
    feature_mode: str = "batch",
    continuous_params: dict | None = None,
) -> None:
    is_sparse = isinstance(reservoir, SparseReservoir)
    static = {
        "n_neurons": reservoir.n_neurons,
        "n_outputs": reservoir.n_outputs,
        "n_channels": reservoir.n_channels,
        "threshold": reservoir.threshold,
        "refractory": reservoir.refractory,
        "burst_isi_max": reservoir.burst_isi_max,
        "n_rate_windows": reservoir.n_rate_windows,
        "kind": "sparse" if is_sparse else "dense",
    }
    if is_sparse:
        static["n_band"] = reservoir.n_band
        weights = dict(w_blocks=_np(reservoir.w_blocks), src_idx=_np(reservoir.src_idx))
    else:
        weights = dict(w_rec=_np(reservoir.w_rec))
    if feature_mode not in ("batch", "continuous"):
        raise ValueError(f"unknown feature_mode: {feature_mode!r}")
    if feature_mode == "continuous" and not continuous_params:
        raise ValueError(
            "continuous bundles must record the calibration's "
            "distribution-shaping knobs (chunk_len, norm_decay_db_per_bin)"
        )
    meta = {
        "format": _FORMAT_SPARSE if is_sparse else _FORMAT_DENSE,
        "feature_mode": feature_mode,
        "continuous_params": dict(continuous_params or {}),
        "feature_set": feature_set,
        "class_names": list(class_names),
        "frontend": dataclasses.asdict(frontend),
        "reservoir_static": static,
    }
    np.savez_compressed(
        path,
        meta=json.dumps(meta),
        w_in=_np(reservoir.w_in),
        leak=_np(reservoir.leak),
        readout_w=_np(readout.w),
        readout_b=_np(readout.b),
        scaler_mean=_np(scaler.mean),
        scaler_scale=_np(scaler.scale),
        **weights,
    )


def load_model(path: Path, device: torch.device | str) -> ModelBundle:
    """Read a bundle written by either package and build its modules on
    `device`. Never unpickles; refuses an unknown format by name."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Model file not found: '{path}'")
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta.get("format") not in _KNOWN_FORMATS:
        raise ValueError(
            f"unknown model format {meta.get('format')!r} in '{path}' "
            f"(this build reads: {', '.join(_KNOWN_FORMATS)})"
        )
    rs = meta["reservoir_static"]
    static = dict(
        n_neurons=int(rs["n_neurons"]),
        n_outputs=int(rs["n_outputs"]),
        n_channels=int(rs["n_channels"]),
        threshold=float(rs["threshold"]),
        refractory=int(rs["refractory"]),
        burst_isi_max=int(rs["burst_isi_max"]),
        n_rate_windows=int(rs["n_rate_windows"]),
    )
    if rs.get("kind", "dense") == "sparse":
        reservoir = SparseReservoir(data["w_blocks"], data["src_idx"], data["w_in"],
                                    data["leak"], n_band=int(rs["n_band"]), **static)
    else:
        reservoir = Reservoir(data["w_rec"], data["w_in"], data["leak"], **static)
    return ModelBundle(
        reservoir=reservoir.to(device),
        readout=LogisticReadout(data["readout_w"], data["readout_b"]).to(device),
        scaler=Scaler(data["scaler_mean"], data["scaler_scale"]).to(device),
        frontend=frontend_from_dict(meta["frontend"]),
        feature_set=meta["feature_set"],
        class_names=tuple(meta["class_names"]),
        feature_mode=meta.get("feature_mode", "batch"),
        continuous_params=meta.get("continuous_params") or None,
    )
