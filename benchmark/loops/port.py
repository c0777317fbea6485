"""The system under test: lsm_tpu_torch's public entry points, built over
the benchmark's own weights (benchmark/lib/model.py). The only module of
the harness that imports the program.

`Batch.step` is the batch user's path (featurize_batch -> extract_features
-> scaler.transform -> logistic.predict); `Serve` wraps ContinuousKWS,
whose `step` takes a host int16 chunk and returns the logits on the host.
`Batch.step` takes optional CUDA events, recorded between the layers; with
`trace`, each call into the program is a named span of the trace.
"""

from __future__ import annotations

import torch

from benchmark.lib.trace import span
from lsm_tpu_torch.config import FrontendConfig
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models.continuous import ContinuousKWS
from lsm_tpu_torch.models.frontend import featurize_batch
from lsm_tpu_torch.models.sparse import SparseReservoir
from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.readout import logistic, scaler


def build_kernels() -> None:
    """Builds (first run in a checkout) or loads the port's kernels."""
    _build.library()


def frontend_config(config: dict) -> FrontendConfig:
    f = dict(config["frontend"])
    f["spike_thresholds"] = tuple(f["spike_thresholds"])
    return FrontendConfig(**f)


def reservoir(config: dict, w: dict):
    r, f = config["reservoir"], config["frontend"]
    kw = dict(n_neurons=r["num_neurons"], n_outputs=r["num_output_neurons"],
              n_channels=f["n_filters"] * f["redundancy_factor"],
              threshold=r["membrane_threshold"], refractory=r["refractory_period"],
              burst_isi_max=r["burst_isi_max"], n_rate_windows=r["n_rate_windows"])
    if r["layout"] == "block_sparse":
        n_band = (127 + r["small_world_k"] // 2) // 128 + 1
        return SparseReservoir(w["w_blocks"], w["src_idx"], w["w_in"], w["leak"],
                               n_band=n_band, **kw)
    return res.Reservoir(w["w_rec"], w["w_in"], w["leak"], **kw)


def readout(w: dict):
    return (logistic.LogisticReadout(w["readout_w"], w["readout_b"]),
            scaler.Scaler(w["scaler_mean"], w["scaler_scale"]))


class Batch:
    def __init__(self, config: dict, w: dict, trace: bool = False):
        self.trace = trace
        self.fcfg = frontend_config(config)
        self.reservoir = reservoir(config, w)
        self.ro, self.sc = readout(w)
        self.keys = tuple(config["feature_keys"])

    def step(self, audio: torch.Tensor, events=None) -> dict:
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        with span("featurize_batch", self.trace):
            sp = featurize_batch(audio, self.fcfg)
        mark(1)
        with span("extract_features", self.trace):
            f = res.extract_features(self.reservoir, sp, self.keys)
        mark(2)
        with span("scaler.transform + logistic.predict", self.trace):
            preds = logistic.predict(self.ro, scaler.transform(self.sc, f))
        mark(3)
        return {"spikes": sp, "features": f, "preds": preds}


class Serve:
    def __init__(self, config: dict, w: dict, streams: int, chunk_len: int, decay: float,
                 trace: bool = False):
        self.trace = trace
        ro, sc = readout(w)
        self.kws = ContinuousKWS(reservoir(config, w), ro, sc, frontend_config(config),
                                 config["feature_set"], n_streams=streams,
                                 chunk_len=chunk_len, norm_decay_db_per_bin=decay)

    def step(self, chunk):
        with span("ContinuousKWS.step", self.trace):
            return self.kws.step(chunk)

    def state(self) -> dict:
        st = self.kws.state
        return dict(iir=st.iir, tail=st.tail, hyst=st.hyst, norm_hi=st.norm_hi,
                    norm_lo=st.norm_lo, v=st.v, refrac=st.refrac, s_prev=st.s_prev,
                    segs=dict(st.segs), win_ring=st.win_ring)

    def reset(self) -> None:
        self.kws.reset()
