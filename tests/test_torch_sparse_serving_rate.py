"""ROADMAP C3 on the CPU (marked slow, ~20 s): does lsm_tpu's own sparse
continuous engine also ignite in serving, as the port's does at
BASELINE.json configs[3] width?

lsm_tpu draws the 10240-neuron block-sparse reservoir (k = 2048) at
multiplier 1.6 of w_critico, calibrated on the hard corpus (30 x 12, seed
42); `convert.sparse_reservoir` carries it across. Both engines serve the
same streams of chip_smoke.py phase 7's corpus (synthetic_audio_batch_hard
(86, 12, seed=9), int16 wire) for 12 hops with every neuron counted as an
output, so the segment ring's last counts are every spike of the hop. The
spikes a stream-step must be equal (the continuous chain is held bit-equal
at small widths by tests/test_torch_sparse_continuous.py); the batch mode
of the same reservoir (membrane from rest each window) is printed beside
them.

    python -m pytest -q -s -m slow tests/test_torch_sparse_serving_rate.py
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsm_tpu.config import FrontendConfig, PipelineConfig, ReservoirConfig
from lsm_tpu.io import dataset
from lsm_tpu.models import sparse as jsp
from lsm_tpu.models.calibration import calibrate_weight
from lsm_tpu.models.continuous import ContinuousKWS as JaxKWS
from lsm_tpu.models.frontend import featurize_batch
from lsm_tpu.readout import logistic as jlog
from lsm_tpu.readout import scaler as jsc

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch.models.continuous import ContinuousKWS
from lsm_tpu_torch.readout.logistic import LogisticReadout
from lsm_tpu_torch.readout.scaler import Scaler

N, K, MULT, STREAMS, HOPS, L = 10240, 2048, 1.6, 8, 12, 1600


@pytest.mark.slow
def test_sparse_engines_fire_alike_in_serving():
    fcfg = PipelineConfig().frontend
    audio, _ = dataset.synthetic_audio_batch_hard(30, 12, seed=42)
    spikes = jnp.concatenate([featurize_batch(jnp.asarray(audio[i:i + 60]), fcfg)
                              for i in range(0, len(audio), 60)])
    rc = ReservoirConfig(num_neurons=N, small_world_k=K, sparse=True)
    _, mw = calibrate_weight(rc, spikes, MULT)
    params = jsp.init_reservoir_sparse(dataclasses.replace(rc, mean_weight=mw), n_channels=128)
    params = dataclasses.replace(params, n_outputs=N)          # count every neuron
    d = 5 * N
    j = JaxKWS(params, jlog.LogisticParams(w=jnp.zeros((d, 12)), b=jnp.zeros(12)),
               jsc.ScalerState(mean=jnp.zeros(d), scale=jnp.ones(d)), FrontendConfig(),
               "original", STREAMS)
    t = ContinuousKWS(convert.sparse_reservoir(params),
                      LogisticReadout(torch.zeros(d, 12), torch.zeros(12)),
                      Scaler(torch.zeros(d), torch.ones(d)), tcfg.FrontendConfig(),
                      "original", STREAMS)
    serve, _ = dataset.synthetic_audio_batch_hard(86, 12, seed=9)
    wire = np.clip(serve[:STREAMS] * 32768.0, -32768.0, 32767.0).astype(np.int16)
    rates = []
    for h in range(HOPS):
        ch = np.ascontiguousarray(wire[:, (h % 10) * L:(h % 10 + 1) * L])
        j.step(ch)
        t.step(ch)
        rates.append((float(np.asarray(j.state.segs["counts"][-1]).sum()) / (STREAMS * 40),
                      float(t.state.segs["counts"][-1].sum()) / (STREAMS * 40)))
    counts = np.asarray(jsp.simulate_batch_sparse(
        params, featurize_batch(jnp.asarray(serve[:STREAMS]), fcfg))["all_counts"])
    rj, rt = np.mean(rates, axis=0)
    print(f"\nN={N} k={K} multiplier {MULT} (mean weight {mw:.6g}), {STREAMS} streams x {HOPS} "
          f"hops: spikes a stream-step lsm_tpu {rj:.2f}, port {rt:.2f}; per hop "
          f"{[round(r[0], 2) for r in rates]}; batch mode on the same utterances "
          f"{counts.sum() / (STREAMS * 400):.2f} spikes a row-step")
    assert rates == [(r[0], r[0]) for r in rates]
    assert rj > 20 * counts.sum() / (STREAMS * 400)     # serving ignites, batch does not
