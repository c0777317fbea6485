"""The frozen sparse-parity oracle (tests/test_sparse_reservoir.py:292-329)
through the port: on the hard corpus (30 x 12, seed 42) at N = 1024,
k = 204, the block-sparse reservoir and the dense one both land EDGE OF
CHAOS with accuracy in [0.66, 0.95], within 0.15 of each other. The port
draws the sparse weights itself (a torch Generator, not jax.random), so
this is the statistical contract the reference's test holds, not a
bit-level one. Marked slow, as the reference's is; it runs on the card
where there is one, else on the CPU. This file imports no jax and nothing
of lsm_tpu:

    python -m pytest --noconftest -q -m slow tests/test_torch_sparse_band.py
"""

import dataclasses

import pytest
import torch

from lsm_tpu_torch import pipeline
from lsm_tpu_torch.config import PipelineConfig, ReservoirConfig
from lsm_tpu_torch.device import resolve_device
from lsm_tpu_torch.io import artifacts, dataset
from lsm_tpu_torch.models.sparse import SparseReservoir

ACC_RANGE, MAX_DELTA = (0.66, 0.95), 0.15


def sparse_parity(dev: torch.device) -> dict:
    """Dense and block-sparse runs of the oracle on one featurization:
    {sparse flag: (regime, accuracy, participation)}."""
    audio, labels = dataset.synthetic_audio_batch_hard(n_per_class=30, n_classes=12, seed=42)
    base = ReservoirConfig(num_neurons=1024, num_output_neurons=400, small_world_k=204)
    spikes = pipeline.featurize_audio_array(PipelineConfig(reservoir=base, batch_size=64),
                                            audio, dev)
    ds = artifacts.SpikeDataset(x_spikes=spikes, y_labels=labels)
    out = {}
    for flag in (False, True):
        cfg = PipelineConfig(reservoir=dataclasses.replace(base, sparse=flag), batch_size=64)
        ext = pipeline.extract_lsm_features(cfg, ds, dev)
        assert isinstance(ext.reservoir, SparseReservoir) == flag
        result = pipeline.train_and_evaluate(cfg, ext.artifact, dev)
        out[flag] = (ext.diagnostics.regime, result.accuracy,
                     ext.diagnostics.avg_participation)
    return out


@pytest.mark.slow
def test_sparse_accuracy_parity_with_dense_on_hard_benchmark():
    dev = resolve_device("cuda" if torch.cuda.is_available() else "cpu")
    out = sparse_parity(dev)
    print(f"{dev}: dense {out[False]} sparse {out[True]}")
    for flag, (regime, acc, _) in out.items():
        assert regime == "EDGE OF CHAOS", (flag, regime)
        assert ACC_RANGE[0] <= acc <= ACC_RANGE[1], (flag, acc)
    assert abs(out[True][1] - out[False][1]) <= MAX_DELTA, out
