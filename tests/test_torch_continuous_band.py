"""The frozen accuracy band of the continuous path (tests/test_continuous_band.py)
through the port, on both frontends (floors 0.60 gammatone, 0.45 mel, as
lsm_tpu's): calibrate on continuous-mode features
(fit_continuous_readout, carried-state condition), serve the test split as
carry-in streams in 100 ms chunks, and compare with the port's exact batch
pipeline on the same hard corpus. Marked slow, as the reference's is; it
runs on the card where there is one, else on the CPU. This file imports
no jax and nothing of lsm_tpu, so it also runs where jax is not installed:

    python -m pytest --noconftest -q -m slow tests/test_torch_continuous_band.py
"""

import numpy as np
import pytest
import torch

from lsm_tpu_torch import pipeline
from lsm_tpu_torch.config import FrontendConfig, PipelineConfig
from lsm_tpu_torch.device import resolve_device
from lsm_tpu_torch.io import dataset
from lsm_tpu_torch.models.continuous import ContinuousKWS, fit_continuous_readout

CHUNK_LEN, NORM_DECAY, MAX_DELTA = 1600, 0.1, 0.15


@pytest.mark.slow
@pytest.mark.parametrize("filterbank,min_acc", [("gammatone", 0.60), ("mel", 0.45)])
def test_matched_continuous_readout_lands_in_band(filterbank, min_acc):
    dev = resolve_device("cuda" if torch.cuda.is_available() else "cpu")
    audio, labels = dataset.synthetic_audio_batch_hard(n_per_class=20, n_classes=12, seed=42)
    cfg = PipelineConfig(batch_size=64, frontend=FrontendConfig(filterbank=filterbank))
    result, ext = pipeline.run_pipeline_arrays(cfg, audio, labels, dev)
    x_train, x_test, y_train, y_test = pipeline.stratified_split(
        audio, labels, cfg.test_size, cfg.split_seed)
    ro, sc = fit_continuous_readout(
        ext.reservoir, cfg.frontend, x_train, y_train, num_classes=12,
        feature_set=cfg.feature_set, chunk_len=CHUNK_LEN, norm_decay_db_per_bin=NORM_DECAY,
        l2_c=cfg.readout.l2_c, max_iter=cfg.readout.max_iter, tol=cfg.readout.tol)
    n = x_test.shape[0]
    nc = cfg.frontend.num_samples // CHUNK_LEN
    kws = ContinuousKWS(ext.reservoir, ro, sc, cfg.frontend, cfg.feature_set, n_streams=n,
                        chunk_len=CHUNK_LEN, norm_decay_db_per_bin=NORM_DECAY)
    prev = x_test[np.random.default_rng(12345).permutation(n)]
    for c in range(nc):
        kws.step(prev[:, c * CHUNK_LEN:(c + 1) * CHUNK_LEN])
    for c in range(nc):
        logits = kws.step(x_test[:, c * CHUNK_LEN:(c + 1) * CHUNK_LEN])
    acc = float((np.argmax(logits, -1) == y_test).mean())
    print(f"{dev} {filterbank}: exact {result.accuracy:.4f} matched continuous {acc:.4f}")
    assert acc >= min_acc, (acc, result.accuracy)
    assert result.accuracy - acc <= MAX_DELTA, (acc, result.accuracy)
