"""The port's whole slice against the JAX reference on the CPU: the frozen
accuracy oracle (tests/test_accuracy_band.py) run through both packages,
the split, and the `python -m lsm_tpu_torch` entry point."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lsm_tpu import pipeline as jpipe
from lsm_tpu.config import PipelineConfig
from lsm_tpu.io import artifacts, dataset

from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.device import resolve_device

# Under pytest-xdist several workers share a few cores; torch's intra-op
# thread pools would contend (the tiny ops here run ~10x slower so).
torch.set_num_threads(1)

ACC_BAND = (0.76, 0.90)          # tests/test_accuracy_band.py, frozen
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def corpus():
    return dataset.synthetic_audio_batch_hard(n_per_class=30, n_classes=12, seed=42)


@pytest.fixture(scope="module")
def jax_run(corpus):
    """The reference's flagship run on the hard corpus, once per module."""
    audio, labels = corpus
    return jpipe.run_pipeline_arrays(PipelineConfig(batch_size=64), audio, labels, mesh=None)


def test_slice_lands_in_band_beside_reference(corpus, jax_run):
    audio, labels = corpus
    res, ext = tpipe.run_pipeline_arrays(
        PipelineConfig(batch_size=64), audio, labels, torch.device("cpu")
    )
    jres, jext = jax_run
    print(f"accuracy port {res.accuracy:.4f} jax {jres.accuracy:.4f}; "
          f"participation port {ext.diagnostics.avg_participation:.2f} "
          f"jax {jext.diagnostics.avg_participation:.2f}")
    assert ext.diagnostics.regime == "EDGE OF CHAOS", ext.diagnostics.regime
    assert ACC_BAND[0] <= res.accuracy <= ACC_BAND[1], res.accuracy
    assert abs(res.accuracy - jres.accuracy) <= 0.05
    np.testing.assert_allclose(ext.w_critico, jext.w_critico, rtol=1e-4)
    assert ext.artifact.x_train.shape == jext.artifact.x_train.shape == (288, 2000)
    np.testing.assert_array_equal(ext.artifact.y_test, jext.artifact.y_test)


@pytest.mark.parametrize("n_per,k,test_size,seed", [
    (30, 12, 0.2, 42), (5, 12, 0.2, 42), (9, 7, 0.3, 1), (17, 3, 0.25, 5),
])
def test_stratified_split_equals_reference(n_per, k, test_size, seed):
    """Equal to lsm_tpu's split, which calls scikit-learn where installed;
    the port re-derives sklearn's split so it holds without sklearn too."""
    y = np.repeat(np.arange(k), n_per).astype(np.int32)
    y = y[np.random.default_rng(seed).permutation(len(y))]
    x = np.arange(len(y)) * 3
    for a, b in zip(tpipe.stratified_split(x, y, test_size, seed),
                    jpipe.stratified_split(x, y, test_size, seed)):
        np.testing.assert_array_equal(a, b)


def test_stratified_split_rejects_what_it_cannot_stratify():
    y = np.repeat(np.arange(12), 4)
    with pytest.raises(ValueError):
        tpipe.stratified_split(np.arange(48), y, 0.2, 42)        # 10 test < 12 classes


def test_device_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_cli_runs_without_jax(tmp_path):
    """`python -m lsm_tpu_torch` end to end on the CPU at a small width: it
    imports neither jax nor anything of lsm_tpu, and both artifacts load
    with lsm_tpu's readers."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['lsm_tpu_torch', '--synthetic', '--samples-per-class', '5',"
        " '--n-filters', '32', '--device', 'cpu']\n"
        "runpy.run_module('lsm_tpu_torch', run_name='__main__')\n"
        "ref = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lsm_tpu')]\n"
        "assert not ref, ref\n"
        "print('JAX_FREE')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout
    for section in ("--- Step 1: Creating Spike Train Dataset ---",
                    "--- Step 2: Extracting LSM Features ---",
                    "--- Step 3: Training and Evaluating Classifier ---",
                    "STATUS:", "Test Accuracy:", "--- Pipeline Finished ---", "JAX_FREE"):
        assert section in out, section
    ds = artifacts.load_spike_dataset(tmp_path / artifacts.SPIKE_DATASET_FILENAME)
    assert ds.x_spikes.shape == (60, 32, 400) and ds.x_spikes.dtype == np.uint8
    feats = artifacts.load_features(tmp_path / artifacts.FEATURES_FILENAME)
    assert feats.x_train.shape == (48, 2000) and feats.feature_set == "original"
