"""BASELINE.json configs[2] through the port on the CPU: the 35-class
vocabulary (`--vocab v35`) with a 256-filter exact gammatone frontend and
the flagship reservoir (1000 neurons, 400 outputs, k = 200), against
lsm_tpu.

- featurize_batch at 256 filters: spikes equal to lsm_tpu's but for at
  most 1e-3 of them, every flip traced to a value within 1e-4 of a
  hysteresis level (tests/test_torch_ops.py's rule at 128 filters);
- lsm_tpu's reservoir drawn at C = 256, carried across: statistics bit-equal
  on the dyadic copy (every sum exact in float32); on the calibrated
  weights the spike totals within 1e-3 relative (bf16 operands summed in
  another order may flip a spike) and the statistics of every row without
  a flip bit-equal;
- the whole pipeline at 35 classes x 2 utterances and 256 neurons in both
  packages: label path, feature width and a 35-row report (names and
  supports) equal to lsm_tpu's;
- lsm_tpu's tests/test_config35.py on the port alone (35 x 10, 512
  neurons): accuracy > 0.25, all 35 rows, support 20 % of the corpus. It
  takes ~22 s on one CPU thread, so it is marked slow as lsm_tpu's is."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lsm_tpu import config as jcfg
from lsm_tpu import pipeline as jpipe
from lsm_tpu.models import frontend as jfront
from lsm_tpu.models import reservoir as jres
from lsm_tpu.ops import db as jdb
from lsm_tpu.ops import resample as jresample

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.io import dataset
from lsm_tpu_torch.models import frontend as tfront
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.models.calibration import calibrate_weight

torch.set_num_threads(1)

CPU = torch.device("cpu")
STAT_KEYS = ("counts", "sum_t", "sum_t2", "first", "last", "n_isi", "sum_isi", "sum_isi2",
             "bursts", "all_counts")


@pytest.fixture(scope="module")
def spikes256():
    """Six utterances of configs[2]'s synthetic corpus (seed 77) through
    both packages' featurize_batch at 256 filters."""
    audio, _ = dataset.synthetic_audio_batch(n_per_class=1, n_classes=35, seed=77)
    audio = audio[::6]
    cfg = jcfg.FrontendConfig(n_filters=256)
    ref = np.asarray(jfront.featurize_batch(jnp.asarray(audio), cfg))
    out = tfront.featurize_batch(torch.as_tensor(audio), tcfg.FrontendConfig(n_filters=256))
    return audio, cfg, out.numpy(), ref


def test_featurize_at_256_filters_matches_reference(spikes256):
    audio, cfg, out, ref = spikes256
    assert out.dtype == np.uint8 and out.shape == ref.shape == (6, 256, 400)
    flips = out != ref
    print(f"spike mismatch fraction {flips.mean():.2e}")
    assert flips.mean() <= 1e-3
    if flips.any():
        spec = np.asarray(jresample.zoom_time_axis(jdb.minmax_normalize(
            jfront.spectrogram_db(jnp.asarray(audio), cfg)), cfg.time_bins))
        levels = np.concatenate([np.asarray(cfg.spike_thresholds, np.float32),
                                 np.asarray(cfg.spike_thresholds, np.float32)
                                 - np.float32(cfg.hysteresis_gap)])
        near = (np.abs(spec[..., None] - levels) <= 1e-4).any(-1)
        for b, f, col in zip(*np.nonzero(flips)):
            assert near[b, f, : col // cfg.n_thresholds + 1].any(), (b, f, col)


def _stats(stats):
    return {k: np.asarray(stats[k]) for k in STAT_KEYS}


def test_reservoir_at_256_channels_against_reference(spikes256):
    _, _, spikes, _ = spikes256
    rcfg = jcfg.ReservoirConfig()
    _, mw = calibrate_weight(tcfg.ReservoirConfig(), spikes, 0.6)
    params = jres.init_reservoir(rcfg, n_channels=256, mean_weight=mw)
    assert params.w_in.shape == (256, 1024)
    x = torch.as_tensor(spikes)

    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0  # noqa: E731
    dy = dataclasses.replace(params, w_rec=q(params.w_rec), w_in=q(params.w_in),
                             leak=jnp.zeros_like(params.leak))
    ref = _stats(jres.simulate_batch(dy, jnp.asarray(spikes), matmul_dtype=jnp.bfloat16))
    got = tres.simulate_batch(convert.reservoir(dy), x)
    assert ref["all_counts"].sum() > 0
    for k in STAT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)

    ref = _stats(jres.simulate_batch(params, jnp.asarray(spikes), matmul_dtype=jnp.bfloat16))
    r = convert.reservoir(params)
    got = tres.simulate_batch(r, x)
    total, ref_total = float(got["all_counts"].sum()), float(ref["all_counts"].sum())
    assert abs(total - ref_total) <= 1e-3 * ref_total
    same = (got["all_counts"].numpy() == ref["all_counts"]).all(axis=1)
    assert same.any()
    for k in STAT_KEYS:
        np.testing.assert_array_equal(got[k].numpy()[same], ref[k][same], err_msg=k)


def _config35(mod, **reservoir):
    return mod.PipelineConfig(
        frontend=mod.FrontendConfig(n_filters=256, filterbank="gammatone",
                                    gammatone_method="iir"),
        reservoir=mod.ReservoirConfig(**reservoir), feature_set="original",
        commands=mod.COMMANDS_35, batch_size=64)


def test_pipeline_at_35_classes_against_reference():
    """35 classes x 2 utterances, half of them test (one a class: the
    default 0.2 cannot stratify 70 rows over 35 classes), 256 neurons."""
    res = dict(num_neurons=256, num_output_neurons=128, small_world_k=51, input_fanout=6)
    audio, labels = dataset.synthetic_audio_batch(n_per_class=2, n_classes=35, seed=77)
    port, ext = tpipe.run_pipeline_arrays(
        dataclasses.replace(_config35(tcfg, **res), test_size=0.5), audio, labels, CPU)
    ref, jext = jpipe.run_pipeline_arrays(
        dataclasses.replace(_config35(jcfg, **res), test_size=0.5), audio, labels, mesh=None)
    assert tcfg.COMMANDS_35 == jcfg.COMMANDS_35 and len(tcfg.COMMANDS_35) == 35
    np.testing.assert_array_equal(ext.artifact.y_train, jext.artifact.y_train)
    np.testing.assert_array_equal(ext.artifact.y_test, jext.artifact.y_test)
    assert ext.artifact.x_train.shape == jext.artifact.x_train.shape == (35, 5 * 128)
    assert ext.reservoir.w_in.shape[0] == 256
    assert list(port.report.class_names) == list(ref.report.class_names) == \
        list(tcfg.COMMANDS_35)
    np.testing.assert_array_equal(port.report.support, ref.report.support)
    assert (port.report.support == 1).all()
    rows = port.report.render().splitlines()
    for name in tcfg.COMMANDS_35:
        assert any(line.split()[:1] == [name] for line in rows), name
    np.testing.assert_allclose(ext.w_critico, jext.w_critico, rtol=1e-4)


@pytest.mark.slow
def test_35class_256filter_end_to_end():
    """lsm_tpu's tests/test_config35.py through the port."""
    cfg = dataclasses.replace(
        _config35(tcfg, num_neurons=512, num_output_neurons=256, small_world_k=102,
                  input_fanout=6), test_size=0.2)
    audio, labels = dataset.synthetic_audio_batch(n_per_class=10, n_classes=35, seed=77)
    result, ext = tpipe.run_pipeline_arrays(cfg, audio, labels, CPU)
    assert ext.artifact.x_train.shape[1] == 5 * 256
    assert ext.reservoir.w_in.shape[0] == 256
    assert result.accuracy > 0.25, f"accuracy too low: {result.accuracy}"
    rendered = result.report.render()
    for name in tcfg.COMMANDS_35:
        assert name in rendered
    assert len(result.report.class_names) == 35
    assert result.report.support.sum() == len(labels) * cfg.test_size
