"""The port's --check sanitizer (utils/checks.py and its pipeline wiring),
metric logger (utils/logging.py), profiling helpers (utils/profiling.py),
regime sweep (models/sweep.py) and operator tools (lsm_tpu_torch.tools)
against lsm_tpu on the CPU.

Check mode: tests/test_check_mode.py's single-device cases through the
port, with lsm_tpu's messages. The sweep: on the same spikes and grid the
host draw is bit-equal below 4096 neurons, and both packages simulate with
bf16 weight operands and f32 state, so participation and regime are held
equal at every point (spikes a neuron at rtol 1e-6: a float32 mean in
another order). The tools run at a tiny size with --device cpu."""

import io
import json

import numpy as np
import pytest
import torch

from lsm_tpu import config as jcfg
from lsm_tpu import pipeline as jpipe
from lsm_tpu.models.sweep import sweep_regime as j_sweep
from lsm_tpu.utils.checks import validate_features_host
from lsm_tpu.utils.logging import MetricLogger as JMetricLogger

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.io import artifacts
from lsm_tpu_torch.models.sweep import sweep_regime
from lsm_tpu_torch.utils import checks, profiling
from lsm_tpu_torch.utils.logging import MetricLogger, default_metrics

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _tiny_cfg(check=True):
    """tests/test_check_mode.py's config."""
    return tcfg.PipelineConfig(
        frontend=tcfg.FrontendConfig(n_filters=16, filterbank="mel"),
        reservoir=tcfg.ReservoirConfig(num_neurons=128, num_output_neurons=64,
                                       small_world_k=16),
        commands=("a", "b"), batch_size=8, check=check,
    )


def _audio():
    return np.random.default_rng(0).standard_normal((8, 16000)).astype(np.float32) * 0.2


# ---- --check ------------------------------------------------------------------

def test_check_rejects_nan_audio():
    audio = _audio()
    audio[3, 1000] = np.nan
    with pytest.raises(RuntimeError,
                       match=r"--check failed in featurize_audio_array: 1 non-finite \(NaN"):
        tpipe.featurize_audio_array(_tiny_cfg(), audio, CPU)
    # The unchecked path encodes it silently: the failure --check exists for.
    spikes = tpipe.featurize_audio_array(_tiny_cfg(check=False), audio, CPU)
    assert spikes.shape[0] == 8


def test_check_accepts_clean_audio():
    audio = _audio()
    checked = tpipe.featurize_audio_array(_tiny_cfg(), audio, CPU)
    assert set(np.unique(checked)) <= {0, 1}
    np.testing.assert_array_equal(checked,
                                  tpipe.featurize_audio_array(_tiny_cfg(False), audio, CPU))


def test_check_catches_a_featurizer_emitting_2_before_the_pack(monkeypatch):
    """A spike of 2 is caught on the featurizer's raw output, with
    lsm_tpu's message; the bit-pack on the way to the reservoir would
    alias it into a 1 (np.packbits packs any nonzero as a set bit)."""
    real = tpipe.featurize_batch

    def emits_2(audio, fcfg, check=None):
        s = real(audio, fcfg, check=check).clone()
        s[0, 0, 0] = 2
        return s

    monkeypatch.setattr(tpipe, "featurize_batch", emits_2)
    with pytest.raises(RuntimeError) as port:
        tpipe.featurize_audio_array(_tiny_cfg(), _audio(), CPU)
    with pytest.raises(RuntimeError) as ref:
        jpipe._check_spikes_host(np.array([0, 1, 2], np.uint8), "featurize_audio_array")
    assert str(port.value) == str(ref.value) == \
        "--check failed in featurize_audio_array: 1 spike values outside {0, 1}"
    spikes = tpipe.featurize_audio_array(_tiny_cfg(False), _audio(), CPU)
    assert spikes.max() == 2
    assert tpipe.spikes_to_device(spikes, CPU).max() == 1


def _dataset(spikes):
    return artifacts.SpikeDataset(x_spikes=spikes,
                                  y_labels=np.tile(np.arange(2, dtype=np.int32), 20))


def test_check_flags_dead_reservoir():
    """All-zero spike trains drive nothing: every feature is constant."""
    ds = _dataset(np.zeros((40, 16, 400), np.uint8))
    with pytest.raises(RuntimeError, match="--check failed in extract_lsm_features "
                                           r"\(train\): features are constant"):
        tpipe.extract_lsm_features(_tiny_cfg(), ds, CPU, run_diagnostics=False)


def test_check_passes_live_reservoir():
    spikes = (np.random.default_rng(1).random((40, 16, 400)) < 0.1).astype(np.uint8)
    checked = tpipe.extract_lsm_features(_tiny_cfg(), _dataset(spikes), CPU,
                                         run_diagnostics=False)
    plain = tpipe.extract_lsm_features(_tiny_cfg(False), _dataset(spikes), CPU,
                                       run_diagnostics=False)
    np.testing.assert_array_equal(checked.artifact.x_train, plain.artifact.x_train)


def test_check_flags_dead_features_in_the_streaming_trainer(tmp_path):
    from lsm_tpu_torch.io.sharded import ShardedSpikeDataset, ShardedSpikeDatasetWriter

    w = ShardedSpikeDatasetWriter(tmp_path / "sh", 16, compress=False)
    w.append(np.zeros((40, 16, 400), np.uint8), np.tile(np.arange(2, dtype=np.int32), 20))
    w.close()
    with pytest.raises(RuntimeError, match="--check failed in extract_and_train_streaming: "
                                           "features are constant"):
        tpipe.extract_and_train_streaming(_tiny_cfg(), ShardedSpikeDataset(tmp_path / "sh"),
                                          CPU, run_diagnostics=False)


@pytest.mark.parametrize("argv,expect", [(["--check"], True), ([], False)])
def test_check_flag_reaches_config(argv, expect):
    from lsm_tpu.cli import common as jcli
    from lsm_tpu_torch import __main__ as tcli
    import argparse

    p = argparse.ArgumentParser()
    jcli.add_extension_flags(p)
    assert tcli.build_config(tcli.parse_args(argv)).check is expect
    assert jcli.build_config(p.parse_args(argv)).check is expect


@pytest.mark.parametrize("features", [
    np.random.default_rng(0).random((4, 8)), np.zeros((4, 8)), np.full((2, 2), np.nan),
    np.array([[1.0, np.inf], [0.0, 2.0]]),
], ids=["live", "constant", "nan", "inf"])
def test_validate_features_verdicts_equal_reference(features):
    assert checks.validate_features(torch.as_tensor(features, dtype=torch.float32)) == \
        validate_features_host(features.astype(np.float32))


# ---- metrics and profiling -------------------------------------------------------

def test_metric_logger_records_equal_reference(tmp_path):
    """Record for record, except the timestamp."""
    out = {}
    for name, cls in (("port", MetricLogger), ("lsm_tpu", JMetricLogger)):
        buf = io.StringIO()
        m = cls(stream=buf, path=str(tmp_path / f"{name}.jsonl"))
        m.emit("accuracy", 0.5, split="test")
        m.emit("regime", "EDGE OF CHAOS", stage="extract_features", avg_participation=88.12)
        m.emit("stage1_wall_s", 1.234, stage="create_dataset", utterances=24)
        m.close()
        lines = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        assert buf.getvalue().splitlines() == lines
        out[name] = [json.loads(line) for line in lines]
    for a, b in zip(out["port"], out["lsm_tpu"], strict=True):
        assert list(a) == list(b)
        assert a.pop("ts") > 0 and b.pop("ts") > 0
        assert a == b
    assert default_metrics() is default_metrics()


def test_profiler_timers_and_trace(tmp_path):
    prof = profiling.Profiler()
    with prof.stage("demo", items=10):
        _ = sum(range(1000))
    assert prof.report().startswith("demo: ") and prof.timings["demo"].rate > 0
    with profiling.device_timer("cpu") as t:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert t["seconds"] > 0
    trace = tmp_path / "trace.json"
    with profiling.perfetto_trace(str(trace)):
        with prof.stage("traced"):
            torch.ones(8) + 1
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "traced" in names


# ---- the regime sweep ----------------------------------------------------------

def test_sweep_regime_matches_reference_point_for_point():
    rng = np.random.default_rng(0)
    spikes = (rng.random((8, 16, 40)) < 0.2).astype(np.uint8)
    kw = dict(num_neurons=128, num_output_neurons=64, small_world_k=26, input_fanout=4)
    grid = dict(input_fanouts=[2, 4], input_weights=[1.0], weight_variances=[10.0],
                multipliers=[0.05, 0.6, 3.0], n_probe=4)
    port = sweep_regime(spikes, tcfg.ReservoirConfig(**kw), **grid, device=CPU)
    ref = j_sweep(spikes, jcfg.ReservoirConfig(**kw), **grid)
    assert len(port) == len(ref) == 6
    for p, r in zip(port, ref):
        assert (p.input_fanout, p.input_weight, p.weight_variance, p.multiplier) == \
            (r.input_fanout, r.input_weight, r.weight_variance, r.multiplier)
        assert p.participation == r.participation and p.regime == r.regime
        np.testing.assert_allclose(p.spikes_per_neuron, r.spikes_per_neuron, rtol=1e-6)
    assert port[0].participation <= port[2].participation


# ---- the operator tools at a tiny size on the CPU -------------------------------

def test_calibrate_tool_runs(capsys):
    from lsm_tpu_torch.tools import calibrate

    calibrate.main(["--fanout", "4", "--multiplier", "0.6", "--num-neurons", "256",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "probe spikes: (96, 128, 400)" in out
    row = out.strip().splitlines()[-1].split()
    assert row[:4] == ["4", "1.00", "10.0", "0.60"]


def test_sensitivity_tool_runs(monkeypatch, capsys):
    from lsm_tpu_torch.tools import sensitivity

    monkeypatch.setattr(sensitivity, "PERTURBATIONS", sensitivity.PERTURBATIONS[:1] + (
        ("multiplier=0.3 (sub-critical)", {}, dict(multiplier=0.3)),))
    sensitivity.main(["--n-per-class", "5", "--feature-set", "original", "--markdown",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "baseline (reference defaults)" in out and "| multiplier=0.3" in out
    assert " +0.0000  " in out


def test_sparse_parity_tool_runs(capsys):
    from lsm_tpu_torch.tools import sparse_parity

    sparse_parity.main(["--neurons", "256", "--outputs", "64", "--n-per-class", "5",
                        "--device", "cpu"])
    out = capsys.readouterr()
    assert "corpus_seed=42: dense=" in out.out and "sparse=" in out.out
    assert "dense  N=256" in out.err and "sparse N=256" in out.err


def test_gtgram_conversion_tool_runs(capsys):
    from lsm_tpu_torch.tools import gtgram_conversion

    out = gtgram_conversion.main(["--rows", "2", "--channels", "3", "40",
                                  "--samples", "1600"])
    assert set(out) == {"kernel", "no_conversion"}
    for err in out.values():
        assert err.shape == (2,) and np.isfinite(err).all() and (err < 1e-2).all()
    assert "ch3" in capsys.readouterr().out


def test_tools_refuse_a_missing_card():
    from lsm_tpu_torch.tools import calibrate, sensitivity, sparse_parity

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for tool in (calibrate, sensitivity, sparse_parity):
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main(["--device", "cuda"])
