"""`python -m lsm_tpu_torch` takes main.py's flags and builds the config
lsm_tpu's CLI builds from them; the stage entry points
(`lsm_tpu_torch.cli.*`) chain on a WAV corpus on the CPU, refuse the flags
whose feature is not ported, naming its ROADMAP item, and never fall back
from a missing card to the CPU."""

import argparse

import numpy as np
import pytest
import torch

from lsm_tpu import config as jcfg
from lsm_tpu.cli import common as jcli

from lsm_tpu_torch import __main__ as tcli
from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch.cli import classify, create_dataset, extract_lsm_features, train_classifier
from lsm_tpu_torch.io import dataset as tds

torch.set_num_threads(1)

# Flags both parsers take, and the port's own (--device, --hard), which
# lsm_tpu's parser does not know.
ARGVS = [
    [],
    ["--leak-variance-divisor", "4", "--redundancy-factor", "2", "--vocab", "v35",
     "--commands", "yes,no"],
    ["--n-filters", "64", "--num-neurons", "512", "--num-output-neurons", "128", "--sparse",
     "--multiplier", "1.2", "--feature-set", "all", "--vocab", "v35",
     "--samples-per-class", "30", "--batch-size", "64", "--leak-variance-divisor", "2.5"],
    ["--audio-wire", "ulaw", "--gammatone-method", "iir", "--data-dir", "elsewhere"],
]
PORT_ONLY = ["--device", "cpu", "--hard"]


def _reference_args(argv):
    p = argparse.ArgumentParser()
    jcli.add_frontend_flags(p)
    jcli.add_extract_flags(p)
    jcli.add_extension_flags(p)
    return p.parse_args(argv)


def _assert_fields_equal(port, ref, path):
    import dataclasses

    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _assert_fields_equal(a, b, f"{path}.{f.name}")
        else:
            assert a == b and type(a) is type(b), f"{path}.{f.name}: {a!r} != {b!r}"


@pytest.mark.parametrize("argv", ARGVS)
def test_same_argv_builds_the_same_config(argv):
    port = tcli.build_config(tcli.parse_args(argv + PORT_ONLY))
    ref = jcli.build_config(_reference_args(argv))
    _assert_fields_equal(port, ref, "PipelineConfig")


@pytest.mark.parametrize("argv,expect", [
    ([], jcfg.COMMANDS_12),
    (["--vocab", "v35"], jcfg.COMMANDS_35),
    (["--vocab", "v35", "--commands", " yes, no ,up,down"], ("yes", "no", "up", "down")),
])
def test_resolve_commands_agrees_with_reference(argv, expect):
    port = tcli.resolve_commands(tcli.parse_args(argv))
    assert port == jcli.resolve_commands(_reference_args(argv)) == expect
    assert tcfg.COMMANDS_35 == jcfg.COMMANDS_35


@pytest.mark.parametrize("raw", ["yes", "yes,no,yes"])
def test_resolve_commands_refuses_what_the_reference_refuses(raw):
    for resolve, args in ((tcli.resolve_commands, tcli.parse_args(["--commands", raw])),
                          (jcli.resolve_commands, _reference_args(["--commands", raw]))):
        with pytest.raises(SystemExit):
            resolve(args)


def test_cli_runs_with_the_new_flags(capsys):
    """The four flags end to end on the CPU: one class per --commands word,
    redundant channels, heterogeneous leak."""
    tcli.main(["--synthetic", "--samples-per-class", "20", "--leak-variance-divisor", "4",
               "--redundancy-factor", "2", "--commands", "yes,no,up,down", "--n-filters", "16",
               "--num-neurons", "200", "--num-output-neurons", "100", "--device", "cpu",
               "--skip-artifacts"])
    out = capsys.readouterr().out
    assert "Shape: (80, 32, 400)" in out and "--- Pipeline Finished ---" in out
    report = out.split("Classification Report:")[1]
    assert [w for w in ("yes", "no", "up", "down", "visual") if f" {w} " in report] == \
        ["yes", "no", "up", "down"]


SMALL = ["--commands", "a,b,c,d", "--n-filters", "16", "--device", "cpu"]
RESERVOIR = ["--num-neurons", "200", "--num-output-neurons", "100"]


def test_stage_entry_points_chain_on_a_wav_corpus(tmp_path, monkeypatch, capsys):
    """create_dataset (npz and shards) -> extract_lsm_features --input
    <shards> -> train_classifier, then the full pipeline with --save-model
    and classify --data-dir / --input <shards>: both routes predict alike."""
    monkeypatch.chdir(tmp_path)
    tds.write_synthetic_corpus(tmp_path / "corpus", ("a", "b", "c", "d"), n_per_class=12, seed=5)
    create_dataset.main(["--data-dir", "corpus", *SMALL, "--output", "s.npz"])
    create_dataset.main(["--data-dir", "corpus", *SMALL, "--sharded-output", "sh",
                         "--shard-size", "10", "--no-compress"])
    out = capsys.readouterr().out
    assert out.count("  Shape: (48, 16, 400)") == 2 and "Saved to 'sh'" in out
    extract_lsm_features.main(["--input", "sh", "--commands", "a,b,c,d", "--device", "cpu",
                               *RESERVOIR, "--output", "f.npz"])
    train_classifier.main(["--input", "f.npz", "--commands", "a,b,c,d", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Loaded 48 samples from 'sh'" in out and "Loaded 38 training and 10 test" in out
    assert "Test Accuracy:" in out

    tcli.main(["--data-dir", "corpus", *SMALL, *RESERVOIR, "--save-model", "m.npz"])
    assert "Model saved to 'm.npz'" in capsys.readouterr().out
    classify.main(["--model", "m.npz", "--data-dir", "corpus", "--device", "cpu",
                   "--output", "p_wav.npz", "--batch-size", "20"])
    classify.main(["--model", "m.npz", "--input", "sh", "--device", "cpu", "--output", "p_sh.npz"])
    classify.main(["--model", "m.npz", "--input", "s.npz", "--device", "cpu", "--output", "p_npz.npz"])
    out = capsys.readouterr().out
    assert out.count("Classified 48 utterances ->") == 3 and "Accuracy vs provided labels" in out
    p = [np.load(f"p_{k}.npz") for k in ("wav", "sh", "npz")]
    for q in p[1:]:
        np.testing.assert_array_equal(q["predictions"], p[0]["predictions"])
        np.testing.assert_array_equal(q["labels"], np.repeat(np.arange(4), 12))
    assert list(p[0]["class_names"]) == ["a", "b", "c", "d"]
    assert p[0]["predictions"].dtype == np.int32


REFUSED = [
    (tcli.main, ["--filterbank", "mel"], "A8"),
    (tcli.main, ["--gammatone-method", "fft"], "A8"),
    (tcli.main, ["--single-device"], "A14"),
    (tcli.main, ["--check"], "A15"),
    (tcli.main, ["--metrics-out", "m.jsonl"], "A15"),
    (create_dataset.main, ["--gammatone-method", "iir-xla"], "A8"),
    (extract_lsm_features.main, ["--streaming-fit"], "A13"),
    (extract_lsm_features.main, ["--ridge-alpha", "2"], "A13"),
    (extract_lsm_features.main, ["--readout", "logistic"], "A13"),
    (train_classifier.main, ["--metrics-out", "m.jsonl"], "A15"),
    (classify.main, ["--single-device"], "A14"),
]


@pytest.mark.parametrize("entry,argv,item", REFUSED,
                         ids=[f"{e.__module__.split('.')[-1]}{a[0]}" for e, a, _ in REFUSED])
def test_unported_flags_are_refused_by_item(entry, argv, item):
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        entry(argv + ["--device", "cpu"])


@pytest.mark.parametrize("entry", [tcli.main, create_dataset.main, extract_lsm_features.main,
                                   train_classifier.main, classify.main])
def test_device_cuda_without_cuda_raises(entry, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        entry(["--device", "cuda"])


def test_classify_refuses_a_continuous_bundle(tmp_path, capsys):
    from lsm_tpu_torch.io.model import save_model
    from lsm_tpu_torch.models.reservoir import init_reservoir
    from lsm_tpu_torch.readout.logistic import LogisticReadout
    from lsm_tpu_torch.readout.scaler import Scaler

    res = init_reservoir(tcfg.ReservoirConfig(num_neurons=100, num_output_neurons=50,
                                              small_world_k=20, mean_weight=0.02), 16)
    save_model(tmp_path / "c.npz", res, LogisticReadout(torch.zeros(250, 2), torch.zeros(2)),
               Scaler(torch.zeros(250), torch.ones(250)), tcfg.FrontendConfig(n_filters=16),
               "original", ("a", "b"), feature_mode="continuous",
               continuous_params={"chunk_len": 1600, "norm_decay_db_per_bin": 0.1})
    with pytest.raises(SystemExit) as exc:
        classify.main(["--model", str(tmp_path / "c.npz"), "--input", "x", "--device", "cpu"])
    assert exc.value.code == 1 and "continuous" in capsys.readouterr().err
