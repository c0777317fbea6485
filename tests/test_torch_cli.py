"""`python -m lsm_tpu_torch` takes main.py's flags and builds the config
lsm_tpu's CLI builds from them; the stage entry points
(`lsm_tpu_torch.cli.*`) chain on a WAV corpus on the CPU, take lsm_tpu's
--single-device, --check and --metrics-out, and never fall back from a
missing card to the CPU. The serving entry point `cli.stream_kws` gives
the root stream_kws.py's predictions, output fields and metric records in
every mode (exact dense and sparse, compact, pool, continuous), their
serving-state files continue each other's streams and read alike in
`tools.inspect_state`, and it exits 1 where stream_kws.py does;
`tools.calibrate_continuous` writes a continuous bundle lsm_tpu loads."""

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


# The flags each entry point refused until the port had them (ROADMAP
# A15): each now runs.
TAKEN = [
    (tcli.main, ["--single-device"]),
    (tcli.main, ["--check"]),
    (tcli.main, ["--metrics-out", "m.jsonl"]),
    (train_classifier.main, ["--metrics-out", "m.jsonl"]),
    (classify.main, ["--single-device"]),
]


@pytest.mark.parametrize("entry,argv", TAKEN,
                         ids=[f"{e.__module__.split('.')[-1]}{a[0]}" for e, a in TAKEN])
def test_formerly_refused_flags_are_taken(entry, argv, tmp_path, monkeypatch, capsys):
    """The run completes; --metrics-out appends the entry point's records
    (tests/test_torch_cli_metrics.py holds them equal to lsm_tpu's)."""
    from lsm_tpu_torch.io import artifacts as tart
    from lsm_tpu_torch.io.model import save_model
    from lsm_tpu_torch.models.reservoir import init_reservoir
    from lsm_tpu_torch.readout.logistic import LogisticReadout
    from lsm_tpu_torch.readout.scaler import Scaler

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(3)
    if entry is tcli.main:
        entry(argv + ["--synthetic", "--samples-per-class", "6", "--commands", "a,b,c,d",
                      "--n-filters", "16", *RESERVOIR, "--device", "cpu", "--skip-artifacts"])
        assert "--- Pipeline Finished ---" in capsys.readouterr().out
        expect = ["stage1_wall_s", "avg_spikes_per_sample", "stage2_wall_s", "w_critico",
                  "mean_weight", "regime", "stage3_wall_s", "test_accuracy"]
    elif entry is train_classifier.main:
        y = np.repeat(np.arange(4, dtype=np.int32), 10)
        tart.save_features(tmp_path / "f.npz", tart.FeatureArtifact(
            (rng.standard_normal((40, 12)) + y[:, None]).astype(np.float32), y,
            (rng.standard_normal((8, 12)) + y[::5, None]).astype(np.float32), y[::5],
            "original", None))
        entry(argv + ["--input", "f.npz", "--commands", "a,b,c,d", "--device", "cpu"])
        assert "Test Accuracy:" in capsys.readouterr().out
        expect = ["stage3_wall_s", "test_accuracy"]
    else:
        tds.write_synthetic_corpus(tmp_path / "corpus", ("a", "b"), n_per_class=2, seed=5)
        res = init_reservoir(tcfg.ReservoirConfig(num_neurons=100, num_output_neurons=50,
                                                  small_world_k=20, mean_weight=0.02), 16)
        save_model(tmp_path / "m.npz", res, LogisticReadout(torch.zeros(250, 2), torch.zeros(2)),
                   Scaler(torch.zeros(250), torch.ones(250)), tcfg.FrontendConfig(n_filters=16),
                   "original", ("a", "b"))
        entry(argv + ["--model", "m.npz", "--data-dir", "corpus", "--device", "cpu"])
        assert "Classified 4 utterances" in capsys.readouterr().out
        expect = None
    if "--metrics-out" in argv:
        import json

        records = [json.loads(r) for r in (tmp_path / "m.jsonl").read_text().splitlines()]
        assert [r["metric"] for r in records] == expect


@pytest.fixture(scope="module")
def small_shards(tmp_path_factory):
    """A 4-class WAV corpus featurized into shards by cli.create_dataset."""
    root = tmp_path_factory.mktemp("cli_shards")
    tds.write_synthetic_corpus(root / "corpus", ("a", "b", "c", "d"), n_per_class=12, seed=5)
    create_dataset.main(["--data-dir", str(root / "corpus"), *SMALL,
                         "--sharded-output", str(root / "sh"), "--shard-size", "10"])
    return root


# The flags that waited for the mel frontend and the other gammatone methods
# (ROADMAP A8) and for the streaming trainer (A13): each now runs.
NOW_RUN = [
    (tcli.main, ["--filterbank", "mel"]),
    (tcli.main, ["--gammatone-method", "fft"]),
    (create_dataset.main, ["--gammatone-method", "iir-xla"]),
    (extract_lsm_features.main, ["--streaming-fit"]),
    (extract_lsm_features.main, ["--streaming-fit", "--ridge-alpha", "2"]),
    (extract_lsm_features.main, ["--streaming-fit", "--readout", "logistic"]),
]


@pytest.mark.parametrize("entry,argv", NOW_RUN,
                         ids=[f"{e.__module__.split('.')[-1]}{a[-1]}" for e, a in NOW_RUN])
def test_formerly_unported_flags_run(entry, argv, small_shards, tmp_path, monkeypatch, capsys):
    """The frontend flags build lsm_tpu's config field by field and a
    4-class run completes; the streaming-fit flags train on a shard
    directory and save a bundle."""
    monkeypatch.chdir(tmp_path)
    if entry is extract_lsm_features.main:
        entry(argv + ["--input", str(small_shards / "sh"), *RESERVOIR, "--batch-size", "16",
                      "--save-model", "m.npz", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "Streaming 48 samples" in out and "Model bundle saved to 'm.npz'" in out
        assert "Test Accuracy:" in out
        if "logistic" in argv:
            from lsm_tpu_torch.cli import stream_kws

            stream_kws.main(["--model", "m.npz", "--data-dir", str(small_shards / "corpus"),
                             "--mode", "exact", "--chunk-ms", "500", "--output", "p.npz",
                             "--device", "cpu"])
            assert len(np.load("p.npz")["predictions"]) == 48
        return
    port = tcli.build_config(tcli.parse_args(argv + PORT_ONLY))
    _assert_fields_equal(port, jcli.build_config(_reference_args(argv)), "PipelineConfig")
    if entry is create_dataset.main:
        entry(["--data-dir", str(small_shards / "corpus"), *SMALL, *argv, "--output", "s.npz"])
        assert "  Shape: (48, 16, 400)" in capsys.readouterr().out
        return
    entry(argv + ["--synthetic", "--samples-per-class", "20", "--commands", "yes,no,up,down",
                  "--n-filters", "16", *RESERVOIR, "--device", "cpu", "--skip-artifacts"])
    out = capsys.readouterr().out
    assert "Shape: (80, 16, 400)" in out and "--- Pipeline Finished ---" in out


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


# ---- the serving entry point: cli.stream_kws against the root stream_kws.py -----

def _reference_stream_kws():
    """The repo-root stream_kws.py, loaded by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "stream_kws.py"
    spec = importlib.util.spec_from_file_location("_reference_stream_kws", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def serving_dir(tmp_path_factory):
    """A 4-class WAV corpus (2 files a class) and five bundles on lsm_tpu's
    dyadic draws (16 filters, 128 neurons dense, 256 block-sparse): batch
    dense (v1), batch sparse (v2-sparse) and continuous dense, chunk 3200,
    on the gammatone frontend; batch and continuous dense on the mel one."""
    import dataclasses

    import jax.numpy as jnp

    from lsm_tpu.models import reservoir as jres
    from lsm_tpu.models import sparse as jsp

    from lsm_tpu_torch import convert
    from lsm_tpu_torch.io.model import save_model
    from lsm_tpu_torch.readout.logistic import LogisticReadout
    from lsm_tpu_torch.readout.scaler import Scaler

    d = tmp_path_factory.mktemp("serving")
    tds.write_synthetic_corpus(d / "corpus", ("a", "b", "c", "d"), n_per_class=2, seed=9)
    fcfg = tcfg.FrontendConfig(n_filters=16)
    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0
    dense = jres.init_reservoir(jcfg.ReservoirConfig(num_neurons=128, num_output_neurons=64,
                                                     small_world_k=16, mean_weight=0.03), 16)
    dense = convert.reservoir(dataclasses.replace(dense, w_rec=q(dense.w_rec), w_in=q(dense.w_in)))
    sparse = jsp.init_reservoir_sparse(jcfg.ReservoirConfig(
        num_neurons=256, num_output_neurons=64, small_world_k=52, mean_weight=0.03,
        sparse=True), 16)
    sparse = convert.sparse_reservoir(dataclasses.replace(sparse, w_blocks=q(sparse.w_blocks)))
    rng = np.random.default_rng(4)
    dim = 5 * 64
    ro = LogisticReadout(rng.normal(0, 0.5, (dim, 4)).astype(np.float32),
                         rng.normal(0, 0.5, 4).astype(np.float32))
    sc = Scaler(rng.random(dim).astype(np.float32), (rng.random(dim) + 0.5).astype(np.float32))
    names = ("a", "b", "c", "d")
    save_model(d / "dense.npz", dense, ro, sc, fcfg, "original", names)
    save_model(d / "sparse.npz", sparse, ro, sc, fcfg, "original", names)
    save_model(d / "cont.npz", dense, ro, sc, fcfg, "original", names,
               feature_mode="continuous",
               continuous_params={"chunk_len": 3200, "norm_decay_db_per_bin": 0.1})
    mel = tcfg.FrontendConfig(n_filters=16, filterbank="mel")
    save_model(d / "mel.npz", dense, ro, sc, mel, "original", names)
    save_model(d / "mel_cont.npz", dense, ro, sc, mel, "original", names,
               feature_mode="continuous",
               continuous_params={"chunk_len": 3200, "norm_decay_db_per_bin": 0.1})
    return d


def _serve_both(d, argv, monkeypatch, capsys, tag):
    """The port's entry point on the CPU and lsm_tpu's on one device, the
    same argv; returns (port's output file, reference's, port's stdout)."""
    from lsm_tpu_torch.cli import stream_kws

    monkeypatch.chdir(d)
    stream_kws.main(argv + ["--output", f"{tag}_t.npz", "--device", "cpu"])
    out = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["stream_kws.py", *argv, "--output", f"{tag}_j.npz",
                                     "--single-device"])
    _reference_stream_kws().main()
    capsys.readouterr()
    return np.load(d / f"{tag}_t.npz"), np.load(d / f"{tag}_j.npz"), out


SERVE = {
    "exact": ["--model", "dense.npz", "--chunk-ms", "200", "--diagnostics-every", "4"],
    "sparse": ["--model", "sparse.npz", "--chunk-ms", "200", "--wire", "pcm16"],
    "compact": ["--model", "dense.npz", "--chunk-ms", "200", "--compact", "--wire", "ulaw",
                "--check"],
    "pool": ["--model", "dense.npz", "--chunk-ms", "200", "--pool", "--max-streams", "3",
             "--wire", "pcm16", "--check"],
    "continuous": ["--model", "cont.npz", "--mode", "continuous"],
    "mel_exact": ["--model", "mel.npz", "--chunk-ms", "200", "--wire", "pcm16"],
    "mel_continuous": ["--model", "mel_cont.npz", "--mode", "continuous"],
}


@pytest.mark.parametrize("mode", list(SERVE))
def test_stream_kws_predicts_as_reference(serving_dir, monkeypatch, capsys, mode):
    """Every mode gives lsm_tpu's predictions for every file, with the same
    output fields; the margins of the compact egress within float16
    rounding."""
    port, ref, out = _serve_both(serving_dir, ["--data-dir", "corpus", *SERVE[mode]],
                                 monkeypatch, capsys, mode)
    assert sorted(port.files) == sorted(ref.files)
    np.testing.assert_array_equal(port["predictions"], ref["predictions"])
    for k in ("labels", "files", "class_names"):
        np.testing.assert_array_equal(port[k], ref[k])
    if "margins" in ref.files:
        np.testing.assert_allclose(port["margins"], ref["margins"], rtol=2e-3, atol=1e-4)
    assert "Accuracy vs directory labels (8 streams)" in out
    assert ("SERVING RESERVOIR DIAGNOSTICS" in out) == (mode == "exact")


def test_stream_kws_state_files_cross_packages(serving_dir, monkeypatch, capsys):
    """Continuous mode with --save-state (and a periodic checkpoint) on each
    side; each side then restores the other's file and serves on: the two
    restored runs predict alike."""
    base = ["--data-dir", "corpus", *SERVE["continuous"], "--wire", "pcm16"]
    _serve_both(serving_dir, base + ["--save-state", "s.npz", "--save-state-every", "2",
                                     "--state-no-compress"], monkeypatch, capsys, "save")
    # _serve_both ran the port first, then lsm_tpu over the same path:
    # keep each side's file apart.
    from lsm_tpu_torch.cli import stream_kws

    stream_kws.main(base + ["--save-state", "s_t.npz", "--output", "x.npz", "--device", "cpu"])
    assert "Stream state snapshot -> 's_t.npz'" in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["stream_kws.py", *base, "--restore-state", "s_t.npz",
                                     "--output", "r_j.npz", "--single-device"])
    _reference_stream_kws().main()
    stream_kws.main(base + ["--restore-state", "s.npz", "--output", "r_t.npz", "--device", "cpu"])
    assert "Stream state restored from 's.npz'" in capsys.readouterr().out
    np.testing.assert_array_equal(np.load(serving_dir / "r_t.npz")["predictions"],
                                  np.load(serving_dir / "r_j.npz")["predictions"])


STREAM_EXIT_1 = [
    (["--save-state-every", "2"], "--save-state-every needs --save-state"),
    (["--max-streams", "0"], "--max-streams must be >= 1"),
    (["--model", "missing.npz"], "Model file not found"),
    (["--mode", "continuous"], "needs a continuous-calibrated bundle"),
    (["--model", "cont.npz", "--mode", "exact"], "calibrated for continuous-mode"),
    (["--pool", "--restore-state", "s.npz"], "--pool replays files"),
    (["--data-dir", "empty"], "no WAVs under"),
    (["--chunk-ms", "2000"], "exceeds the 16000-sample analysis window"),
    (["--restore-state", "nowhere.npz"], "Error restoring state"),
]


# --single-device and --metrics-out, which the port's stream_kws refused
# until it had them: static and pool serving with each; the metric records
# of both packages for the same argv.
STREAM_TAKEN = {
    "single_device": SERVE["exact"] + ["--single-device"],
    "metrics_out": SERVE["exact"] + ["--metrics-out", "m.jsonl"],
    "metrics_out_pool": SERVE["pool"] + ["--diagnostics-every", "2", "--metrics-out", "m.jsonl"],
}


@pytest.mark.parametrize("case", list(STREAM_TAKEN))
def test_stream_kws_takes_single_device_and_metrics_out(serving_dir, monkeypatch, capsys,
                                                         case):
    import json

    (serving_dir / "m.jsonl").unlink(missing_ok=True)
    port, ref, out = _serve_both(serving_dir, ["--data-dir", "corpus", *STREAM_TAKEN[case]],
                                 monkeypatch, capsys, case)
    np.testing.assert_array_equal(port["predictions"], ref["predictions"])
    assert "Accuracy vs directory labels (8 streams)" in out
    if case == "single_device":
        return
    # _serve_both ran the port first, then lsm_tpu, appending to one file.
    records = [json.loads(r) for r in (serving_dir / "m.jsonl").read_text().splitlines()]
    half = len(records) // 2
    t, j = records[:half], records[half:]
    names = [r["metric"] for r in t]
    assert names == [r["metric"] for r in j] and len(records) == 2 * half
    n_diag = names.count("serving_participation_pct")
    tail = ["serving_stream_chunks_per_sec", "serving_accuracy"]
    if case == "metrics_out_pool":
        tail = ["serving_pool_sessions"] + tail
    assert n_diag >= 1 and names == ["serving_participation_pct"] * n_diag + tail
    for a, b in zip(t, j):
        assert list(a) == list(b)
        for k in a:
            if k not in ("ts", "value", "wall_s"):
                assert a[k] == b[k], (a["metric"], k)


def test_inspect_state_describes_both_packages_snapshots_alike(serving_dir, monkeypatch,
                                                               capsys, tmp_path):
    """Each package's continuous engine saved after the same serving run:
    equal identity headers and leaves, and --diff finds no difference."""
    from lsm_tpu_torch.tools import inspect_state

    base = ["--data-dir", "corpus", *SERVE["continuous"], "--state-no-compress"]
    _serve_both(serving_dir, base + ["--save-state", "insp_t.npz"], monkeypatch, capsys,
                "insp")
    # _serve_both's reference run overwrote insp_t.npz: write the port's
    # file again under its own name.
    from lsm_tpu_torch.cli import stream_kws

    (serving_dir / "insp_t.npz").rename(serving_dir / "insp_j.npz")
    stream_kws.main(base + ["--save-state", "insp_t.npz", "--output", "x.npz",
                            "--device", "cpu"])
    capsys.readouterr()
    a = inspect_state.describe(serving_dir / "insp_t.npz")
    b = inspect_state.describe(serving_dir / "insp_j.npz")
    assert a["meta"] == b["meta"] and a["leaves"] == b["leaves"]
    assert a["meta"]["engine"] == "continuous" and a["meta"]["n_streams"] == 8
    assert inspect_state.diff(serving_dir / "insp_t.npz", serving_dir / "insp_j.npz") == 0
    text = inspect_state.render(serving_dir / "insp_t.npz", a)
    assert "engine:      continuous  (8 streams)" in text and "weights_crc: 0x" in text


def test_calibrate_continuous_writes_a_bundle_lsm_tpu_loads(serving_dir, tmp_path, capsys):
    from lsm_tpu.io.model import load_model as j_load

    from lsm_tpu_torch.tools import calibrate_continuous

    out = tmp_path / "cont.npz"
    calibrate_continuous.main(["--model", str(serving_dir / "dense.npz"), "--out", str(out),
                               "--synthetic", "--samples-per-class", "3", "--device", "cpu"])
    assert "Calibrating on 12 utterances" in capsys.readouterr().out
    bundle = j_load(out)
    assert bundle.feature_mode == "continuous"
    assert bundle.continuous_params == {"chunk_len": 1600, "norm_decay_db_per_bin": 0.1}
    assert tuple(bundle.class_names) == ("a", "b", "c", "d")
    assert np.asarray(bundle.readout.w).shape == (5 * 64, 4)


@pytest.mark.parametrize("argv,message", STREAM_EXIT_1,
                         ids=["every", "max_streams", "model", "mode_cont", "mode_exact", "pool",
                              "empty", "chunk", "restore"])
def test_stream_kws_exits_1_as_reference(serving_dir, monkeypatch, capsys, argv, message):
    from lsm_tpu_torch.cli import stream_kws

    monkeypatch.chdir(serving_dir)
    (serving_dir / "empty").mkdir(exist_ok=True)
    full = ["--model", "dense.npz", "--data-dir", "corpus", *argv]
    with pytest.raises(SystemExit) as exc:
        stream_kws.main(full + ["--device", "cpu"])
    assert exc.value.code == 1 and message in capsys.readouterr().err
    monkeypatch.setattr("sys.argv", ["stream_kws.py", *full, "--single-device"])
    with pytest.raises(SystemExit) as exc:
        _reference_stream_kws().main()
    assert exc.value.code == 1 and message in capsys.readouterr().err


def test_stream_kws_device_cuda_without_cuda_raises(serving_dir, monkeypatch):
    from lsm_tpu_torch.cli import stream_kws

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(serving_dir)
    with pytest.raises(RuntimeError, match="cuda"):
        stream_kws.main(["--model", "dense.npz", "--data-dir", "corpus", "--device", "cuda"])
