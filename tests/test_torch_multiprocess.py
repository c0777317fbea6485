"""The port's multi-process runtime (the port of tests/test_multihost.py's
two-process case): two processes join one gloo process group through the
entry points' env contract (LSM_TPU_COORDINATOR, LSM_TPU_NUM_PROCESSES,
LSM_TPU_PROCESS_ID) and run data-parallel extraction, fit_ridge_dp and the
corpus streaming trainer over a small shard corpus, and the full pipeline
CLI. Process 0's results are held against the single-process port (in
this process) and lsm_tpu; the tolerances are test_multihost.py's."""

import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lsm_tpu import config as jcfg
from lsm_tpu import pipeline as jpipe
from lsm_tpu.io.sharded import ShardedSpikeDataset as JShards
from lsm_tpu.models import reservoir as jres
from lsm_tpu.readout import logistic as jlog

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.io.sharded import ShardedSpikeDataset, ShardedSpikeDatasetWriter
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.readout import logistic as tlog

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
KEYS = tuple(jcfg.FEATURE_SETS["original"])

WORKER = textwrap.dedent(
    """
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from lsm_tpu_torch.parallel import mesh as ml

    assert ml.maybe_init_distributed_from_env(), "env contract not honored"
    import torch.distributed as dist

    from lsm_tpu_torch import config as tcfg
    from lsm_tpu_torch import pipeline as tpipe
    from lsm_tpu_torch.io.sharded import ShardedSpikeDataset
    from lsm_tpu_torch.models import reservoir as tres
    from lsm_tpu_torch.parallel.sharded import extract_features_dp
    from lsm_tpu_torch.readout import logistic

    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    mesh = ml.multihost_mesh(n_model=1)
    assert mesh.shape == {"data": 2, "model": 1}
    # n_model=2: the model group stays inside this host.
    assert ml.multihost_mesh(n_model=2).shape == {"data": 1, "model": 2}

    cfg = tcfg.ReservoirConfig(num_neurons=128, num_output_neurons=64, small_world_k=26,
                               mean_weight=0.03)
    reservoir = ml.replicate_to_mesh(tres.init_reservoir(cfg, n_channels=16), mesh)
    keys = tuple(tcfg.FEATURE_SETS["original"])
    inp = np.load(sys.argv[2])
    spikes, labels = inp["spikes"], inp["labels"]
    feats = ml.host_local(extract_features_dp(reservoir, ml.shard_batch(spikes, mesh), keys,
                                              mesh), mesh).numpy()
    ridge = logistic.fit_ridge_dp(feats, labels, num_classes=3, mesh=mesh)

    sf_cfg = tcfg.PipelineConfig(reservoir=cfg, frontend=tcfg.FrontendConfig(n_filters=16),
                                 commands=("a", "b", "c"), batch_size=16)
    out = {}
    for readout in ("logistic", "ridge"):
        sf = tpipe.extract_and_train_streaming(
            sf_cfg, ShardedSpikeDataset(sys.argv[3]), torch.device("cpu"),
            class_names=["a", "b", "c"], run_diagnostics=False, readout=readout,
            l2_c=1.0, max_iter=60)
        out.update({f"sf_{readout}_acc": sf.accuracy, f"sf_{readout}_w": sf.readout.w.numpy(),
                    f"sf_{readout}_b": sf.readout.b.numpy(), f"sf_{readout}_wc": sf.w_critico,
                    f"sf_{readout}_ntrain": sf.n_train})
    if dist.get_rank() == 0:
        np.savez(sys.argv[1], feats=feats, w=ridge.w.numpy(), b=ridge.b.numpy(), **out)
    print(f"worker {dist.get_rank()} done", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(port, rank):
    return {**os.environ, "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
            "LSM_TPU_COORDINATOR": f"localhost:{port}", "LSM_TPU_NUM_PROCESSES": "2",
            "LSM_TPU_PROCESS_ID": str(rank), "OMP_NUM_THREADS": "1"}


def _launch(argv, cwd, timeout=300):
    port = _free_port()
    procs = [subprocess.Popen(argv, env=_env(port, i), cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i} failed:\n{logs[i][-4000:]}"
    return logs


def _spikes_and_labels():
    """test_multihost.py's class-separable batch: class c fires hot in
    channel block c."""
    rng = np.random.default_rng(7)
    labels = (np.arange(32) % 3).astype(np.int32)
    rates = np.full((32, 16, 100), 0.05)
    for i, c in enumerate(labels):
        rates[i, c * 5:(c + 1) * 5] = 0.3
    return (rng.random((32, 16, 100)) < rates).astype(np.uint8), labels


def _write_corpus(root) -> None:
    """test_multihost.py's streaming-fit corpus: 96 class-separable rows in
    shards of 24 (the same bytes in both packages' format)."""
    rng = np.random.default_rng(7)
    n = 96
    labels = (np.arange(n) % 3).astype(np.int32)
    rates = np.full((n, 16, 400), 0.03)
    for i, c in enumerate(labels):
        rates[i, c * 5:(c + 1) * 5] = 0.25
    spikes = (rng.random((n, 16, 400)) < rates).astype(np.uint8)
    w = ShardedSpikeDatasetWriter(root, shard_size=24, compress=False)
    w.append(spikes, labels, np.arange(n))
    w.close()


def _reservoir_cfg(pkg):
    return pkg.ReservoirConfig(num_neurons=128, num_output_neurons=64, small_world_k=26,
                               mean_weight=0.03)


def _sf_cfg(pkg):
    return pkg.PipelineConfig(reservoir=_reservoir_cfg(pkg),
                              frontend=pkg.FrontendConfig(n_filters=16),
                              commands=("a", "b", "c"), batch_size=16)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiprocess")
    spikes, labels = _spikes_and_labels()
    np.savez(d / "in.npz", spikes=spikes, labels=labels)
    _write_corpus(d / "shards")
    (d / "worker.py").write_text(WORKER)
    _launch([sys.executable, str(d / "worker.py"), str(d / "p0.npz"), str(d / "in.npz"),
             str(d / "shards")], d)
    return d, dict(np.load(d / "p0.npz"))


def test_dp_features_equal_single_process_and_reference(two):
    _, got = two
    spikes, _ = _spikes_and_labels()
    single = tres.extract_features(tres.init_reservoir(_reservoir_cfg(tcfg), n_channels=16),
                                   torch.as_tensor(spikes), KEYS).numpy()
    np.testing.assert_array_equal(got["feats"], single)
    params = jres.init_reservoir(_reservoir_cfg(jcfg), n_channels=16)
    ref = np.asarray(jres.extract_features(params, jnp.asarray(spikes), KEYS))
    np.testing.assert_allclose(got["feats"], ref, rtol=1e-4, atol=1e-4)


def test_ridge_dp_decides_as_the_single_process_fits(two):
    _, got = two
    _, labels = _spikes_and_labels()
    feats = got["feats"]
    single = tlog.fit_ridge(torch.as_tensor(feats), torch.as_tensor(labels), 3)
    ref = jlog.fit_ridge(jnp.asarray(feats), jnp.asarray(labels), num_classes=3)
    logits = feats @ got["w"] + got["b"]
    for w, b in ((single.w.numpy(), single.b.numpy()), (np.asarray(ref.w), np.asarray(ref.b))):
        want = feats @ w + b
        # The Gram is ill-conditioned (near-collinear statistics), so the
        # decision function is compared, not the weights.
        np.testing.assert_allclose(logits, want, rtol=5e-3, atol=5e-3)
        np.testing.assert_array_equal(logits.argmax(axis=1), want.argmax(axis=1))
    assert (logits.argmax(axis=1) == labels).mean() == 1.0


@pytest.mark.parametrize("readout", ["logistic", "ridge"])
def test_streaming_trainer_equals_single_process(two, readout):
    d, got = two
    single = tpipe.extract_and_train_streaming(
        _sf_cfg(tcfg), ShardedSpikeDataset(d / "shards"), CPU, class_names=["a", "b", "c"],
        run_diagnostics=False, readout=readout, l2_c=1.0, max_iter=60, mesh=None)
    assert float(got[f"sf_{readout}_wc"]) == single.w_critico
    assert int(got[f"sf_{readout}_ntrain"]) == single.n_train
    assert float(got[f"sf_{readout}_acc"]) == pytest.approx(single.accuracy, abs=1e-6)
    assert single.accuracy == 1.0
    np.testing.assert_allclose(got[f"sf_{readout}_w"], single.readout.w.numpy(),
                               rtol=5e-2, atol=1e-3)
    np.testing.assert_allclose(got[f"sf_{readout}_b"], single.readout.b.numpy(),
                               rtol=5e-2, atol=1e-3)
    ref = jpipe.extract_and_train_streaming(
        _sf_cfg(jcfg), JShards(d / "shards"), class_names=["a", "b", "c"],
        run_diagnostics=False, mesh=None, readout=readout, l2_c=1.0, max_iter=60)
    assert float(got[f"sf_{readout}_acc"]) == pytest.approx(ref.accuracy, abs=1e-6)


def test_pipeline_cli_on_two_processes(tmp_path):
    """`python -m lsm_tpu_torch` launched as two processes: both exit 0,
    rank 0 writes the artifacts and the metric records once, and the
    accuracy is the single process's."""
    argv = [sys.executable, "-m", "lsm_tpu_torch", "--synthetic", "--hard",
            "--samples-per-class", "5", "--commands", "yes,no,up", "--n-filters", "16",
            "--num-neurons", "200", "--num-output-neurons", "64", "--batch-size", "6",
            "--device", "cpu", "--metrics-out", "m.jsonl"]
    logs = _launch(argv, tmp_path)
    one = tmp_path / "single"
    one.mkdir()
    single = subprocess.run(argv + ["--single-device"], cwd=one, capture_output=True,
                            text=True, timeout=300,
                            env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert single.returncode == 0, single.stdout[-3000:] + single.stderr[-3000:]
    acc = [re.search(r"Test Accuracy: ([0-9.]+)%", s).group(1) for s in logs + [single.stdout]]
    assert acc[0] == acc[1] == acc[2], acc
    for name in ("speech_spike_dataset_pure_redundancy.npz", "lsm_features_larger.npz"):
        a, b = np.load(tmp_path / name), np.load(one / name)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")
    records = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(records) == len((one / "m.jsonl").read_text().splitlines()) > 0


def test_stream_kws_cli_on_two_processes(tmp_path):
    """`python -m lsm_tpu_torch.cli.stream_kws` as two processes (the port of
    tests/test_multihost.py:539): static mode on 9 WAVs (padded to 10
    streams, 5 a rank) and --pool over 3 slots (rounded up to 4). Both
    serve on `mesh x2`, rank 0 alone prints the predictions and writes
    the output, and the predictions and labels equal the --single-device
    run's (exact-mode pool decisions equal the static run's)."""
    from lsm_tpu_torch.io.dataset import write_synthetic_corpus
    from lsm_tpu_torch.io.model import save_model
    from lsm_tpu_torch.readout.scaler import Scaler

    words = ["yes", "no", "up"]
    corpus = tmp_path / "corpus"
    write_synthetic_corpus(corpus, words, n_per_class=3)
    reservoir = tres.init_reservoir(_reservoir_cfg(tcfg), n_channels=16)
    d = len(KEYS) * reservoir.n_outputs
    rng = np.random.default_rng(0)
    save_model(tmp_path / "m.npz", reservoir,
               tlog.LogisticReadout(rng.normal(0, 0.1, (d, 3)).astype(np.float32),
                                    rng.normal(0, 0.1, 3).astype(np.float32)),
               Scaler(np.zeros(d, np.float32), np.ones(d, np.float32)),
               tcfg.FrontendConfig(n_filters=16), "original", words)
    serve = [sys.executable, "-m", "lsm_tpu_torch.cli.stream_kws", "--model", "m.npz",
             "--data-dir", str(corpus), "--device", "cpu"]
    single = subprocess.run(serve + ["--single-device", "--output", "single.npz"], cwd=tmp_path,
                            capture_output=True, text=True, timeout=300,
                            env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert single.returncode == 0, single.stdout[-3000:] + single.stderr[-3000:]
    want = np.load(tmp_path / "single.npz")
    assert len(want["predictions"]) == 9
    for extra, out in ((["--compact"], "multi.npz"),
                       (["--pool", "--max-streams", "3"], "pool.npz")):
        logs = _launch(serve + extra + ["--output", out], tmp_path)
        assert "mesh x2" in logs[0], logs[0][-2000:]
        assert "Final predictions for 9 streams" in logs[0]
        assert "Serving" not in logs[1] and "Final predictions" not in logs[1], logs[1][-2000:]
        got = np.load(tmp_path / out)
        np.testing.assert_array_equal(got["predictions"], want["predictions"], err_msg=out)
        np.testing.assert_array_equal(got["labels"], want["labels"], err_msg=out)
        np.testing.assert_array_equal(got["files"], want["files"], err_msg=out)
    assert "4 pool slots" in logs[0]
