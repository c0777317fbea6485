"""The port stands alone: its copies of lsm_tpu's config dataclasses,
synthetic corpora and artifact writers agree with the reference, and
importing it loads neither jax nor anything of lsm_tpu."""

import collections
import contextlib
import ctypes
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from lsm_tpu import config as jcfg
from lsm_tpu.io import artifacts as jart
from lsm_tpu.io import dataset as jds

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch.io import artifacts as tart
from lsm_tpu_torch.io import dataset as tds
from lsm_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


def _assert_fields_equal(port, ref, path):
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _assert_fields_equal(a, b, f"{path}.{f.name}")
        else:
            assert a == b and type(a) is type(b), f"{path}.{f.name}: {a!r} != {b!r}"


@pytest.mark.parametrize("name", ["FrontendConfig", "ReservoirConfig", "ReadoutConfig",
                                  "PipelineConfig"])
def test_config_defaults_equal_reference(name):
    """Every field the port keeps has lsm_tpu's name and default."""
    _assert_fields_equal(getattr(tcfg, name)(), getattr(jcfg, name)(), name)


@pytest.mark.parametrize("kw", [{}, dict(n_filters=64, redundancy_factor=2, n_fft=1024,
                                         mel_fmin=20.0, mel_fmax=7600.0,
                                         spike_thresholds=(0.5, 0.9))])
def test_frontend_repr_and_dict_equal_reference(kw):
    """A sharded corpus is fingerprinted by repr(frontend) and a bundle
    stores its asdict: both must read as lsm_tpu's, field order included."""
    port, ref = tcfg.FrontendConfig(**kw), jcfg.FrontendConfig(**kw)
    assert repr(port) == repr(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert tcfg.frontend_to_dict(port) == jcfg.frontend_to_dict(ref)
    d = {**jcfg.frontend_to_dict(ref), "spike_thresholds": list(ref.spike_thresholds), "new": 1}
    assert tcfg.frontend_from_dict(d) == port
    cmds = ("yes", "no")
    assert tcfg.corpus_meta(tcfg.PipelineConfig(frontend=port, commands=cmds)) == \
        jcfg.corpus_meta(jcfg.PipelineConfig(frontend=ref, commands=cmds))


def test_config_constants_equal_reference():
    assert tcfg.FEATURE_SETS == jcfg.FEATURE_SETS
    assert tcfg.COMMANDS_12 == jcfg.COMMANDS_12
    port, ref = tcfg.FrontendConfig(), jcfg.FrontendConfig()
    assert (port.num_samples, port.n_thresholds, port.spike_train_length) == \
        (ref.num_samples, ref.n_thresholds, ref.spike_train_length)


@pytest.mark.parametrize("name", ["synthetic_audio_batch", "synthetic_audio_batch_hard"])
def test_synthetic_corpus_equals_reference(name):
    for a, b in zip(getattr(tds, name)(2, 12, seed=3), getattr(jds, name)(2, 12, seed=3)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("lvd", [None, 4.0])
def test_artifacts_load_with_reference_readers(tmp_path, lvd):
    rng = np.random.default_rng(0)
    spikes = (rng.random((5, 8, 12)) < 0.3).astype(np.uint8)
    labels = np.arange(5, dtype=np.int32)
    tart.save_spike_dataset(tmp_path / tart.SPIKE_DATASET_FILENAME,
                            tart.SpikeDataset(spikes, labels))
    ds = jart.load_spike_dataset(tmp_path / jart.SPIKE_DATASET_FILENAME)
    np.testing.assert_array_equal(ds.x_spikes, spikes)
    np.testing.assert_array_equal(ds.y_labels, labels)

    art = tart.FeatureArtifact(rng.random((4, 6)).astype(np.float32), labels[:4],
                               rng.random((1, 6)).astype(np.float32), labels[4:],
                               "original", lvd)
    tart.save_features(tmp_path / tart.FEATURES_FILENAME, art)
    got = jart.load_features(tmp_path / jart.FEATURES_FILENAME)
    for a, b in zip(got[:4], art[:4]):
        np.testing.assert_array_equal(a, b)
    assert got.feature_set == "original" and got.leak_variance_divisor == lvd


def test_port_imports_nothing_of_the_reference():
    code = (
        "import sys\n"
        "import lsm_tpu_torch.pipeline, lsm_tpu_torch.__main__, lsm_tpu_torch.convert\n"
        "import lsm_tpu_torch.models.diagnostics, lsm_tpu_torch.models.continuous\n"
        "import lsm_tpu_torch.models.streaming, lsm_tpu_torch.models.sparse, chip_smoke\n"
        "import lsm_tpu_torch.io.wav, lsm_tpu_torch.io.sharded, lsm_tpu_torch.io.model\n"
        "import lsm_tpu_torch.cli.common, lsm_tpu_torch.cli.create_dataset\n"
        "import lsm_tpu_torch.cli.extract_lsm_features, lsm_tpu_torch.cli.train_classifier\n"
        "import lsm_tpu_torch.cli.classify, lsm_tpu_torch.cli.stream_kws\n"
        "import lsm_tpu_torch.models.pool, lsm_tpu_torch.io.serving_state\n"
        "import lsm_tpu_torch.ops.stft, lsm_tpu_torch.ops.mel\n"
        "import lsm_tpu_torch.readout.streaming_fit, lsm_tpu_torch.tools.bench_stream_train\n"
        "import lsm_tpu_torch.utils.checks, lsm_tpu_torch.utils.logging\n"
        "import lsm_tpu_torch.utils.profiling, lsm_tpu_torch.models.sweep\n"
        "import lsm_tpu_torch.tools.calibrate, lsm_tpu_torch.tools.calibrate_continuous\n"
        "import lsm_tpu_torch.tools.sensitivity, lsm_tpu_torch.tools.inspect_state\n"
        "import lsm_tpu_torch.tools.sparse_parity, lsm_tpu_torch.tools.gtgram_conversion\n"
        "import lsm_tpu_torch.parallel.mesh, lsm_tpu_torch.parallel.sharded\n"
        "import lsm_tpu_torch.parallel.train_step, lsm_tpu_torch.io.native\n"
        "import lsm_tpu_torch.tools.bench_streaming, lsm_tpu_torch.tools.bench_continuous\n"
        "import lsm_tpu_torch.tools.bench_state, lsm_tpu_torch.tools.bench_tp\n"
        "import lsm_tpu_torch.tools.profile_stages, lsm_tpu_torch.tools.common\n"
        "ref = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lsm_tpu')]\n"
        "assert not ref, ref\n"
        "print('ALONE')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "ALONE" in proc.stdout, proc.stderr[-2000:]


def test_kernels_build_into_the_checkout():
    assert _build.BUILD_DIR == REPO / "build" / "lsm_tpu_torch"
    assert [p.name for p in _build.sources()] == ["fold.cu", "gtgram.cu", "hysteresis.cu",
                                                  "lif.cu", "sparse_lif.cu"]


def test_every_kernel_call_binds_once_and_counts_its_launches(monkeypatch):
    """`_build.Entry` binds a C entry point at its first call, with its
    argtypes set once; a launch passes the device's stream last, raises
    through `check` and counts under the entry point (and its body)."""
    calls, binds = [], []

    class Fn:
        def __setattr__(self, name, value):
            binds.append(name)
            object.__setattr__(self, name, value)

        def __call__(self, *args):
            calls.append(args)
            return 0 if args[0] else 7

    def error_string(err):
        return b"refused"

    lib = types.SimpleNamespace(lsm_fake=Fn(), lsm_cuda_error_string=error_string)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "launches", collections.Counter())
    monkeypatch.setattr(_build, "_error_string", _build.Entry(
        "lsm_cuda_error_string", [ctypes.c_int], ctypes.c_char_p))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=42))
    entry = _build.Entry("lsm_fake", [ctypes.c_int] * 2)
    cuda = torch.device("cuda", 0)
    entry.launch(cuda, 1)
    entry.launch(cuda, 2, body="cluster")
    assert calls == [(1, 42), (2, 42)] and binds == ["argtypes", "restype"]
    assert _build.launches == {"lsm_fake": 2, "lsm_fake:cluster": 1}
    with pytest.raises(RuntimeError, match="lsm_fake: CUDA error 7 at launch: refused"):
        entry.launch(cuda, 0)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        entry.launch(torch.device("cpu"), 1)
    assert _build.launches == {"lsm_fake": 2, "lsm_fake:cluster": 1}


def test_the_decoder_builds_into_the_checkout_and_nowhere_else(tmp_path):
    """csrc/wavio.cpp compiles into build/lsm_tpu_torch/ of the checkout:
    nothing lands in HOME, the cache or TMPDIR or in the package's tree."""
    if not __import__("shutil").which("g++"):
        pytest.skip("g++ is missing: the native decoder builds with it")
    home = tmp_path / "home"
    home.mkdir()
    before = {p for p in (REPO / "lsm_tpu_torch").rglob("*") if p.is_file()}
    code = ("from lsm_tpu_torch.io import native\n"
            "from lsm_tpu_torch.ops import _build\n"
            "assert native.available(), native.unavailable_reason()\n"
            "print(_build.build_wavio())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(home), TMPDIR=str(home),
               XDG_CACHE_HOME=str(home / "cache"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lib = Path(proc.stdout.strip().splitlines()[-1])
    assert lib.parent == REPO / "build" / "lsm_tpu_torch" and lib.is_file()
    assert not list(home.rglob("*"))
    after = {p for p in (REPO / "lsm_tpu_torch").rglob("*") if p.is_file()}
    assert not {p for p in after - before if "__pycache__" not in p.parts}
