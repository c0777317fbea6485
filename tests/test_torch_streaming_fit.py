"""The port's corpus-scale streaming trainer (lsm_tpu_torch.readout.
streaming_fit, scaler.fit_scaler_from_moments, logistic.fit_ridge, the
sharded reader's iter_batches(mask=) / labels / gather_rows and
pipeline.extract_and_train_streaming) against lsm_tpu on the CPU.

Tolerances: the accumulator's seven fields rtol 1e-5 (atol 1e-5 of each
field's largest magnitude) on the same batches (lsm_tpu's last one padded
with zero-weight rows, the port's not); finalize_ridge against
lsm_tpu's and against fit_ridge on the in-memory scaled matrix at
tests/test_streaming_fit.py's tolerances (mean rtol 1e-5 / atol 1e-4,
scale rtol 1e-4 / atol 1e-4, w and b rtol 5e-3 / atol 5e-4); the trainer
against lsm_tpu's on the same shard directory and host reservoir draw:
n_train and n_test equal, scaler means rtol 1e-4 / atol 1e-4, accuracy
within 0.02, predictions equal on >= 0.95 of the test rows; against the
port's in-memory path: ridge accuracy within 1e-6, logistic within 0.02.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lsm_tpu import pipeline as jpipe
from lsm_tpu.config import FrontendConfig, PipelineConfig, ReservoirConfig
from lsm_tpu.io import dataset as jds
from lsm_tpu.io.sharded import ShardedSpikeDataset as JaxShards
from lsm_tpu.models import reservoir as jres
from lsm_tpu.readout import logistic as jlog
from lsm_tpu.readout import scaler as jsc
from lsm_tpu.readout import streaming_fit as jsf

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.io.artifacts import SpikeDataset
from lsm_tpu_torch.io.sharded import ShardedSpikeDataset, ShardedSpikeDatasetWriter
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.readout import logistic as tlog
from lsm_tpu_torch.readout import scaler as tsc
from lsm_tpu_torch.readout import streaming_fit as tsf

torch.set_num_threads(1)

CPU = torch.device("cpu")
CMDS = ("a", "b", "c")
RES = dict(num_neurons=256, num_output_neurons=64, small_world_k=51)


def _batches(x, y, batch):
    """(features, labels, 0/1 weights) batches, the last padded to `batch`
    as lsm_tpu's trainer pads it."""
    for s in range(0, x.shape[0], batch):
        xb, yb = x[s:s + batch], y[s:s + batch]
        n_real = xb.shape[0]
        w = np.zeros(batch, np.float32)
        w[:n_real] = 1.0
        yield (np.pad(xb, [(0, batch - n_real), (0, 0)]), np.pad(yb, [(0, batch - n_real)]), w)


def _jax_accum(x, y, k, batch):
    state = None
    for xb, yb, w in _batches(x, y, batch):
        fb = jnp.asarray(xb)
        if state is None:
            wd = jnp.asarray(w)
            state = jsf.init_ridge_accum(jnp.sum(fb * wd[:, None], axis=0) / jnp.sum(wd), k)
        state = jsf.update_ridge_accum(state, fb, jnp.asarray(yb), jnp.asarray(w))
    return state


def _port_accum(x, y, k, batch, shift=None):
    """The port's accumulator over the same batches' real rows (its trainer
    does not pad), around `shift` or the first batch's mean."""
    state = None
    for xb, yb, w in _batches(x, y, batch):
        n_real = int(w.sum())
        f = torch.as_tensor(xb[:n_real])
        if state is None:
            state = tsf.init_ridge_accum(torch.mean(f, dim=0) if shift is None
                                         else torch.tensor(shift), k)
        tsf.update_ridge_accum(state, f, torch.as_tensor(yb[:n_real]))
    return state


@pytest.fixture(scope="module")
def matrix():
    rng = np.random.default_rng(42)
    n, d, k = 230, 40, 5
    # Large feature means exercise the shifted-Gram cancellation guard.
    x = (rng.standard_normal((n, d)) * 3.0 + rng.uniform(-50, 50, d)).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.int32)
    return x, y, k


def test_accumulator_fields_match_reference(matrix):
    x, y, k = matrix
    ref = _jax_accum(x, y, k, 64)             # its last batch padded, weights 0
    port = _port_accum(x, y, k, 64, shift=np.asarray(ref.shift))   # s1 moves with c
    for name in tsf.RidgeAccumState._fields:
        a, b = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and a.dtype == np.float32, name
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_finalize_matches_reference_and_in_memory_ridge(matrix):
    x, y, k = matrix
    jw, js = jsf.finalize_ridge(_jax_accum(x, y, k, 64), alpha=1.0)
    tw, ts = tsf.finalize_ridge(_port_accum(x, y, k, 64), alpha=1.0)
    cw, cs = tsf.finalize_ridge(convert.ridge_accum(_jax_accum(x, y, k, 64)), alpha=1.0)
    st = tsc.fit_scaler(torch.as_tensor(x))
    mem = tlog.fit_ridge(tsc.transform(st, torch.as_tensor(x)), torch.as_tensor(y), k, alpha=1.0)
    jmem = jlog.fit_ridge(jsc.transform(jsc.fit_scaler(jnp.asarray(x)), jnp.asarray(x)),
                          jnp.asarray(y), num_classes=k, alpha=1.0)
    for (rw, rb, rm, rs) in ((np.asarray(jw.w), np.asarray(jw.b), np.asarray(js.mean),
                              np.asarray(js.scale)),
                             (mem.w.numpy(), mem.b.numpy(), st.mean.numpy(), st.scale.numpy())):
        for w_, s_ in ((tw, ts), (cw, cs)):
            np.testing.assert_allclose(s_.mean.numpy(), rm, rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(s_.scale.numpy(), rs, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(w_.w.numpy(), rw, rtol=5e-3, atol=5e-4)
            np.testing.assert_allclose(w_.b.numpy(), rb, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(mem.w.numpy(), np.asarray(jmem.w), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(mem.b.numpy(), np.asarray(jmem.b), rtol=5e-3, atol=5e-4)


def test_accumulator_batch_size_invariance():
    rng = np.random.default_rng(42)
    n, d, k = 150, 16, 3
    x = (rng.standard_normal((n, d)) + 10.0).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.int32)
    p1, s1 = tsf.finalize_ridge(_port_accum(x, y, k, 150))
    p2, s2 = tsf.finalize_ridge(_port_accum(x, y, k, 32))
    np.testing.assert_allclose(p1.w.numpy(), p2.w.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(s1.mean.numpy(), s2.mean.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spread", [1.0, 1.0 / 40.0])
def test_scaler_from_moments_matches_reference(matrix, spread):
    """Large means (spread 1) and means of the order of the std."""
    x = matrix[0][:, :8] * np.float32(spread)
    x[:, 3] = 0.0                                        # zero variance -> scale 1
    c = x[:16].mean(0)
    s1, s2, n = (x - c).sum(0), ((x - c) ** 2).sum(0), x.shape[0]
    ref = jsc.fit_scaler_from_moments(jnp.asarray(s1), jnp.asarray(s2), jnp.float32(n),
                                      shift=jnp.asarray(c))
    port = tsc.fit_scaler_from_moments(torch.tensor(s1), torch.tensor(s2),
                                       torch.tensor(float(n)), shift=torch.tensor(c))
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(ref.mean), rtol=1e-6, atol=0)
    np.testing.assert_allclose(port.scale.numpy(), np.asarray(ref.scale), rtol=1e-5, atol=0)
    assert port.scale[3] == 1.0


# ---- the sharded reader and the trainer ----------------------------------------

@pytest.fixture(scope="module")
def pcfg():
    return tcfg.PipelineConfig(frontend=tcfg.FrontendConfig(n_filters=32), commands=CMDS,
                               batch_size=16, reservoir=tcfg.ReservoirConfig(**RES))


@pytest.fixture(scope="module")
def corpus(pcfg, tmp_path_factory):
    """A sharded corpus written by the port (13 rows a shard, so batches
    straddle shard edges) and the same rows in memory."""
    audio, labels = jds.synthetic_audio_batch(n_per_class=20, n_classes=len(CMDS), seed=7)
    spikes = tpipe.featurize_audio_array(pcfg, audio, CPU)
    root = tmp_path_factory.mktemp("streamfit") / "ds"
    w = ShardedSpikeDatasetWriter(Path(root), shard_size=13, meta=tcfg.corpus_meta(pcfg))
    w.append(spikes, labels, np.arange(len(labels)))
    w.close()
    return ShardedSpikeDataset(Path(root)), SpikeDataset(spikes, labels)


def test_masked_batches_cover_exactly_the_mask(corpus):
    sds, mem = corpus
    mask = np.random.default_rng(42).random(mem.x_spikes.shape[0]) < 0.4
    xs, ys = [], []
    for b in sds.iter_batches(16, mask=mask):
        assert b.x_spikes.shape[0] <= 16
        xs.append(b.x_spikes)
        ys.append(b.y_labels)
    np.testing.assert_array_equal(np.concatenate(xs), mem.x_spikes[mask])
    np.testing.assert_array_equal(np.concatenate(ys), mem.y_labels[mask])
    ref = [(np.asarray(b.x_spikes), np.asarray(b.y_labels))
           for b in JaxShards(sds.root).iter_batches(16, mask=mask)]
    assert len(ref) == len(xs)
    for (rx, ry), x, y in zip(ref, xs, ys):
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)


def test_reader_labels_and_gather_match_reference(corpus):
    sds, mem = corpus
    ref = JaxShards(sds.root)
    np.testing.assert_array_equal(sds.labels(), ref.labels())
    np.testing.assert_array_equal(sds.labels(), mem.y_labels)
    idx = np.random.default_rng(42).permutation(mem.x_spikes.shape[0])[:17]
    np.testing.assert_array_equal(sds.gather_rows(idx), mem.x_spikes[idx])
    np.testing.assert_array_equal(sds.gather_rows(idx), ref.gather_rows(idx))
    empty, ref_empty = sds.gather_rows(np.zeros(0, np.int64)), ref.gather_rows(np.zeros(0))
    assert empty.shape == ref_empty.shape == (0, 32, 400) and empty.dtype == ref_empty.dtype
    with pytest.raises(IndexError):
        sds.gather_rows(np.array([mem.x_spikes.shape[0]]))


def _jax_cfg():
    return PipelineConfig(frontend=FrontendConfig(n_filters=32), commands=CMDS, batch_size=16,
                          reservoir=ReservoirConfig(**RES))


def _port_preds(result, x):
    keys = tuple(tcfg.FEATURE_SETS["original"])
    f = tres.extract_features(result.reservoir, torch.as_tensor(x), keys)
    return tlog.predict(result.readout, tsc.transform(result.scaler, f)).numpy()


def _jax_preds(result, x):
    keys = tuple(tcfg.FEATURE_SETS["original"])
    f = jres.extract_features(result.params, jnp.asarray(x), keys)
    return np.asarray(jlog.predict(result.readout, jsc.transform(result.scaler, f)))


@pytest.mark.parametrize("readout", ["ridge", "logistic"])
def test_trainer_matches_reference(pcfg, corpus, readout):
    sds, mem = corpus
    port = tpipe.extract_and_train_streaming(pcfg, sds, CPU, run_diagnostics=False,
                                             readout=readout)
    ref = jpipe.extract_and_train_streaming(_jax_cfg(), JaxShards(sds.root),
                                            run_diagnostics=False, mesh=None, readout=readout)
    _, x_test, _, _ = tpipe.stratified_split(mem.x_spikes, mem.y_labels, 0.2, 42)
    agree = float((_port_preds(port, x_test) == _jax_preds(ref, x_test)).mean())
    print(f"{readout}: accuracy port {port.accuracy:.4f} jax {ref.accuracy:.4f}, "
          f"test predictions equal on {agree:.3f}")
    assert (port.n_train, port.n_test) == (ref.n_train, ref.n_test) == (48, 12)
    np.testing.assert_allclose(port.mean_weight, ref.mean_weight, rtol=1e-6)
    np.testing.assert_allclose(port.scaler.mean.numpy(), np.asarray(ref.scaler.mean),
                               rtol=1e-4, atol=1e-4)
    assert abs(port.accuracy - ref.accuracy) <= 0.02
    assert agree >= 0.95


@pytest.mark.parametrize("readout", ["ridge", "logistic"])
def test_trainer_matches_in_memory_path(pcfg, corpus, readout):
    """The port's in-memory stage 2 (extract_lsm_features) and a fit on the
    scaled matrix: ridge to the same accuracy, logistic within 0.02."""
    sds, mem = corpus
    port = tpipe.extract_and_train_streaming(pcfg, sds, CPU, run_diagnostics=False,
                                             readout=readout)
    ext = tpipe.extract_lsm_features(pcfg, mem, CPU, run_diagnostics=False)
    x_tr = torch.as_tensor(ext.artifact.x_train)
    y_tr = torch.as_tensor(ext.artifact.y_train, dtype=torch.int64)
    ref = (tlog.fit_ridge(x_tr, y_tr, len(CMDS)) if readout == "ridge"
           else tlog.fit_logistic(x_tr, y_tr, len(CMDS))[0])
    acc = float((tlog.predict(ref, torch.as_tensor(ext.artifact.x_test)).numpy()
                 == ext.artifact.y_test).mean())
    assert port.mean_weight == pytest.approx(ext.mean_weight, rel=1e-6)
    np.testing.assert_allclose(port.scaler.mean.numpy(), ext.scaler.mean.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert abs(port.accuracy - acc) <= (1e-6 if readout == "ridge" else 0.02)


def test_trainer_refusals(pcfg, corpus):
    sds, _ = corpus
    with pytest.raises(ValueError, match="ridge.*logistic"):
        tpipe.extract_and_train_streaming(pcfg, sds, CPU, run_diagnostics=False, readout="sgd")
    with pytest.raises(ValueError, match="class vocabulary"):
        tpipe.extract_and_train_streaming(pcfg, sds, CPU, run_diagnostics=False,
                                          class_names=("a", "b"))


def test_cli_bundle_loads_in_both_packages(corpus, tmp_path, capsys):
    """`cli.extract_lsm_features --streaming-fit --save-model` writes a
    bundle that lsm_tpu's load_model and the port's cli.classify read, with
    the corpus's own vocabulary and frontend."""
    from lsm_tpu.io.model import load_model as jload
    from lsm_tpu_torch.cli import classify, extract_lsm_features

    sds, mem = corpus
    model = tmp_path / "m.npz"
    extract_lsm_features.main(["--input", str(sds.root), "--streaming-fit", "--readout",
                               "logistic", "--save-model", str(model), "--num-neurons", "256",
                               "--num-output-neurons", "64", "--batch-size", "16",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Vocabulary from corpus metadata: 3 classes" in out and "Test Accuracy:" in out
    ref = jload(model)
    assert ref.class_names == CMDS and ref.frontend == FrontendConfig(n_filters=32)
    classify.main(["--model", str(model), "--input", str(sds.root), "--device", "cpu",
                   "--output", str(tmp_path / "p.npz")])
    got = np.load(tmp_path / "p.npz")
    np.testing.assert_array_equal(got["labels"], mem.y_labels)
    assert (got["predictions"] == mem.y_labels).mean() > 0.8
    with pytest.raises(SystemExit, match="sharded spike dataset directory"):
        extract_lsm_features.main(["--input", str(tmp_path / "m.npz"), "--streaming-fit",
                                   "--device", "cpu"])
