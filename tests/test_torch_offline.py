"""Offline inference end to end against lsm_tpu on the CPU: a WAV corpus
(Speech Commands layout, one corrupt file) through both packages'
create_spike_dataset, in memory and sharded, then a bundle trained and
saved by lsm_tpu, loaded by the port and used by its
classify_spikes_streaming over an in-memory source and over shards.

Tolerances: spikes differ between the packages at a fraction <= 1e-3, and
every flip traces to a value within 1e-4 of a threshold (the rule of
tests/test_torch_ops.py); within the port every route is bit-equal. Logits
at rtol 1e-4 / atol 1e-5; predictions equal lsm_tpu's on every row whose
top-two logit margin in lsm_tpu exceeds 1e-3."""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsm_tpu import pipeline as jpipe
from lsm_tpu.config import FEATURE_SETS, FrontendConfig, PipelineConfig, ReservoirConfig
from lsm_tpu.io import artifacts as jart
from lsm_tpu.io import model as jmodel
from lsm_tpu.io import wav as jwav
from lsm_tpu.models import frontend as jfront
from lsm_tpu.models import reservoir as jres
from lsm_tpu.ops import db as jdb
from lsm_tpu.ops import resample as jresample
from lsm_tpu.readout import logistic as jlog
from lsm_tpu.readout import scaler as jscaler

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.io import dataset as tds
from lsm_tpu_torch.io import sharded as tsh
from lsm_tpu_torch.io import wav as twav
from lsm_tpu_torch.io.model import load_model
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.readout import logistic as tlog

torch.set_num_threads(1)

CPU = torch.device("cpu")
COMMANDS = ("a", "b", "c", "d")
KEYS = tuple(FEATURE_SETS["original"])
FLIP_MAX, MARGIN = 1e-3, 1e-3


def _cfgs():
    """The same config in both packages (tests/test_offline_inference.py's)."""
    kw = dict(commands=COMMANDS, batch_size=16)
    res = dict(num_neurons=192, num_output_neurons=96, small_world_k=38, input_fanout=6)
    return (PipelineConfig(frontend=FrontendConfig(n_filters=32),
                           reservoir=ReservoirConfig(**res), **kw),
            tcfg.PipelineConfig(frontend=tcfg.FrontendConfig(n_filters=32),
                                reservoir=tcfg.ReservoirConfig(**res), **kw))


class _Source:
    def __init__(self, ds):
        self.ds = ds

    def iter_batches(self, batch_size):
        x, y = self.ds.x_spikes, self.ds.y_labels
        for s in range(0, len(y), batch_size):
            yield jart.SpikeDataset(x[s:s + batch_size], y[s:s + batch_size])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline")
    corpus = root / "corpus"
    tds.write_synthetic_corpus(corpus, COMMANDS, n_per_class=12, seed=11)
    (corpus / "b" / "00003_bad.wav").write_bytes(b"RIFF garbage")
    jcfg, tcfg_ = _cfgs()
    out = dict(root=root, corpus=corpus, jcfg=jcfg, tcfg=tcfg_)
    out["j_ds"] = jpipe.create_spike_dataset(jcfg, corpus, mesh=None)
    jpipe.create_spike_dataset(jcfg, corpus, sharded_output=root / "j_sh", shard_size=13,
                               mesh=None)
    out["t_ds"] = tpipe.create_spike_dataset(tcfg_, corpus, CPU)
    out["t_sh"] = tpipe.create_spike_dataset(tcfg_, corpus, CPU, sharded_output=root / "t_sh",
                                             shard_size=13)

    # lsm_tpu trains on its own spikes and saves the bundle.
    ext = jpipe.extract_lsm_features(jcfg, out["j_ds"], run_diagnostics=False, mesh=None)
    result = jpipe.train_and_evaluate(jcfg, ext.artifact, mesh=None)
    jmodel.save_model(root / "m.npz", ext.params, result.params, ext.scaler, jcfg.frontend,
                      jcfg.feature_set, jcfg.commands)
    spikes = jnp.asarray(out["j_ds"].x_spikes)
    out["j_logits"] = np.asarray(jlog.predict_logits(result.params, jscaler.transform(
        ext.scaler, jres.extract_features(ext.params, spikes, KEYS))))
    out["j_preds"], _ = jpipe.classify_spikes_streaming(
        jcfg, _Source(out["j_ds"]), ext.params, result.params, ext.scaler, mesh=None)
    return out


def _near_levels(values, cfg, tol=1e-4):
    levels = np.concatenate([np.asarray(cfg.spike_thresholds, np.float32),
                             np.asarray(cfg.spike_thresholds, np.float32)
                             - np.float32(cfg.hysteresis_gap)])
    return (np.abs(values[..., None] - levels) <= tol).any(-1)


def test_spikes_match_the_reference_and_skip_the_corrupt_file(run):
    t, j, jcfg = run["t_ds"], run["j_ds"], run["jcfg"]
    assert t.x_spikes.shape == j.x_spikes.shape == (48, 32, 400)
    assert t.x_spikes.dtype == np.uint8
    np.testing.assert_array_equal(t.y_labels, j.y_labels)
    np.testing.assert_array_equal(t.y_labels, np.repeat(np.arange(4), 12))
    flips = t.x_spikes != j.x_spikes
    print(f"spike mismatch fraction {flips.mean():.2e}")
    assert flips.mean() <= FLIP_MAX
    if flips.any():
        files = [p for p in sorted(run["corpus"].rglob("*.wav")) if "bad" not in p.name]
        audio = jwav.load_audio_batch(files, 16000, 1.0, use_native=False)[0]
        spec = np.asarray(jresample.zoom_time_axis(jdb.minmax_normalize(
            jfront.spectrogram_db(jnp.asarray(audio), jcfg.frontend)), jcfg.frontend.time_bins))
        near = _near_levels(spec, jcfg.frontend)
        for b, f, col in zip(*np.nonzero(flips)):
            assert near[b, f, : col // jcfg.frontend.n_thresholds + 1].any(), (b, f, col)


@pytest.mark.parametrize("wire", ["int16", "ulaw"])
def test_create_spike_dataset_equals_featurize_audio_array(run, wire):
    """Within the port the WAV route is bit-equal to featurizing the same
    decoded audio: int16 against float32 audio (exact for PCM16 files),
    mu-law against its own wire."""
    import dataclasses

    cfg = dataclasses.replace(run["tcfg"], audio_wire=wire)
    ds = run["t_ds"] if wire == "int16" else tpipe.create_spike_dataset(cfg, run["corpus"], CPU)
    files = tds.index_speech_commands(run["corpus"], COMMANDS).files
    audio, kept, errors = twav.load_audio_batch(files, 16000, 1.0,
                                                dtype="float32" if wire == "int16" else wire)
    assert len(kept) == 48 and [p.name for p, _ in errors] == ["00003_bad.wav"]
    np.testing.assert_array_equal(ds.x_spikes, tpipe.featurize_audio_array(cfg, audio, CPU))


def test_sharded_route_equals_in_memory_and_the_reference_shards(run):
    root, t = run["root"], run["t_ds"]
    for d in ("t_sh", "j_sh"):
        for ds in (tpipe.load_spike_dataset_any(root / d), tsh.ShardedSpikeDataset(root / d)):
            if d == "t_sh":
                np.testing.assert_array_equal(ds.x_spikes, t.x_spikes)
            else:
                np.testing.assert_array_equal(ds.x_spikes, run["j_ds"].x_spikes)
            np.testing.assert_array_equal(ds.y_labels, t.y_labels)
    assert run["t_sh"].meta == json.loads(json.dumps(tcfg.corpus_meta(run["tcfg"])))
    assert [len(s.y_labels) for s in run["t_sh"].iter_shards()] == [13, 13, 13, 9]
    # The same fingerprint and metadata in both journal headers.
    headers = [json.loads((root / d / "journal.jsonl").read_text().splitlines()[0])
               for d in ("t_sh", "j_sh")]
    assert headers[0] == headers[1] and len(headers[0]["header"]["fingerprint"]) == 64


def test_port_resumes_reference_shards_without_recompute(run, tmp_path):
    """lsm_tpu's finished shards carry the port's fingerprint for the same
    corpus and config, so the port's rerun keeps every one of them."""
    d = tmp_path / "sh"
    shutil.copytree(run["root"] / "j_sh", d)
    (d / "manifest.json").unlink()
    before = {p.name: p.stat().st_mtime_ns for p in d.glob("shard_*.npz")}
    ds = tpipe.create_spike_dataset(run["tcfg"], run["corpus"], CPU, sharded_output=d,
                                    shard_size=13)
    assert {p.name: p.stat().st_mtime_ns for p in d.glob("shard_*.npz")} == before
    np.testing.assert_array_equal(ds.x_spikes, run["j_ds"].x_spikes)


def test_interrupted_port_run_resumes_without_recompute(run, tmp_path, monkeypatch):
    out = tmp_path / "sh"
    calls = {"n": 0}
    append = tsh.ShardedSpikeDatasetWriter.append

    def bomb(self, *a, **k):
        if calls["n"] >= 2:
            raise KeyboardInterrupt("simulated kill")
        calls["n"] += 1
        return append(self, *a, **k)

    monkeypatch.setattr(tsh.ShardedSpikeDatasetWriter, "append", bomb)
    with pytest.raises(KeyboardInterrupt):
        tpipe.create_spike_dataset(run["tcfg"], run["corpus"], CPU, sharded_output=out,
                                   shard_size=13)
    monkeypatch.setattr(tsh.ShardedSpikeDatasetWriter, "append", append)
    pre = {p.name: p.stat().st_mtime_ns for p in out.glob("shard_*.npz")}
    assert len(pre) == 2
    ds = tpipe.create_spike_dataset(run["tcfg"], run["corpus"], CPU, sharded_output=out,
                                    shard_size=13)
    post = {p.name: p.stat().st_mtime_ns for p in out.glob("shard_*.npz")}
    assert all(post[k] == v for k, v in pre.items()) and len(post) == 4
    np.testing.assert_array_equal(ds.x_spikes, run["t_ds"].x_spikes)
    np.testing.assert_array_equal(ds.y_labels, run["t_ds"].y_labels)


def test_reference_bundle_classifies_in_the_port(run):
    bundle = load_model(run["root"] / "m.npz", CPU)
    cfg = tcfg.PipelineConfig(frontend=bundle.frontend, feature_set=bundle.feature_set,
                              commands=bundle.class_names, batch_size=16)
    j_ds = run["j_ds"]
    feats = tres.extract_features(bundle.reservoir, torch.as_tensor(j_ds.x_spikes), KEYS)
    logits = bundle.readout(bundle.scaler(feats)).numpy()
    np.testing.assert_allclose(logits, run["j_logits"], rtol=1e-4, atol=1e-5)

    top2 = np.sort(run["j_logits"], -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > MARGIN
    assert sure.sum() >= 40, sure.sum()
    for source in (tpipe.InMemorySource(j_ds), tsh.ShardedSpikeDataset(run["root"] / "j_sh")):
        preds, labels = tpipe.classify_spikes_streaming(cfg, source, bundle.reservoir,
                                                        bundle.readout, bundle.scaler, CPU)
        assert preds.dtype == labels.dtype == np.int32
        np.testing.assert_array_equal(labels, j_ds.y_labels)
        np.testing.assert_array_equal(preds[sure], run["j_preds"][sure])
        np.testing.assert_array_equal(preds, logits.argmax(-1))


def test_classify_unpacks_to_the_same_spikes(run):
    """T a multiple of 8 travels bit-packed, other T as it is: either way
    the predictions of the direct path."""
    bundle = load_model(run["root"] / "m.npz", CPU)
    cfg = tcfg.PipelineConfig(feature_set=bundle.feature_set, batch_size=10)
    x = run["t_ds"].x_spikes
    for t in (400, 396):
        ds = tpipe.artifacts.SpikeDataset(np.ascontiguousarray(x[..., :t]), run["t_ds"].y_labels)
        preds, _ = tpipe.classify_spikes_streaming(cfg, tpipe.InMemorySource(ds),
                                                   bundle.reservoir, bundle.readout,
                                                   bundle.scaler, CPU)
        feats = tres.extract_features(bundle.reservoir, torch.as_tensor(ds.x_spikes), KEYS)
        direct = tlog.predict(bundle.readout, bundle.scaler(feats)).numpy()
        np.testing.assert_array_equal(preds, direct)
    packed = torch.as_tensor(np.packbits(x, axis=-1, bitorder="little"))
    assert torch.equal(tpipe.unpack_spike_bits(packed), torch.as_tensor(x))
