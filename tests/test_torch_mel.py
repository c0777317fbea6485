"""The mel frontend and the other gammatone methods of the port
(lsm_tpu_torch.ops.stft, ops.mel, ops.db.power_to_db, ops.gammatone's
gtgram_fft, models.frontend's dispatch, the continuous engine's mel branch)
against lsm_tpu on the CPU.

Tolerances: the copied NumPy constants bit-equal; stft_power, apply_mel and
power_to_db rtol 1e-5 (stft_power with an atol of 1e-5 of each spectrum's
peak: the two FFTs round differently, so the quietest bins differ
relatively more); gtgram_fft rtol 1e-4; spectrogram_db for mel and fft
atol 1e-3 dB. iir-xla is the exact cascade in both packages (lsm_tpu's XLA
block scan, the port's kernel B1 or its plain twin, the port's "iir"): two
float32 cascades, each within 1e-3 of float64 in amplitude, so held to
20 log10(1 + 2e-3) dB (they part by up to ~1.1e-3 relative on the hard
corpus's quiet bins, 9.8e-3 dB). featurize_batch's spikes equal lsm_tpu's but for <= 1e-3 of the
entries. The configs[0] slice (4 words, mel, 64 filters) through both
packages on the same host reservoir draw: calibrated weight rel 1e-6, the
regime equal, accuracy within 0.05. The mel continuous engine from a
converted mid-stream state: spikes equal, segment rings bit-equal on
dyadic weights, features and logits at tests/test_torch_continuous.py's
tolerances; serving-state files both ways with bit-equal continuation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lsm_tpu import pipeline as jpipe
from lsm_tpu.config import FrontendConfig, PipelineConfig
from lsm_tpu.io import dataset
from lsm_tpu.io import serving_state as jss
from lsm_tpu.models import frontend as jfront
from lsm_tpu.models.continuous import ContinuousKWS as JaxKWS
from lsm_tpu.ops import db as jdb
from lsm_tpu.ops import gammatone as jgt
from lsm_tpu.ops import mel as jmel
from lsm_tpu.ops import stft as jstft

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.io import serving_state as tss
from lsm_tpu_torch.models import frontend as tfront
from lsm_tpu_torch.models.continuous import ContinuousKWS
from lsm_tpu_torch.ops import db as tdb
from lsm_tpu_torch.ops import gammatone as tgt
from lsm_tpu_torch.ops import mel as tmel
from lsm_tpu_torch.ops import stft as tstft

from test_torch_continuous import (  # noqa: F401 (the fixture)
    HOPS, L, N_STREAMS, _assert_features_close, _fold, model,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
FS = 16000
MEL = dict(filterbank="mel", n_filters=32)
# Two float32 cascades, each within 1e-3 relative of float64 (chip_smoke.py's
# F64_REL), may part by 2e-3 in amplitude: in dB, 20 log10(1 + 2e-3).
IIR_DB = 20.0 * np.log10(1.0 + 2e-3)


@pytest.fixture(scope="module")
def wave():
    audio, _ = dataset.synthetic_audio_batch_hard(1, 4, seed=3)
    return audio


# ---- the copied NumPy constants ------------------------------------------

@pytest.mark.parametrize("n", [2048, 1024, 400, 1023])
def test_hann_window_bit_equal(n):
    a, b = tstft.hann_window(n), jstft.hann_window(n)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_fft,hop", [(2048, 160), (1023, 160), (512, 100), (401, 160)])
def test_frame_starts_bit_equal(n_fft, hop):
    """Odd n_fft included: one frame fewer than 1 + S // hop."""
    a, b = tstft._frame_starts(16000, n_fft, hop), jstft._frame_starts(16000, n_fft, hop)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    x = torch.zeros(2, 16000)
    assert tstft.frame_signal(x, n_fft, hop).shape == (2, len(a), n_fft)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (16000, 2048, 64, 0.0, None), (16000, 1024, 8, 0.0, None), (16000, 2048, 128, 20.0, 7600.0),
])
def test_mel_filterbank_bit_equal(sr, n_fft, n_mels, fmin, fmax):
    a = tmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    b = jmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    hz = np.linspace(0.0, 8000.0, 97)
    np.testing.assert_array_equal(tmel.hz_to_mel(hz), jmel.hz_to_mel(hz))
    np.testing.assert_array_equal(tmel.mel_to_hz(tmel.hz_to_mel(hz)),
                                  jmel.mel_to_hz(jmel.hz_to_mel(hz)))


@pytest.mark.parametrize("n_fft,channels", [(512, 32), (512, 128), (1024, 16)])
def test_gammatone_fft_weights_bit_equal(n_fft, channels):
    a = tgt._gammatone_fft_weights(16000.0, n_fft, channels, 50.0)
    b = jgt._gammatone_fft_weights(16000.0, n_fft, channels, 50.0)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_device_constants_are_made_once():
    dev = torch.device("cpu")
    assert tmel.filterbank_on(FS, 2048, 64, 0.0, 8000.0, dev) is \
        tmel.filterbank_on(FS, 2048, 64, 0.0, 8000.0, dev)
    assert tstft.window_on(2048, dev) is tstft.window_on(2048, dev)


# ---- the ops ---------------------------------------------------------------

@pytest.mark.parametrize("n_fft", [2048, 1023])
def test_stft_power_matches(wave, n_fft):
    ref = np.asarray(jstft.stft_power(jnp.asarray(wave), n_fft, 160))
    out = tstft.stft_power(torch.as_tensor(wave), n_fft, 160).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    peak = ref.max(axis=(-2, -1), keepdims=True)
    assert (np.abs(out - ref) <= 1e-5 * np.abs(ref) + 1e-5 * peak).all()


def test_apply_mel_and_power_to_db_match(wave):
    power = np.array(jstft.stft_power(jnp.asarray(wave), 2048, 160))
    fb = jmel.mel_filterbank(FS, 2048, 64)
    ref = np.array(jmel.apply_mel(jnp.asarray(power), fb))
    out = tmel.apply_mel(torch.as_tensor(power), torch.as_tensor(fb)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tdb.power_to_db(torch.as_tensor(ref)).numpy(),
                               np.asarray(jdb.power_to_db(jnp.asarray(ref))), rtol=1e-5, atol=0)
    top = tdb.power_to_db(torch.as_tensor(ref), top_db=40.0).numpy()
    np.testing.assert_allclose(top, np.asarray(jdb.power_to_db(jnp.asarray(ref), top_db=40.0)),
                               rtol=1e-5, atol=0)
    assert top.max() == 0.0 and top.min() == -40.0


@pytest.mark.parametrize("channels", [32, 128])
def test_gtgram_fft_matches(wave, channels):
    args = (FS, 0.025, 0.01, channels, 50.0)
    ref = np.asarray(jgt.gtgram_fft(jnp.asarray(wave), *args))
    out = tgt.gtgram_fft(torch.as_tensor(wave), *args).numpy()
    assert out.shape == ref.shape == (4, channels, 98)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=0)


@pytest.mark.parametrize("kw", [MEL, dict(filterbank="mel", n_filters=64),
                                dict(gammatone_method="fft", n_filters=32),
                                dict(gammatone_method="iir-xla", n_filters=32)],
                         ids=["mel32", "mel64", "fft", "iir-xla"])
def test_spectrogram_db_matches(wave, kw):
    ref = np.asarray(jfront.spectrogram_db(jnp.asarray(wave), FrontendConfig(**kw)))
    out = tfront.spectrogram_db(torch.as_tensor(wave), tcfg.FrontendConfig(**kw)).numpy()
    assert out.shape == ref.shape
    err = np.abs(out - ref)
    print(f"{kw}: max |d dB| {err.max():.3e}")
    if kw.get("gammatone_method") == "iir-xla":
        assert err.max() <= IIR_DB
        iir = tfront.spectrogram_db(torch.as_tensor(wave), tcfg.FrontendConfig(n_filters=32))
        assert torch.equal(torch.as_tensor(out), iir)          # one function, B1 or its twin
    else:
        assert err.max() <= 1e-3


@pytest.mark.parametrize("kw", [dict(filterbank="mel", n_filters=64),
                                dict(gammatone_method="fft", n_filters=32)], ids=["mel", "fft"])
def test_featurize_batch_spikes_match(kw):
    audio, _ = dataset.synthetic_audio_batch(4, 4, seed=11)             # 16 utterances
    ref = np.asarray(jfront.featurize_batch(jnp.asarray(audio), FrontendConfig(**kw)))
    out = tfront.featurize_batch(torch.as_tensor(audio), tcfg.FrontendConfig(**kw)).numpy()
    assert out.shape == ref.shape == (16, kw["n_filters"], 400) and out.dtype == np.uint8
    flips = int((out != ref).sum())
    print(f"{kw}: {flips} of {out.size} spike entries differ")
    assert flips <= 1e-3 * out.size
    assert out.sum() > 0


def test_mel_corpus_and_bundle_cross_packages(tmp_path):
    """A mel corpus carries the same fingerprint and metadata from either
    package (repr of FrontendConfig), so either resumes the other's shards
    and their spikes agree; a mel bundle's stored frontend reads back as
    lsm_tpu's."""
    import json

    from lsm_tpu.io.model import load_model as jload
    from lsm_tpu_torch.io import dataset as tds
    from lsm_tpu_torch.io.model import save_model
    from lsm_tpu_torch.models.reservoir import init_reservoir
    from lsm_tpu_torch.readout.logistic import LogisticReadout
    from lsm_tpu_torch.readout.scaler import Scaler

    words = ("yes", "no")
    tds.write_synthetic_corpus(tmp_path / "corpus", words, n_per_class=3, seed=4)
    jc = PipelineConfig(frontend=FrontendConfig(**MEL), commands=words, batch_size=4)
    tc = tcfg.PipelineConfig(frontend=tcfg.FrontendConfig(**MEL), commands=words, batch_size=4)
    assert repr(tc.frontend) == repr(jc.frontend)
    j = jpipe.create_spike_dataset(jc, tmp_path / "corpus", sharded_output=tmp_path / "j",
                                   shard_size=4, mesh=None)
    t = tpipe.create_spike_dataset(tc, tmp_path / "corpus", CPU, sharded_output=tmp_path / "t",
                                   shard_size=4)
    heads = [json.loads((tmp_path / d / "journal.jsonl").read_text().splitlines()[0])
             for d in ("j", "t")]
    assert heads[0] == heads[1]
    flips = int((np.asarray(j.x_spikes) != t.x_spikes).sum())
    assert flips <= 1e-3 * t.x_spikes.size, flips
    res = init_reservoir(tcfg.ReservoirConfig(num_neurons=64, num_output_neurons=16,
                                              small_world_k=8, mean_weight=0.02), 32)
    save_model(tmp_path / "m.npz", res, LogisticReadout(torch.zeros(80, 2), torch.zeros(2)),
               Scaler(torch.zeros(80), torch.ones(80)), tc.frontend, "original", words)
    assert jload(tmp_path / "m.npz").frontend == jc.frontend


# ---- the configs[0] slice ----------------------------------------------------

def test_configs0_mel_slice_beside_reference():
    """BASELINE configs[0]: 4 words, mel, 64 filters, the flagship
    reservoir, through both packages on the same corpus and host draw."""
    audio, labels = dataset.synthetic_audio_batch(12, 4, seed=42)
    kw = dict(batch_size=64, commands=("yes", "no", "up", "down"))
    jr, je = jpipe.run_pipeline_arrays(
        PipelineConfig(frontend=FrontendConfig(filterbank="mel", n_filters=64), **kw),
        audio, labels, mesh=None)
    tr, te = tpipe.run_pipeline_arrays(
        tcfg.PipelineConfig(frontend=tcfg.FrontendConfig(filterbank="mel", n_filters=64), **kw),
        audio, labels, CPU)
    print(f"configs[0] mel: accuracy port {tr.accuracy:.4f} jax {jr.accuracy:.4f}; regime "
          f"{te.diagnostics.regime} / {je.diagnostics.regime}")
    np.testing.assert_allclose(te.mean_weight, je.mean_weight, rtol=1e-6)
    assert te.diagnostics.regime == je.diagnostics.regime
    assert abs(tr.accuracy - jr.accuracy) <= 0.05
    assert te.artifact.x_train.shape == je.artifact.x_train.shape


# ---- the mel continuous engine -----------------------------------------------

def _mel_engines(model, n_streams=N_STREAMS):
    params, ro, sc, _ = model
    j = JaxKWS(params, ro, sc, FrontendConfig(**MEL), "original", n_streams)
    t = ContinuousKWS(convert.reservoir(params), convert.readout(ro), convert.scaler(sc),
                      tcfg.FrontendConfig(**MEL), "original", n_streams)
    return j, t


def test_mel_engine_state_shapes(model):
    j, t = _mel_engines(model)
    assert tuple(t.state.iir.shape) == tuple(j.state.iir.shape) == (N_STREAMS, 0, 32)
    assert tuple(t.state.tail.shape) == tuple(j.state.tail.shape) == (2048 - 160, N_STREAMS, 1)
    assert t.gtgram_two_phase is False


def test_mel_engine_matches_reference_from_converted_state(model):
    """Ten hops at 4 streams from a converted 2-hop state: the same
    spikes, bit-equal rings, features and logits at the PR's tolerances;
    the audio tail is exactly the last n_fft - hop samples."""
    j, t = _mel_engines(model)
    audio = model[3]
    for h in range(2):
        j.step(audio[:, h * L:(h + 1) * L])
    t.state = convert.continuous_state(j.state)
    flips = 0
    for h in range(2, HOPS):
        ch = audio[:, h * L:(h + 1) * L]
        sp_j = np.asarray(j._featurize(jnp.asarray(ch), j.state)[0])
        sp_t = t._featurize(torch.as_tensor(ch), t.state)[0].numpy()
        flips += int((sp_j != sp_t).sum())
        lj, lt = j.step(ch), t.step(ch)
        if flips == 0:
            for k, v in j.state.segs.items():
                np.testing.assert_array_equal(t.state.segs[k].numpy(), np.asarray(v), err_msg=k)
            _assert_features_close(t.features(), j.features(), _fold(t))
            np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-5)
        tail = t.state.tail[:, :, 0].t().numpy()
        np.testing.assert_array_equal(tail, audio[:, (h + 1) * L - (2048 - 160):(h + 1) * L])
    print(f"mel continuous: {flips} featurizer spike flips over {HOPS - 2} hops")
    assert flips == 0
    assert (t.features() != 0).mean() > 0.3


def test_mel_engine_leaves_move_and_reset(model):
    """The zero-size iir leaf through extract/install, reset and snapshot."""
    _, t = _mel_engines(model)
    audio = model[3]
    for h in range(3):
        t.step(audio[:, h * L:(h + 1) * L])
    rows = t.extract_streams([2, 0])
    assert rows["iir"].shape == (2, 0, 32) and rows["tail"].shape == (1888, 2, 1)
    _, u = _mel_engines(model)
    u.install_streams([1, 3], rows)
    ch = audio[:, 3 * L:4 * L]
    moved = ch.copy()
    moved[[1, 3]] = ch[[2, 0]]
    np.testing.assert_array_equal(u.step(moved)[[1, 3]], t.step(ch)[[2, 0]])
    t.reset([1])
    assert not t.state.tail[:, 1].any() and t.state.iir.shape == (N_STREAMS, 0, 32)
    snap = t.snapshot()
    _, w = _mel_engines(model)
    w.restore(snap)
    nxt = audio[:, 4 * L:5 * L]
    np.testing.assert_array_equal(w.step(nxt), t.step(nxt))


@pytest.mark.parametrize("writer", ["lsm_tpu", "port"])
def test_mel_serving_state_crosses_packages(model, tmp_path, writer):
    """A mel serving-state file (its zero-size iir leaf included) from one
    package loads in the other, which serves on at the continuous
    tolerances and writes the state back untouched: the writer's package
    loads that file and continues bit-equal to its uninterrupted engine."""
    audio = model[3]
    j, t = _mel_engines(model)
    own, other = (jss, tss) if writer == "lsm_tpu" else (tss, jss)
    src = j if writer == "lsm_tpu" else t
    for h in range(3):
        src.step(audio[:, h * L:(h + 1) * L])
    path, back = tmp_path / "mel_state.npz", tmp_path / "mel_back.npz"
    own.save_serving_state(path, src)
    with np.load(path) as data:
        assert data["iir"].shape == (N_STREAMS, 0, 32) and data["tail"].shape == (1888, 4, 1)
    j2, t2 = _mel_engines(model)
    dst = t2 if writer == "lsm_tpu" else j2
    assert other.load_serving_state(path, dst)["engine"] == "continuous"
    other.save_serving_state(back, dst)
    j3, t3 = _mel_engines(model)
    again = j3 if writer == "lsm_tpu" else t3
    own.load_serving_state(back, again)
    for h in range(3, 6):
        ch = audio[:, h * L:(h + 1) * L]
        ls, ld, la = src.step(ch), dst.step(ch), again.step(ch)
        np.testing.assert_array_equal(la, ls)
        np.testing.assert_allclose(ld, ls, rtol=1e-4, atol=1e-5)
