"""The port's continuous engine (lsm_tpu_torch.models.continuous) against
lsm_tpu's ContinuousKWS on the CPU: the same converted reservoir, readout
and scaler, the same chunks on all three wires (f32, int16, mu-law), 12
hops of 4 streams at a small config (32 filters, 256 neurons, 64 outputs).

The reservoir's weights are dyadic with zero leak (tests/test_reservoir.py's
recipe), so equal spikes in give equal spikes out and the segment rings
must be bit-equal. Tolerances: spikes from the featurizer are equal at this
seed (the mismatch fraction is printed); features rtol 1e-5 / atol 1e-6,
except the two variance features, mean(x^2) - mean(x)^2, whose subtraction
the reference's fused XLA epilogue may contract into an FMA: they are held
to 8 float32 ulps of the second moment they cancel from, plus atol 1e-6
(ROADMAP Queue C lists that difference as no fault; the measured worst is
about 2 ulps), and the sample variance (n - 1) planted in place of the
population variance must fail that limit; logits rtol 1e-4 / atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lsm_tpu.config import FEATURE_SETS, FrontendConfig, ReservoirConfig
from lsm_tpu.io import dataset
from lsm_tpu.io.wav import to_pcm16_wire
from lsm_tpu.models import reservoir as jres
from lsm_tpu.models.continuous import ContinuousKWS as JaxKWS
from lsm_tpu.models.continuous import fit_continuous_readout as jax_fit
from lsm_tpu.models.streaming import decode_pcm_device as jax_decode
from lsm_tpu.ops import ulaw as julaw
from lsm_tpu.readout import logistic as jlog
from lsm_tpu.readout import scaler as jsc

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.models.continuous import ContinuousKWS, fit_continuous_readout
from lsm_tpu_torch.models.streaming import decode_pcm_device
from lsm_tpu_torch.readout import logistic as tlog
from lsm_tpu_torch.readout import scaler as tsc

# Under pytest-xdist several workers share a few cores; torch's intra-op
# thread pools would contend (the tiny ops here run ~10x slower so).
torch.set_num_threads(1)

N_STREAMS, HOPS, L, K = 4, 12, 1600, 4
FCFG = FrontendConfig(n_filters=32)
RCFG = ReservoirConfig(num_neurons=256, num_output_neurons=64, small_world_k=32,
                       mean_weight=0.02, input_fanout=6)
D = len(FEATURE_SETS["original"]) * RCFG.num_output_neurons
VAR_KEYS = ("spike_variances", "isi_variances")
VAR_ULPS = 8


def _dyadic(params):
    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0
    return dataclasses.replace(params, w_rec=q(params.w_rec), w_in=q(params.w_in),
                               leak=jnp.zeros_like(params.leak))


@pytest.fixture(scope="module")
def model():
    params = _dyadic(jres.init_reservoir(RCFG, n_channels=FCFG.n_filters))
    rng = np.random.default_rng(5)
    ro = jlog.LogisticParams(w=jnp.asarray(rng.normal(0, 0.1, (D, K)).astype(np.float32)),
                             b=jnp.asarray(rng.normal(0, 0.1, K).astype(np.float32)))
    sc = jsc.ScalerState(mean=jnp.asarray(rng.random(D).astype(np.float32)),
                         scale=jnp.asarray((rng.random(D) + 0.5).astype(np.float32)))
    audio, _ = dataset.synthetic_audio_batch_hard(2, N_STREAMS, seed=3)
    return params, ro, sc, audio.reshape(N_STREAMS, -1)[:, :HOPS * L]


def _engines(model, n_streams=N_STREAMS):
    params, ro, sc, _ = model
    j = JaxKWS(params, ro, sc, FCFG, "original", n_streams)
    t = ContinuousKWS(convert.reservoir(params), convert.readout(ro), convert.scaler(sc),
                      tcfg.FrontendConfig(n_filters=FCFG.n_filters), "original", n_streams)
    return j, t


def _wire(audio, wire):
    if wire == "int16":
        return to_pcm16_wire(audio)
    if wire == "ulaw":
        return julaw.encode_ulaw_f32(audio)
    return audio


def _fold(kws):
    """The port engine's folded window statistics (for tolerances)."""
    stats = tres.fold_segment_stats(kws.state.segs, kws._t_c, kws.reservoir.burst_isi_max)
    stats["win_counts"] = kws.state.win_ring
    return stats


def _moments(stats):
    """Per variance feature: the second moment it cancels from, and the
    number of samples n it averages over."""
    return {
        "spike_variances": (torch.mean(stats["win_counts"] ** 2, dim=-1).numpy(),
                            np.full(stats["n_isi"].shape, stats["win_counts"].shape[-1], np.float32)),
        "isi_variances": ((stats["sum_isi2"] / torch.clamp(stats["n_isi"], min=1.0)).numpy(),
                          stats["n_isi"].numpy()),
    }


def _var_within(a, b, second):
    return np.abs(a - b) <= 1e-6 + VAR_ULPS * np.finfo(np.float32).eps * second


def _column(x, i):
    no = RCFG.num_output_neurons
    return x[:, i * no:(i + 1) * no]


def _assert_features_close(port, ref, stats):
    """rtol 1e-5 / atol 1e-6; the variance features within VAR_ULPS ulps of
    the second moment they cancel from."""
    moments = _moments(stats)
    for i, k in enumerate(FEATURE_SETS["original"]):
        a, b = _column(port, i), _column(ref, i)
        if k in VAR_KEYS:
            assert _var_within(a, b, moments[k][0]).all(), (k, np.abs(a - b).max())
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)


def _assert_sample_variance_fails(port, ref, stats):
    """A planted fault: the sample variance (n - 1) in place of the
    population variance must fall outside the variance limit."""
    moments = _moments(stats)
    for i, k in enumerate(FEATURE_SETS["original"]):
        if k in VAR_KEYS:
            second, n = moments[k]
            planted = _column(port, i) * n / np.maximum(n - 1.0, 1.0)
            assert not _var_within(planted, _column(ref, i), second).all(), k


@pytest.fixture(scope="module", params=["float32", "int16", "ulaw"])
def run(request, model):
    """Both engines over the same 12 hops of one wire format; per hop the
    featurizer's spikes, the segment rings, features, logits and stats."""
    j, t = _engines(model)
    chunks = _wire(model[3], request.param)
    hops = []
    for h in range(HOPS):
        ch = chunks[:, h * L:(h + 1) * L]
        sp_j = np.asarray(j._featurize(jax_decode(jnp.asarray(ch)), j.state)[0])
        sp_t = t._featurize(decode_pcm_device(torch.as_tensor(ch)), t.state)[0].numpy()
        lj, lt = j.step(ch), t.step(ch)
        hops.append(dict(
            spikes=(sp_j, sp_t), logits=(lj, lt), features=(j.features(), t.features()),
            segs=({k: np.asarray(v) for k, v in j.state.segs.items()},
                  {k: v.numpy() for k, v in t.state.segs.items()}),
            win_ring=(np.asarray(j.state.win_ring), t.state.win_ring.numpy()),
            stats=_fold(t),
        ))
    return request.param, j, t, hops


def test_featurizer_spikes_equal(run):
    wire, _, _, hops = run
    mism = [float((h["spikes"][0] != h["spikes"][1]).mean()) for h in hops]
    print(f"{wire}: spike mismatch fraction per hop {mism}")
    assert sum(int(h["spikes"][1].sum()) for h in hops) > 0
    for h in hops:
        np.testing.assert_array_equal(h["spikes"][1], h["spikes"][0])


def test_segment_rings_bit_equal(run):
    _, _, _, hops = run
    for h in hops:
        ref, port = h["segs"]
        for k in ref:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(h["win_ring"][1], h["win_ring"][0])


def test_features_and_logits_match(run):
    _, _, _, hops = run
    for h in hops:
        _assert_features_close(h["features"][1], h["features"][0], h["stats"])
        np.testing.assert_allclose(h["logits"][1], h["logits"][0], rtol=1e-4, atol=1e-5)
    assert (hops[-1]["features"][1] != 0).mean() > 0.3        # the reservoir is live
    _assert_sample_variance_fails(hops[-1]["features"][1], hops[-1]["features"][0],
                                  hops[-1]["stats"])


def test_diagnostics_text_identical(run):
    _, j, t, _ = run
    assert t.diagnostics().render() == j.diagnostics().render()
    assert t.diagnostics([1, 3]).render() == j.diagnostics([1, 3]).render()


def test_start_from_converted_mid_stream_state(model):
    """Both engines continue from one JAX mid-stream state, converted."""
    j, t = _engines(model)
    audio = model[3]
    for h in range(7):
        j.step(audio[:, h * L:(h + 1) * L])
    t.state = convert.continuous_state(j.state)
    assert t.state.refrac.dtype == torch.int32 and t.state.hyst.dtype == torch.bool
    for h in range(7, HOPS):
        ch = audio[:, h * L:(h + 1) * L]
        lj, lt = j.step(ch), t.step(ch)
        for k, v in j.state.segs.items():
            np.testing.assert_array_equal(t.state.segs[k].numpy(), np.asarray(v), err_msg=k)
        _assert_features_close(t.features(), j.features(), _fold(t))
        np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-5)


def _leaves(st):
    d = {k: getattr(st, k) for k in ("iir", "hyst", "norm_hi", "norm_lo", "v", "refrac",
                                     "s_prev", "win_ring")}
    d["tail"] = st.tail.transpose(0, 1)
    d.update({f"seg:{k}": v.transpose(0, 1) for k, v in st.segs.items()})
    return d                                  # every leaf with streams on axis 0


def test_reset_rows_equal_a_fresh_engine(model):
    _, t = _engines(model)
    audio = model[3]
    for h in range(5):
        t.step(audio[:, h * L:(h + 1) * L])
    before = _leaves(t.state)
    t.reset([1, 3])
    fresh = _leaves(_engines(model)[1].state)
    after = _leaves(t.state)
    for k in after:
        assert torch.equal(after[k][[1, 3]], fresh[k][[1, 3]]), k
        assert torch.equal(after[k][[0, 2]], before[k][[0, 2]]), k
    # A reset stream then evolves exactly as a fresh one on the same audio.
    ch = audio[:, 5 * L:6 * L]
    fresh_engine = _engines(model)[1]
    np.testing.assert_array_equal(t.step(ch)[[1, 3]], fresh_engine.step(ch)[[1, 3]])
    t.reset(np.array([True, False, False, False]))
    assert torch.equal(_leaves(t.state)["v"][0], fresh["v"][0])
    t.reset()
    for k, v in _leaves(t.state).items():
        assert torch.equal(v, fresh[k]), k
    with pytest.raises(ValueError, match="bool mask"):
        t.reset(np.ones(3, bool))


def _objective64(w, b, x, y):
    z = x.astype(np.float64) @ np.asarray(w, np.float64) + np.asarray(b, np.float64)
    z -= z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return -logp[np.arange(len(y)), y].mean() + 0.5 * np.sum(np.asarray(w, np.float64) ** 2) / len(y)


def test_fit_continuous_readout_matches_reference(model):
    """Same calibration protocol (fixed-seed carry-in permutation, features
    at each utterance's last hop): the same scaler, an objective no worse
    than the reference's and the same predictions; not iteration counts."""
    params = model[0]
    audio, labels = dataset.synthetic_audio_batch_hard(6, K, seed=11)
    ro_j, sc_j = jax_fit(params, FCFG, audio, labels, K)
    ro_t, sc_t = fit_continuous_readout(convert.reservoir(params),
                                        tcfg.FrontendConfig(n_filters=32), audio, labels, K)
    np.testing.assert_allclose(sc_t.mean.numpy(), np.asarray(sc_j.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sc_t.scale.numpy(), np.asarray(sc_j.scale), rtol=1e-4, atol=1e-6)
    # Both readouts judged on the same (reference-scaled) features.
    j = JaxKWS(params, ro_j, sc_j, FCFG, "original", len(labels))
    prev = audio[np.random.default_rng(12345).permutation(len(labels))]
    for src in (prev, audio):
        for c in range(10):
            j.step(src[:, c * L:(c + 1) * L])
    xs = np.asarray(jsc.transform(sc_j, jnp.asarray(j.features())))
    f_j = _objective64(ro_j.w, ro_j.b, xs, labels)
    f_t = _objective64(ro_t.w.numpy(), ro_t.b.numpy(), xs, labels)
    print(f"objective jax {f_j:.8f} port {f_t:.8f}")
    assert f_t <= f_j * (1 + 1e-4)
    p_j = np.asarray(jlog.predict(ro_j, jnp.asarray(xs)))
    p_t = tlog.predict(ro_t, torch.as_tensor(xs.copy())).numpy()
    assert (p_j == p_t).mean() >= 0.98


def test_swap_readout(model):
    """The next hop after a swap goes through the new readout; stream state
    is untouched by the swap."""
    _, t = _engines(model)
    audio = model[3]
    t.step(audio[:, :L])
    v_before = t.state.v.clone()
    new = tlog.LogisticReadout(torch.ones(D, K), torch.arange(K, dtype=torch.float32))
    t.swap_readout(new)
    assert torch.equal(t.state.v, v_before)
    logits = t.step(audio[:, L:2 * L])
    feats = torch.as_tensor(t.features())
    want = (tsc.transform(t.scaler_state, feats) @ new.w + new.b).numpy()
    np.testing.assert_allclose(logits, want, rtol=1e-6)
    with pytest.raises(ValueError, match="swap_readout w"):
        t.swap_readout(tlog.LogisticReadout(torch.ones(D, K + 1), torch.zeros(K + 1)))


@pytest.mark.parametrize("chunk_len,n_rate_windows", [
    (1000, 10),          # not a multiple of the 160-sample hop
    (4800, 10),          # 120 steps do not divide the 400-step window
    (160, 10),           # 4 steps do not span a 40-step rate window
    (1600, 7),           # 7 rate windows do not divide 400 steps
])
def test_bad_geometry_raises_as_reference(model, chunk_len, n_rate_windows):
    params, ro, sc, _ = model
    params = dataclasses.replace(params, n_rate_windows=n_rate_windows)
    with pytest.raises(ValueError) as ref:
        JaxKWS(params, ro, sc, FCFG, "original", 2, chunk_len=chunk_len)
    with pytest.raises(ValueError) as port:
        ContinuousKWS(convert.reservoir(params), convert.readout(ro), convert.scaler(sc),
                      tcfg.FrontendConfig(n_filters=32), "original", 2, chunk_len=chunk_len)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("chunk,exc", [
    (np.zeros((N_STREAMS, L), np.int32), TypeError),
    (np.zeros((N_STREAMS, L - 1), np.float32), ValueError),
    (np.zeros((N_STREAMS + 1, L), np.float32), ValueError),
])
def test_bad_wire_raises_as_reference(model, chunk, exc):
    j, t = _engines(model)
    with pytest.raises(exc) as ref:
        j.step(chunk)
    with pytest.raises(exc) as port:
        t.step(chunk)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="tensor chunk"):
        t.step(torch.zeros(N_STREAMS, L, dtype=torch.float64))


def test_unported_options_raise(model):
    params, ro, sc, _ = model
    args = (convert.reservoir(params), convert.readout(ro), convert.scaler(sc))
    with pytest.raises(ValueError, match="must be <= n_fft"):
        ContinuousKWS(*args, tcfg.FrontendConfig(n_filters=32, filterbank="mel", n_fft=128))
    with pytest.raises(ValueError, match="unknown filterbank"):
        ContinuousKWS(*args, tcfg.FrontendConfig(filterbank="bark"))
    with pytest.raises(TypeError, match="Reservoir or SparseReservoir"):
        ContinuousKWS(params, *args[1:], tcfg.FrontendConfig(n_filters=32))
