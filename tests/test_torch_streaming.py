"""The port's serving engines against lsm_tpu's on the CPU: the exact
engine StreamingKWS (dense and block-sparse reservoir) and the methods
ContinuousKWS gained with it (step_compact, step_active, stream,
steps_fused, snapshot/extract rows), plus the shared helpers (the compact
egress, wire silence, stream-index validation).

Both packages serve the same converted weights: lsm_tpu's draw at a small
width (32 filters; 256 neurons dense, 256 block-sparse with 16 filters),
dyadic with zero leak, so equal spikes in give equal statistics out, and a
random readout and scaler. Tolerances are tests/test_torch_continuous.py's:
logits rtol 1e-4 / atol 1e-5; predictions equal where the reference's
top-1/top-2 margin exceeds 1e-3; diagnostics text identical. Within the
port the serving paths are held bit-equal to plain step() calls.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsm_tpu.config import FEATURE_SETS, FrontendConfig, ReservoirConfig
from lsm_tpu.io import dataset
from lsm_tpu.io.wav import to_pcm16_wire
from lsm_tpu.models import frontend as jfront
from lsm_tpu.models import reservoir as jres
from lsm_tpu.models import sparse as jsp
from lsm_tpu.models import streaming as jstr
from lsm_tpu.models.continuous import ContinuousKWS as JaxCont
from lsm_tpu.ops import db as jdb
from lsm_tpu.ops import resample as jresample
from lsm_tpu.ops import ulaw as julaw
from lsm_tpu.readout import logistic as jlog
from lsm_tpu.readout import scaler as jsc

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch.models import frontend as tfront
from lsm_tpu_torch.models import streaming as tstr
from lsm_tpu_torch.models.continuous import ContinuousKWS
from lsm_tpu_torch.models.streaming import StreamingKWS

# Under pytest-xdist several workers share a few cores.
torch.set_num_threads(1)

N_STREAMS, HOPS, L, K = 4, 12, 1600, 4
WIRES = ("float32", "int16", "ulaw")


def _dyadic(params, name):
    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0
    return dataclasses.replace(params, **{name: q(getattr(params, name))},
                               w_in=q(params.w_in), leak=jnp.zeros_like(params.leak))


def _readout(n_outputs, seed=5):
    d = len(FEATURE_SETS["original"]) * n_outputs
    rng = np.random.default_rng(seed)
    ro = jlog.LogisticParams(w=jnp.asarray(rng.normal(0, 0.1, (d, K)).astype(np.float32)),
                             b=jnp.asarray(rng.normal(0, 0.1, K).astype(np.float32)))
    sc = jsc.ScalerState(mean=jnp.asarray(rng.random(d).astype(np.float32)),
                         scale=jnp.asarray((rng.random(d) + 0.5).astype(np.float32)))
    return ro, sc


@pytest.fixture(scope="module")
def audio():
    a, _ = dataset.synthetic_audio_batch_hard(2, N_STREAMS, seed=3)
    return a.reshape(N_STREAMS, -1)[:, :HOPS * L]


@pytest.fixture(scope="module")
def dense():
    rc = ReservoirConfig(num_neurons=256, num_output_neurons=64, small_world_k=32,
                         mean_weight=0.02, input_fanout=6)
    params = _dyadic(jres.init_reservoir(rc, n_channels=32), "w_rec")
    return (params, *_readout(64), FrontendConfig(n_filters=32))


@pytest.fixture(scope="module")
def sparse():
    rc = ReservoirConfig(num_neurons=256, num_output_neurons=64, small_world_k=52,
                         mean_weight=0.03, input_fanout=6, sparse=True)
    params = _dyadic(jsp.init_reservoir_sparse(rc, n_channels=16), "w_blocks")
    return (params, *_readout(64, seed=6), FrontendConfig(n_filters=16))


def port_modules(model):
    params, ro, sc, fcfg = model
    res = (convert.sparse_reservoir(params) if isinstance(params, jsp.SparseReservoirParams)
           else convert.reservoir(params))
    return (res, convert.readout(ro), convert.scaler(sc),
            tcfg.FrontendConfig(n_filters=fcfg.n_filters))


def engines(model, kind, n_streams=N_STREAMS):
    """(lsm_tpu engine, port engine) of `kind` ("exact"/"continuous") on
    the same weights."""
    params, ro, sc, fcfg = model
    if kind == "exact":
        return (jstr.StreamingKWS(params, ro, sc, fcfg, "original", n_streams),
                StreamingKWS(*port_modules(model), "original", n_streams))
    return (JaxCont(params, ro, sc, fcfg, "original", n_streams),
            ContinuousKWS(*port_modules(model), "original", n_streams))


def wire(x, name):
    if name == "int16":
        return to_pcm16_wire(x)
    if name == "ulaw":
        return julaw.encode_ulaw_f32(x)
    return np.asarray(x, np.float32)


def hop(audio, h, name="float32"):
    return wire(audio[:, h * L:(h + 1) * L], name)


def assert_logits_match(port, ref):
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-5)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 1e-3
    np.testing.assert_array_equal(port.argmax(-1)[sure], ref.argmax(-1)[sure])


# ---- helpers -------------------------------------------------------------

def _egress_cases():
    rng = np.random.default_rng(0)
    ties = np.array([[1.0, 1.0, 0.5, 0.0], [0.0, 2.0, 2.0, 2.0], [3.0, 3.0, 3.0, 3.0],
                     [-1.0, -1.0, -2.0, -1.0]], np.float32)
    base = rng.normal(0, 1, (6, K)).astype(np.float32)
    near = base.copy()
    top = base.argmax(-1)
    other = (top + 1) % K
    for i, gap in enumerate([0.0, 1e-7, 6e-8, 1e-5, 2.0 ** -24, 65504.0]):
        near[i, other[i]] = base[i, top[i]] - np.float32(gap)
    big = rng.normal(0, 1e3, (64, 12)).astype(np.float32)
    return [ties, near, big]


@pytest.mark.parametrize("case", range(3), ids=["ties", "near_ties", "random"])
def test_compact_egress_packs_the_reference_words(case):
    logits = _egress_cases()[case]
    ref = np.asarray(jstr.compact_output_device(jnp.asarray(logits)))
    port = tstr.compact_output_device(torch.as_tensor(logits))
    assert port.dtype == torch.int16 and ref.dtype == np.uint16
    np.testing.assert_array_equal(port.numpy().view(np.uint16), ref)
    for a, b in zip(tstr.unpack_compact_output(port), jstr.unpack_compact_output(ref)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(tstr.unpack_compact_output(port)[0], logits.argmax(-1))


@pytest.mark.parametrize("dt", [np.float32, np.int16, np.uint8])
def test_wire_silence_matches_reference(dt):
    tdt = {np.float32: torch.float32, np.int16: torch.int16, np.uint8: torch.uint8}[dt]
    assert tstr.wire_silence(dt) == tstr.wire_silence(tdt) == jstr.wire_silence(dt)
    rows = torch.as_tensor(np.arange(2 * 3).reshape(2, 3).astype(dt))
    full = tstr.expand_active_rows(rows, torch.tensor([3, 0]), 5).numpy()
    ref = np.asarray(jstr.expand_active_rows(jnp.asarray(rows.numpy()), jnp.asarray([3, 0]), 5))
    np.testing.assert_array_equal(full, ref)
    assert full.dtype == ref.dtype


def test_wire_silence_refuses_other_dtypes():
    for dt in (np.float64, np.int32):
        with pytest.raises(ValueError, match="not an ingest wire dtype"):
            tstr.wire_silence(dt)
        with pytest.raises(ValueError):
            jstr.wire_silence(dt)


BAD_IDX = [
    ([], False), (np.zeros((2, 2), np.int64), False), ([0.0, 1.0], False), ([4], False),
    ([-1], False), ([0, 0], True),
]


@pytest.mark.parametrize("idx,unique", BAD_IDX,
                         ids=["empty", "2d", "float", "high", "negative", "duplicate"])
def test_bad_stream_index_raises_as_reference(idx, unique):
    with pytest.raises(Exception) as ref:
        jstr.validate_stream_idx(idx, 4, "install_streams", unique=unique)
    with pytest.raises(type(ref.value)) as port:
        tstr.validate_stream_idx(idx, 4, "install_streams", unique=unique)
    assert str(port.value) == str(ref.value)


BAD_ACTIVE = [
    (np.zeros((2, L), np.float32), [0]),                 # rows and idx disagree
    (np.zeros((1, L), np.float32), [0.0]),               # float index
    (np.zeros((1, L + 1), np.float32), [0]),             # wrong chunk length
    (np.zeros((1, L), np.float32), [4]),                 # out of range
    (np.zeros((2, L), np.float32), [1, 1]),              # duplicate slot
    (np.zeros((1, L), np.int32), [0]),                   # no wire format
]


@pytest.mark.parametrize("kind", ["exact", "continuous"])
@pytest.mark.parametrize("case", range(len(BAD_ACTIVE)),
                         ids=["shape", "float", "length", "range", "duplicate", "dtype"])
def test_bad_step_active_raises_as_reference(dense, kind, case):
    rows, idx = BAD_ACTIVE[case]
    if kind == "exact" and case == 2:
        rows = np.zeros((1, 16001), np.float32)           # longer than the window
    j, t = engines(dense, kind)
    with pytest.raises(Exception) as ref:
        j.step_active(rows, np.asarray(idx))
    with pytest.raises(type(ref.value)):
        t.step_active(rows, np.asarray(idx))


@pytest.mark.parametrize("kind", ["exact", "continuous"])
def test_bad_row_addressing_raises_as_reference(dense, kind):
    j, t = engines(dense, kind)
    for call in (lambda e: e.extract_streams([4]), lambda e: e.extract_streams([]),
                 lambda e: e.install_streams([0, 0], e.extract_streams([1, 2])),
                 lambda e: e.install_streams([0], {})):
        with pytest.raises(Exception) as ref:
            call(j)
        with pytest.raises(type(ref.value)):
            call(t)
    if kind == "exact":
        for bad in ([4], [-1], [0.5]):
            with pytest.raises(ValueError):
                j.reset(bad)
            with pytest.raises(ValueError):
                t.reset(bad)


# ---- the exact engine against lsm_tpu's -----------------------------------

def _near_threshold(buffer, fcfg, tol=1e-4):
    """(B, F, T) True where lsm_tpu's normalized, zoomed spectrogram of
    the window lies within `tol` of an ON threshold or OFF level (as
    tests/test_torch_ops.py::test_featurize_batch_wire_formats)."""
    spec = np.asarray(jresample.zoom_time_axis(jdb.minmax_normalize(
        jfront.spectrogram_db(buffer, fcfg)), fcfg.time_bins))
    levels = np.concatenate([np.asarray(fcfg.spike_thresholds, np.float32),
                             np.asarray(fcfg.spike_thresholds, np.float32)
                             - np.float32(fcfg.hysteresis_gap)])
    return (np.abs(spec[..., None] - levels) <= tol).any(-1)


@pytest.mark.parametrize("which", ["dense", "sparse"])
@pytest.mark.parametrize("wire_name", WIRES)
def test_exact_engine_matches_reference(request, audio, which, wire_name):
    """Each hop runs the batch featurizer over the window, where the two
    packages may part by a rare spike at a near-threshold value (tolerated
    by tests/test_torch_ops.py: <= 1e-3 of the spikes, each traced to a
    value within 1e-4 of a level). Streams whose window spikes are equal
    must give the reference's logits; every flip must trace to a
    near-threshold value."""
    model = request.getfixturevalue(which)
    fcfg = model[3]
    j, t = engines(model, "exact")
    equal_rows = []
    for h in range(HOPS):
        ch = hop(audio, h, wire_name)
        lt, lj = t.step(ch), j.step(ch)
        np.testing.assert_array_equal(t.snapshot()["buffer"], np.asarray(j.buffer))
        sj = np.asarray(jfront.featurize_batch(j.buffer, fcfg))
        st = tfront.featurize_batch(t.buffer, t.fcfg).numpy()
        flips = st != sj
        assert flips.mean() <= 1e-3
        if flips.any():
            near = _near_threshold(j.buffer, fcfg)
            for b, f, col in zip(*np.nonzero(flips)):
                assert near[b, f, : col // fcfg.n_thresholds + 1].any(), (h, b, f, col)
        eq = ~flips.any(axis=(1, 2))
        equal_rows.append(eq)
        assert_logits_match(lt[eq], lj[eq])
    print(f"{which} {wire_name}: streams with equal window spikes per hop "
          f"{[int(e.sum()) for e in equal_rows]}")
    assert np.mean(equal_rows) >= 0.9
    eq = np.nonzero(equal_rows[-1])[0]
    assert t.diagnostics(eq).render() == j.diagnostics(eq).render()


def test_exact_engine_continues_from_converted_buffer(dense, audio):
    j, t = engines(dense, "exact")
    for h in range(4):
        j.step(hop(audio, h))
    t.buffer = convert.streaming_buffer(j.buffer)
    for h in range(4, 7):
        assert_logits_match(t.step(hop(audio, h)), j.step(hop(audio, h)))


@pytest.mark.parametrize("kind", ["exact", "continuous"])
def test_compact_and_active_paths_match_reference(dense, audio, kind):
    """step_compact and step_active (both egresses) against lsm_tpu's on
    the same chunks: equal predictions where the margin is sure, margins
    within float16 rounding."""
    j, t = engines(dense, kind)
    idx = np.array([2, 0])
    for h in range(4):
        ch = hop(audio, h, "int16")
        if h % 2:
            (pj, mj), (pt, mt) = j.step_compact(ch), t.step_compact(ch)
        else:
            (pj, mj), (pt, mt) = (j.step_active(ch[idx], idx, compact=True),
                                  t.step_active(ch[idx], idx, compact=True))
        sure = mj > 1e-3
        np.testing.assert_array_equal(pt[sure], pj[sure])
        np.testing.assert_allclose(mt, mj, rtol=2e-3, atol=1e-4)
    assert_logits_match(t.step_active(ch[idx], idx), j.step_active(ch[idx], idx))


# ---- the serving paths within the port ------------------------------------

def port_engine(model, kind, n_streams=N_STREAMS, **kw):
    """A port engine of `kind` alone; `kw` goes to ContinuousKWS."""
    res, ro, sc, fcfg = port_modules(model)
    if kind == "exact":
        return StreamingKWS(res, ro, sc, fcfg, "original", n_streams)
    return ContinuousKWS(res, ro, sc, fcfg, "original", n_streams, **kw)


@pytest.mark.parametrize("kind", ["exact", "continuous"])
@pytest.mark.parametrize("wire_name", WIRES)
def test_step_active_bit_equal_to_step_with_silence(dense, audio, kind, wire_name):
    a, b = port_engine(dense, kind), port_engine(dense, kind)
    idx = np.array([3, 1])
    for h in range(3):
        ch = hop(audio, h, wire_name)
        full = np.full_like(ch, tstr.wire_silence(ch.dtype))
        full[idx] = ch[idx]
        np.testing.assert_array_equal(b.step_active(ch[idx], idx), a.step(full))
    full = np.full_like(ch, tstr.wire_silence(ch.dtype))
    for x, y in zip(b.step_active(ch[:0], np.zeros(0, np.int64), compact=True),
                    a.step_compact(full)):
        np.testing.assert_array_equal(x, y)
    for k, v in a.snapshot().items():
        np.testing.assert_array_equal(b.snapshot()[k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["exact", "continuous"])
def test_step_compact_equals_argmax_of_step(dense, audio, kind):
    a, b = port_engine(dense, kind), port_engine(dense, kind)
    for h in range(3):
        logits = a.step(hop(audio, h))
        preds, margin = b.step_compact(hop(audio, h))
        np.testing.assert_array_equal(preds, logits.argmax(-1))
        top2 = np.sort(logits, axis=-1)[:, -2:]
        np.testing.assert_array_equal(
            margin, (top2[:, 1] - top2[:, 0]).astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("kind", ["exact", "continuous"])
def test_steps_fused_and_stream_equal_serial_steps(dense, audio, kind):
    a, b, c = port_engine(dense, kind), port_engine(dense, kind), port_engine(dense, kind)
    ch = hop(audio, 0, "int16")
    for _ in range(3):
        last = a.step(ch)
    assert b.steps_fused(ch, 3) == float(torch.sum(torch.as_tensor(last), dtype=torch.float32))
    for k, v in a.snapshot().items():
        np.testing.assert_array_equal(b.snapshot()[k], v, err_msg=k)
    chunks = [hop(audio, h) for h in range(1, 5)]
    serial = [a.step(x) for x in chunks]
    piped = list(c.stream([hop(audio, 0, "int16")] * 3 + chunks, depth=2))[3:]
    for x, y in zip(piped, serial):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="depth"):
        next(c.stream(chunks, depth=0))


def test_exact_reset_rows_equal_a_fresh_engine(dense, audio):
    t, fresh = port_engine(dense, "exact"), port_engine(dense, "exact")
    for h in range(3):
        t.step(hop(audio, h))
    before = t.snapshot()["buffer"]
    t.reset([1, 3])
    after = t.snapshot()["buffer"]
    np.testing.assert_array_equal(after[[1, 3]], 0.0)
    np.testing.assert_array_equal(after[[0, 2]], before[[0, 2]])
    ch = hop(audio, 3)
    np.testing.assert_array_equal(t.step(ch)[[1, 3]], fresh.step(ch)[[1, 3]])
    t.push(hop(audio, 4, "ulaw"))
    fresh.push(hop(audio, 4, "ulaw"))
    np.testing.assert_array_equal(t.logits()[[1, 3]], fresh.logits()[[1, 3]])
    t.reset()
    assert not t.snapshot()["buffer"].any()


def test_exact_swap_readout_and_refusals(dense, audio):
    t = port_engine(dense, "exact")
    t.step(hop(audio, 0))
    d = len(FEATURE_SETS["original"]) * 64
    from lsm_tpu_torch.readout.logistic import LogisticReadout

    t.swap_readout(LogisticReadout(torch.zeros(d, K), torch.arange(K, dtype=torch.float32)))
    np.testing.assert_array_equal(t.predict(), np.full(N_STREAMS, K - 1))
    with pytest.raises(ValueError, match="swap_readout w"):
        t.swap_readout(LogisticReadout(torch.zeros(d, K + 1), torch.zeros(K + 1)))
    with pytest.raises(ValueError, match="exceeds the analysis"):
        t.step(np.zeros((N_STREAMS, 16001), np.float32))
    with pytest.raises(ValueError, match="tensor chunk"):
        t.step(torch.zeros(N_STREAMS, L, dtype=torch.float64))
    res, ro, sc, _ = port_modules(dense)
    with pytest.raises(ValueError, match="unknown gammatone_method"):
        StreamingKWS(res, ro, sc, tcfg.FrontendConfig(n_filters=32, gammatone_method="iir-fast"),
                     "original", N_STREAMS).step(hop(audio, 0))
