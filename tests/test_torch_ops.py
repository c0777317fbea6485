"""Parity of the port's ops (lsm_tpu_torch.ops, models.frontend) with the
JAX reference on the CPU: the same NumPy-seeded inputs through both.

Tolerances: integer ops, hysteresis and the host constants are bit-equal;
float elementwise ops agree to rtol 1e-6 (one f32 rounding); the plain
gammatone scan agrees with lsm_tpu's gtgram_iir to rtol 1e-4 / atol 1e-6
(the same algorithm, matmul summation order differs between the two BLAS
libraries; the lowest channel sits nearest the unit circle) and with the
Pallas kernel (interpret mode) to its own rtol 5e-3 / atol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lsm_tpu.config import FrontendConfig
from lsm_tpu.io import dataset
from lsm_tpu.io.wav import to_pcm16_wire
from lsm_tpu.models import frontend as jfront
from lsm_tpu.ops import db as jdb
from lsm_tpu.ops import gammatone as jgt
from lsm_tpu.ops import hysteresis as jhyst
from lsm_tpu.ops import resample as jres
from lsm_tpu.ops import ulaw as julaw
from lsm_tpu.ops.pallas import gtgram_kernel as jgk

from lsm_tpu_torch.models import frontend as tfront
from lsm_tpu_torch.ops import db as tdb
from lsm_tpu_torch.ops import gammatone as tgt
from lsm_tpu_torch.ops import hysteresis as thyst
from lsm_tpu_torch.ops import resample as tres
from lsm_tpu_torch.ops import ulaw as tulaw
from lsm_tpu_torch.ops.kernels import gtgram as kgt
from lsm_tpu_torch.ops.kernels import hysteresis as khyst

# Under pytest-xdist several workers share a few cores; torch's intra-op
# thread pools would contend (the tiny ops here run ~10x slower so).
torch.set_num_threads(1)

FS, WIN, HOP, C, FMIN = 16000.0, 0.025, 0.01, 128, 50.0


@pytest.fixture(scope="module")
def wave():
    return (np.random.default_rng(11).standard_normal((4, 16000)) * 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def jax_gtgram(wave):
    """The JAX side, computed once per module: gtgram_iir and the Pallas
    kernel path in interpret mode."""
    ref = np.asarray(jgt.gtgram_iir(jnp.asarray(wave), FS, WIN, HOP, C, FMIN))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jgk.gtgram_pallas(jnp.asarray(wave), FS, WIN, HOP, C, FMIN))
    return ref, pallas


def test_ulaw_decode_bit_equal():
    codes = np.arange(256, dtype=np.uint8)
    ref = np.asarray(julaw.decode_ulaw_device(jnp.asarray(codes)))
    out = tulaw.decode_ulaw(torch.as_tensor(codes)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("scale", [1e-4, 1.0, 300.0])
def test_db_floor_and_minmax(scale):
    rng = np.random.default_rng(3)
    amp = (rng.random((3, 16, 98)) * scale).astype(np.float32)
    amp[0, :, :5] = 0.0                                     # hits the floor
    ref_db = np.asarray(jdb.amplitude_to_db_floor(jnp.asarray(amp)))
    out_db = tdb.amplitude_to_db_floor(torch.as_tensor(amp)).numpy()
    np.testing.assert_allclose(out_db, ref_db, rtol=1e-6, atol=0)
    spec = np.concatenate([ref_db, np.full((1, 16, 98), 5.0, np.float32)])  # + degenerate
    ref_n = np.asarray(jdb.minmax_normalize(jnp.asarray(spec)))
    out_n = tdb.minmax_normalize(torch.as_tensor(spec)).numpy()
    np.testing.assert_allclose(out_n, ref_n, rtol=1e-6, atol=0)
    assert not out_n[-1].any()


@pytest.mark.parametrize("sizes", [(98, 100), (100, 100), (37, 100), (200, 64)])
def test_lerp_plan_and_zoom(sizes):
    n_in, n_out = sizes
    for a, b in zip(tres.lerp_plan(n_in, n_out), jres._lerp_plan(n_in, n_out)):
        np.testing.assert_array_equal(a, b)
    spec = np.random.default_rng(5).random((2, 8, n_in)).astype(np.float32)
    ref = np.asarray(jres.zoom_time_axis(jnp.asarray(spec), n_out))
    out = tres.zoom_time_axis(torch.as_tensor(spec), n_out).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_hysteresis_bit_equal():
    cfg = FrontendConfig()
    rng = np.random.default_rng(7)
    spec = rng.random((3, 16, 100)).astype(np.float32)
    # Values exactly on the ON thresholds and OFF levels (f32 threshold minus
    # f32 gap), where an off-by-one comparison or a wrongly typed level shows.
    levels = np.asarray(cfg.spike_thresholds, np.float32)
    edges = np.concatenate([levels, levels - np.float32(cfg.hysteresis_gap)])
    spec[0, 0, ::2] = np.resize(edges, 50)
    ref = np.asarray(jhyst.hysteresis_encode(
        jnp.asarray(spec), cfg.spike_thresholds, cfg.hysteresis_gap))
    before = khyst.launches
    out = thyst.hysteresis_encode(
        torch.as_tensor(spec), cfg.spike_thresholds, cfg.hysteresis_gap).numpy()
    assert khyst.launches == before                  # CPU tensors take the plain twin
    assert out.dtype == np.uint8 and out.shape == (3, 16, 400)
    np.testing.assert_array_equal(out, ref)
    # The batch entry's all-off start is an explicit all-False state.
    off = torch.zeros(3, len(cfg.spike_thresholds), 16, dtype=torch.bool)
    step, _ = thyst.hysteresis_encode_step(torch.as_tensor(spec), off, cfg.spike_thresholds,
                                           cfg.hysteresis_gap)
    np.testing.assert_array_equal(step.numpy(), out)
    np.testing.assert_array_equal(
        out[1], jhyst.hysteresis_encode_reference(spec[1], cfg.spike_thresholds,
                                                  cfg.hysteresis_gap))


@pytest.mark.parametrize("case", ["33 thresholds", "float64", "int state", "state shape",
                                  "state device", "2-d"])
def test_hysteresis_encoder_refuses(case):
    """What the kernel cannot take is refused before any launch, on every
    device, so the refusals show on CPU tensors too."""
    spec, state = torch.rand(2, 8, 10), torch.zeros(2, 4, 8, dtype=torch.bool)
    on, off = thyst.levels((0.7, 0.8, 0.9, 0.95), 0.1)
    error, match = ValueError, None
    if case == "33 thresholds":
        on, off = thyst.levels(np.linspace(0.1, 0.9, 33), 0.05)
        state, match = None, "1 to 32 thresholds"
    elif case == "float64":
        spec, error, match = spec.double(), TypeError, "float32"
    elif case == "int state":
        state, error, match = state.to(torch.uint8), TypeError, "bool"
    elif case == "state shape":
        state, match = state[:, :3], "trigger state"
    elif case == "state device":
        state, match = state.to("meta"), "trigger state on meta"
    else:
        spec, state, match = spec[0], None, "not \\(B, F, T\\)"
    before = khyst.launches
    with pytest.raises(error, match=match):
        khyst.encode(spec, state, on, off)
    assert khyst.launches == before


def test_gammatone_constants_equal():
    for a, b in zip(tgt.make_erb_coeffs(FS, C, FMIN), jgt.make_erb_coeffs(FS, C, FMIN)):
        np.testing.assert_array_equal(a, b)
    assert tgt.gtgram_strides(FS, WIN, HOP, 16000) == jgt.gtgram_strides(FS, WIN, HOP, 16000)
    for a, b in zip(tgt._block_iir_matrices(FS, C, FMIN, 80),
                    jgt._block_iir_matrices(FS, C, FMIN, 80)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tgt._quadratic_matrices(FS, 32, FMIN, 80),
                    jgt._quadratic_matrices(FS, 32, FMIN, 80)):
        np.testing.assert_array_equal(a, b)


def test_block_system_layout():
    """Kernel B1's single (g+8, g+8) system holds the four block matrices."""
    m_yx, m_sy, m_xs, m_ss = tgt._block_iir_matrices(FS, 4, FMIN, 80)
    k = tgt.block_system(FS, 4, FMIN, 80)
    x = np.random.default_rng(2).standard_normal(80)
    s = np.random.default_rng(3).standard_normal(8)
    z = np.concatenate([x, s])
    for c in range(4):
        np.testing.assert_allclose(k[c, :80] @ z, x @ m_yx[c] + s @ m_sy[c], rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(k[c, 80:] @ z, x @ m_xs[c] + s @ m_ss[c], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("g", [40, 80])
def test_cascade_coeffs_describe_the_block_form_filter(g):
    """Kernel B1/B3's operand, the delta-operator TDF2 coefficients, comes
    from lsm_tpu's make_erb_coeffs with the gain^(1/4) split; run in float64
    on basis vectors, with the TDF2 state converted in (w2 = s1 + s2) and out
    (s2 = w2 - w1) as the kernel converts it, it reproduces the block-form
    matrices: the kernel's operand and the twin's describe one filter."""
    co = jgt.make_erb_coeffs(FS, C, FMIN)
    g4 = co.gain ** 0.25
    n0, n1 = co.a0 / g4, np.stack([co.a1[k] / g4 for k in range(4)])
    q = tgt.cascade_coeffs(FS, C, FMIN)
    assert q.shape == (C, 11) and q.dtype == np.float64
    np.testing.assert_array_equal(q[:, 0], n0)
    np.testing.assert_array_equal(q[:, 1], 2.0 + co.b1)
    np.testing.assert_array_equal(q[:, 2], 1.0 + co.b1 + co.b2)
    np.testing.assert_array_equal(q[:, 3:7], (2.0 * n0 + n1).T)
    np.testing.assert_array_equal(q[:, 7:11], (n0 + n1).T)

    # Basis runs: g input impulses, then the 8 unit TDF2 states.
    nb = g + 8
    x = np.zeros((nb, g))
    x[:g] = np.eye(g)
    s = np.zeros((C, nb, 8))
    s[:, g:] = np.eye(8)
    w1 = s[..., 0::2].copy()                                # (C, nb, 4)
    w2 = s[..., 0::2] + s[..., 1::2]
    y_out = np.zeros((C, nb, g))
    for t in range(g):
        xt = np.broadcast_to(x[:, t], (C, nb))
        for k in range(4):
            y = q[:, 0, None] * xt + w1[..., k]
            w1[..., k] += q[:, 3 + k, None] * xt - q[:, 1, None] * y + w2[..., k]
            w2[..., k] += q[:, 7 + k, None] * xt - q[:, 2, None] * y
            xt = y
        y_out[..., t] = xt
    s_out = np.zeros((C, nb, 8))
    s_out[..., 0::2], s_out[..., 1::2] = w1, w2 - w1
    got = (y_out[:, :g], y_out[:, g:], s_out[:, :g], s_out[:, g:])
    for a, ref, ref32 in zip(got, tgt._block_iir_matrices64(FS, C, FMIN, g),
                             jgt._block_iir_matrices(FS, C, FMIN, g)):
        scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
        assert np.abs(a - ref).max() <= 1e-10 * scale.max()
        assert (np.abs(a - ref) <= 1e-10 * scale).all()
        np.testing.assert_array_equal(ref.astype(np.float32), ref32)


def test_block_system_tensor_is_made_once():
    """The kernels' and twins' operands are made once per device and
    geometry: the hot path copies nothing to the card."""
    dev = torch.device("cpu")
    fb = tgt.filterbank(FS, 4, FMIN, 80, dev)
    assert tgt.filterbank(FS, 4, FMIN, 80, dev) is fb
    np.testing.assert_array_equal(fb.kmat.numpy(), tgt.block_system(FS, 4, FMIN, 80))
    np.testing.assert_array_equal(fb.coeffs.numpy(),
                                  tgt.cascade_coeffs(FS, 4, FMIN).astype(np.float32))
    assert fb.g == 80


def test_plain_gtgram_matches_gtgram_iir(wave, jax_gtgram):
    ref, _ = jax_gtgram
    out = tgt.gtgram_iir(torch.as_tensor(wave), FS, WIN, HOP, C, FMIN).numpy()
    assert out.shape == ref.shape == (4, C, 98)
    rel = np.abs(out - ref) / np.abs(ref)
    print(f"plain gtgram vs gtgram_iir: p99 rel err {np.quantile(rel, 0.99):.3e}")
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


def test_plain_gtgram_matches_pallas_interpret(wave, jax_gtgram):
    _, pallas = jax_gtgram
    out = tgt.gtgram_iir(torch.as_tensor(wave), FS, WIN, HOP, C, FMIN).numpy()
    np.testing.assert_allclose(out, pallas, rtol=5e-3, atol=1e-6)


def test_sub_energy_wrapper_cpu_takes_plain_twin(wave):
    """On CPU tensors the wrapper runs the plain twin and counts no launch;
    malformed operands raise before any dispatch."""
    fb = tgt.filterbank(FS, 8, FMIN, 80, torch.device("cpu"))
    x = torch.as_tensor(wave)
    before = kgt.launches
    out = kgt.sub_energy(x, fb)
    assert kgt.launches == before
    assert torch.equal(out, kgt.sub_energy_plain(x, fb))
    assert out.shape == (200, 4, 8)
    with pytest.raises(TypeError):
        kgt.sub_energy(x.double(), fb)
    with pytest.raises(ValueError):
        kgt.sub_energy(x[:, :1000], fb)                     # not a multiple of g
    with pytest.raises(ValueError):
        kgt.sub_energy(x[:, :0], fb)                        # no sub-block


def _near_levels(values, cfg, tol=1e-4):
    levels = np.concatenate([
        np.asarray(cfg.spike_thresholds, np.float32),
        np.asarray(cfg.spike_thresholds, np.float32) - np.float32(cfg.hysteresis_gap),
    ])
    return (np.abs(values[..., None] - levels) <= tol).any(-1)


@pytest.mark.parametrize("wire", ["float32", "int16", "ulaw"])
def test_featurize_batch_wire_formats(wire):
    cfg = FrontendConfig()
    audio, _ = dataset.synthetic_audio_batch_hard(1, 6, seed=3)
    if wire == "int16":
        audio = to_pcm16_wire(audio)
    elif wire == "ulaw":
        audio = julaw.encode_ulaw_f32(audio)
    ref = np.asarray(jfront.featurize_batch(jnp.asarray(audio), cfg))
    out = tfront.featurize_batch(torch.as_tensor(audio), cfg).numpy()
    assert out.dtype == np.uint8 and out.shape == ref.shape == (6, 128, 400)
    flips = out != ref
    frac = flips.mean()
    print(f"{wire}: spike mismatch fraction {frac:.2e}")
    assert frac <= 1e-3
    if flips.any():
        # Every flip must trace back to a near-threshold value: a trigger row
        # (b, f, threshold) whose first flip at bin t has some value within
        # 1e-4 of an ON threshold or OFF level at or before t.
        spec_j = np.asarray(jres.zoom_time_axis(jdb.minmax_normalize(
            jfront.spectrogram_db(_as_f32(audio), cfg)), cfg.time_bins))
        near = _near_levels(spec_j, cfg)                        # (B, F, T)
        n_thr = cfg.n_thresholds
        for b, f, col in zip(*np.nonzero(flips)):
            t = col // n_thr
            assert near[b, f, : t + 1].any(), (wire, b, f, t)


def _as_f32(audio):
    if audio.dtype == np.uint8:
        return julaw.decode_ulaw_device(jnp.asarray(audio))
    if audio.dtype == np.int16:
        return jnp.asarray(audio).astype(jnp.float32) / 32768.0
    return jnp.asarray(audio)


def test_unported_frontends_raise():
    """Every frontend of lsm_tpu is ported (tests/test_torch_mel.py); a
    filterbank or gammatone method lsm_tpu does not have raises as there."""
    audio = torch.zeros(1, 16000)
    for cfg, what in ((FrontendConfig(filterbank="bark"), "filterbank"),
                      (FrontendConfig(gammatone_method="iir-fast"), "gammatone_method")):
        with pytest.raises(ValueError, match=f"unknown {what}"):
            tfront.featurize_batch(audio, cfg)
    with pytest.raises(TypeError):
        tfront.featurize_batch(torch.zeros(1, 16000, dtype=torch.int32), FrontendConfig())
