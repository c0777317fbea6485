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
    out = thyst.hysteresis_encode(
        torch.as_tensor(spec), cfg.spike_thresholds, cfg.hysteresis_gap).numpy()
    assert out.dtype == np.uint8 and out.shape == (3, 16, 400)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out[1], jhyst.hysteresis_encode_reference(spec[1], cfg.spike_thresholds,
                                                  cfg.hysteresis_gap))


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


def test_block_system_tensor_is_made_once():
    dev = torch.device("cpu")
    k = tgt.block_system_tensor(FS, 4, FMIN, 80, dev)
    assert tgt.block_system_tensor(FS, 4, FMIN, 80, dev) is k
    np.testing.assert_array_equal(k.numpy(), tgt.block_system(FS, 4, FMIN, 80))


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
    kmat = torch.as_tensor(tgt.block_system(FS, 8, FMIN, 80))
    x = torch.as_tensor(wave)
    before = kgt.launches
    out = kgt.sub_energy(x, kmat)
    assert kgt.launches == before
    assert torch.equal(out, kgt.sub_energy_plain(x, kmat))
    assert out.shape == (200, 8, 4)
    with pytest.raises(TypeError):
        kgt.sub_energy(x.double(), kmat)
    with pytest.raises(ValueError):
        kgt.sub_energy(x[:, :1000], kmat)                   # not a multiple of g


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
    audio = torch.zeros(1, 16000)
    for cfg in (FrontendConfig(filterbank="mel"), FrontendConfig(gammatone_method="fft")):
        with pytest.raises(NotImplementedError, match="A8"):
            tfront.featurize_batch(audio, cfg)
    with pytest.raises(TypeError):
        tfront.featurize_batch(torch.zeros(1, 16000, dtype=torch.int32), FrontendConfig())
