"""Parity of the continuous engine's building blocks in the port with the JAX
reference on the CPU: the carried-state gammatone scan (kernel B3's plain
twin), the carried-state hysteresis encoder, the segment summary and its
fold, the win_counts feature form, and the carried-state LIF chunk (kernel
B4's plain twin). The same NumPy-seeded inputs go through both packages.

Tolerances: the gammatone scan's window amplitudes agree with lsm_tpu's
gtgram_iir_scan to rtol 1e-4 / atol 1e-6 (same algorithm; summation order
differs between the two packages' matmuls and fusions), the raw sub-block
energies and the Pallas chunk kernel (interpret mode) to rtol 5e-3 /
atol 1e-6; chunking the port's scan is bit-exact. Hysteresis, integer-valued statistics and the LIF chunk on
dyadic weights are bit-equal; sum_t2 and sum_isi2 of a fold are held at
rtol 1e-6 (their sums pass 2^24); features at rtol 1e-5 / atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lsm_tpu.config import FEATURE_SETS, ReservoirConfig
from lsm_tpu.models import reservoir as jres
from lsm_tpu.ops import gammatone as jgt
from lsm_tpu.ops import hysteresis as jhyst
from lsm_tpu.ops.pallas import gtgram_kernel as jgk
from lsm_tpu.ops.pallas.lif_chunk_kernel import simulate_chunk_pallas

from lsm_tpu_torch import convert
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.ops import gammatone as tgt
from lsm_tpu_torch.ops import hysteresis as thyst
from lsm_tpu_torch.ops.kernels import gtgram as kgt
from lsm_tpu_torch.ops.kernels import lif as klif

# Under pytest-xdist several workers share a few cores; torch's intra-op
# thread pools would contend (the tiny ops here run ~10x slower so).
torch.set_num_threads(1)

FS, C, FMIN, G = 16000.0, 32, 50.0, 80
THR, GAP = (0.70, 0.80, 0.90, 0.95), 0.1


@pytest.fixture(scope="module")
def chunks():
    """4 streams, 1 s of audio cut into ten 100 ms chunks, and a non-zero
    starting cascade state (a stream already running)."""
    rng = np.random.default_rng(31)
    wave = (rng.standard_normal((4, 16000)) * 0.2).astype(np.float32)
    state = (rng.standard_normal((4, 8, C)) * 1e-3).astype(np.float32)
    return wave, state


def _window_amplitudes(e):
    """sqrt(window energy / nwin) of (n_sub, B, C) sub-block energies, as
    the engines read them (5 sub-blocks a window, 2 a hop)."""
    span = (e.shape[0] - 5) // 2 * 2 + 1
    return np.sqrt(sum(e[j:j + span:2] for j in range(5)) / 400.0)


def test_gtgram_iir_scan_matches_reference(chunks):
    """The window amplitudes the engine reads agree at rtol 1e-4 / atol 1e-6
    (test_torch_ops.py's gtgram_iir tolerance). A single sub-block's energy
    in the lowest channel, nearest the unit circle, sits ~1e-3 from a
    float64 run of the same scan in either package, so the raw energies
    are held at the kernel class's rtol 5e-3. The state passes through
    zero: atol 1e-5 against magnitudes up to ~0.4."""
    wave, state = chunks
    blocks = wave.reshape(4, 200, G).transpose(1, 0, 2).copy()
    s_ref, e_ref = jgt.gtgram_iir_scan(jnp.asarray(blocks), jnp.asarray(state), FS, C, FMIN, G)
    s_out, e_out = tgt.gtgram_iir_scan(torch.as_tensor(blocks), torch.as_tensor(state),
                                       FS, C, FMIN, G)
    assert e_out.shape == (200, 4, C) and s_out.shape == (4, 8, C)
    e_ref = np.asarray(e_ref)
    np.testing.assert_allclose(_window_amplitudes(e_out.numpy()), _window_amplitudes(e_ref),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(e_out.numpy(), e_ref, rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(s_out.numpy(), np.asarray(s_ref), rtol=1e-4, atol=1e-5)


def test_gtgram_chunks_bit_equal_to_whole_signal(chunks):
    wave, state = chunks
    w, st = torch.as_tensor(wave), torch.as_tensor(state)
    s_full, e_full = tgt.gtgram_chunk(w, st, FS, C, FMIN, G)
    parts = []
    for c in range(10):
        st, e = tgt.gtgram_chunk(w[:, c * 1600:(c + 1) * 1600], st, FS, C, FMIN, G)
        parts.append(e)
    assert torch.equal(torch.cat(parts), e_full)
    assert torch.equal(st, s_full)
    # B1's twin is the zero-state case, in the same (n_sub, B, C) layout.
    fb = tgt.filterbank(FS, C, FMIN, G, torch.device("cpu"))
    zero = tgt.gtgram_chunk(w, torch.zeros(4, 8, C), FS, C, FMIN, G)[1]
    assert torch.equal(kgt.sub_energy_plain(w, fb), zero)


def test_gtgram_chunk_plain_matches_pallas_interpret(chunks):
    wave, state = chunks
    st_j, st_t = jnp.asarray(state), torch.as_tensor(state)
    for c in range(2):
        ch = wave[:, c * 1600:(c + 1) * 1600]
        with pltpu.force_tpu_interpret_mode():
            st_j, e_j = jgk.gtgram_chunk_two_phase(jnp.asarray(ch), st_j, FS, C, FMIN, G)
        st_t, e_t = tgt.gtgram_chunk(torch.as_tensor(ch), st_t, FS, C, FMIN, G)
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=5e-3, atol=1e-6)
        np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=5e-3, atol=1e-6)


def test_gtgram_chunk_wrapper_cpu_and_validation(chunks):
    wave, state = chunks
    w, st = torch.as_tensor(wave[:, :1600].copy()), torch.as_tensor(state)
    fb = tgt.filterbank(FS, C, FMIN, G, torch.device("cpu"))
    before = kgt.chunk_launches
    s_out, e = kgt.chunk(w, fb, st)
    assert kgt.chunk_launches == before                 # plain twin: no launch
    assert e.shape == (20, 4, C) and s_out.shape == (4, 8, C)
    with pytest.raises(TypeError):
        kgt.chunk(w, fb, st.double())
    with pytest.raises(ValueError, match="cascade state"):
        kgt.chunk(w, fb, st[:, :, :16].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kgt.chunk(w, fb, st.transpose(0, 2).contiguous().transpose(0, 2))


@pytest.mark.parametrize("layout", ["contiguous", "engine"])
def test_hysteresis_step_chained_bit_equal(layout):
    """Chained 10-bin chunks against lsm_tpu and one whole-signal call; the
    "engine" layout hands each chunk over as the continuous engine does, the
    (B, F, T) view of a contiguous (T, B, F) tensor."""
    rng = np.random.default_rng(8)
    spec = rng.random((3, 16, 100)).astype(np.float32)
    levels = np.asarray(THR, np.float32)
    spec[0, 0, ::2] = np.resize(np.concatenate([levels, levels - np.float32(GAP)]), 50)
    whole = thyst.hysteresis_encode(torch.as_tensor(spec), THR, GAP).numpy()
    st_j = jnp.zeros((3, 4, 16), bool)
    st_t = torch.zeros(3, 4, 16, dtype=torch.bool)
    outs = []
    for s in range(0, 100, 10):
        chunk = torch.as_tensor(spec[..., s:s + 10])
        if layout == "engine":
            chunk = chunk.permute(2, 0, 1).contiguous().permute(1, 2, 0)
            assert not chunk.is_contiguous()
        sp_j, st_j = jhyst.hysteresis_encode_step(jnp.asarray(spec[..., s:s + 10]), st_j, THR, GAP)
        sp_t, st_t = thyst.hysteresis_encode_step(chunk, st_t, THR, GAP)
        np.testing.assert_array_equal(sp_t.numpy(), np.asarray(sp_j))
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
        outs.append(sp_t.numpy())
    np.testing.assert_array_equal(np.concatenate(outs, axis=-1), whole)


@pytest.fixture(scope="module")
def raster():
    """10 segments of 40 steps, one fully silent, one neuron silent
    throughout."""
    rng = np.random.default_rng(12)
    r = rng.random((3, 400, 24)) < 0.06
    r[:, 120:160] = False
    r[:, :, 5] = False
    return r


def test_segment_summary_bit_equal(raster):
    seg = raster[:, 40:80]
    ref = jres.segment_summary(jnp.asarray(seg), 5)
    out = tres.segment_summary(torch.as_tensor(seg), 5)
    assert set(out) == set(ref) == set(klif.SEG_KEYS)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_fold_segment_stats_matches_reference(raster):
    segs_j = [jres.segment_summary(jnp.asarray(raster[:, k * 40:(k + 1) * 40]), 5)
              for k in range(10)]
    segs = {k: np.stack([np.asarray(s[k]) for s in segs_j]) for k in segs_j[0]}
    ref = jres.fold_segment_stats({k: jnp.asarray(v) for k, v in segs.items()}, 40, 5)
    whole = jres.stats_from_raster(jnp.asarray(raster), n_win=10, burst_isi_max=5)
    out = tres.fold_segment_stats({k: torch.as_tensor(v) for k, v in segs.items()}, 40, 5)
    for k in ref:
        got = out[k].numpy()
        np.testing.assert_array_equal(got, np.asarray(ref[k]), err_msg=k)
        if k in ("sum_t2", "sum_isi2"):
            np.testing.assert_allclose(got, np.asarray(whole[k]), rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got, np.asarray(whole[k]), err_msg=k)
    assert np.isinf(out["first"].numpy()[:, 5]).all() and (out["last"].numpy()[:, 5] == -1).all()


def test_features_from_win_counts_match(raster):
    whole = {k: np.array(v) for k, v in
             jres.stats_from_raster(jnp.asarray(raster), n_win=10, burst_isi_max=5).items()}
    keys = tuple(FEATURE_SETS["all"])
    ref = np.asarray(jres.features_from_stats({k: jnp.asarray(v) for k, v in whole.items()}, keys))
    out = tres.features_from_stats({k: torch.as_tensor(v) for k, v in whole.items()}, keys).numpy()
    assert out.shape == (3, 8 * 24)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


CHUNK_CFG = ReservoirConfig(num_neurons=256, num_output_neurons=64, small_world_k=32,
                            mean_weight=0.05, input_fanout=6)


def _dyadic(params):
    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0
    return dataclasses.replace(params, w_rec=q(params.w_rec), w_in=q(params.w_in),
                               leak=jnp.zeros_like(params.leak))


def _xla_chunk(params, spikes, v, refrac, s_prev, win_len, n_new_win):
    """lsm_tpu's XLA chunk path, as tests/test_continuous.py writes it out."""
    no = params.n_outputs
    xs_t = jnp.moveaxis(jnp.asarray(spikes).astype(jnp.float32), -1, 0)
    w_rec = params.w_rec.astype(jnp.bfloat16)
    w_in = params.w_in.astype(jnp.bfloat16)

    def step(carry, x_t):
        vv, rr, ss = carry
        drive = (jnp.dot(ss.astype(jnp.bfloat16), w_rec, preferred_element_type=jnp.float32)
                 + jnp.dot(x_t.astype(jnp.bfloat16), w_in, preferred_element_type=jnp.float32))
        vv, rr, spike = jres.lif_update(vv, rr, drive, 1.0 - params.leak,
                                        params.threshold, params.refractory)
        return (vv, rr, spike.astype(jnp.float32)), spike[:, :no]

    (v, refrac, s_prev), out = jax.lax.scan(step, (v, refrac, s_prev), xs_t)
    out = out.transpose(1, 0, 2)
    seg = jres.segment_summary(out, params.burst_isi_max)
    b = out.shape[0]
    win = out.astype(jnp.float32).reshape(b, n_new_win, win_len, no).sum(axis=2)
    return v, refrac, s_prev, seg, win


@pytest.mark.parametrize("n_new_win", [1, 2])
def test_lif_chunk_plain_bit_equal_over_chained_chunks(n_new_win):
    """Three chained chunks (state threaded, the carried spike vector driving
    each chunk's first step) through B4's plain twin, lsm_tpu's Pallas chunk
    kernel (interpret mode) and its XLA chunk scan."""
    params = _dyadic(jres.init_reservoir(CHUNK_CFG, n_channels=32))
    port = convert.reservoir(params)
    B, win_len = 3, 40
    T_c = win_len * n_new_win
    n_pad = params.w_rec.shape[0]
    rng = np.random.default_rng(40 + n_new_win)
    z = np.zeros((B, n_pad), np.float32)
    vk, rk, sk = jnp.asarray(z), jnp.asarray(z), jnp.asarray(z)      # Pallas: refrac f32
    vx, rx, sx = jnp.asarray(z), jnp.zeros((B, n_pad), jnp.int32), jnp.asarray(z)
    vt, rt, st = torch.zeros(B, n_pad), torch.zeros(B, n_pad, dtype=torch.int32), torch.zeros(B, n_pad)
    fired = 0
    for c in range(3):
        spikes = (rng.random((B, params.w_in.shape[0], T_c)) < 0.15).astype(np.uint8)
        with pltpu.force_tpu_interpret_mode():
            vk, rk, sk, seg_k, win_k = simulate_chunk_pallas(
                params, jnp.asarray(spikes), vk, rk, sk, win_len, n_new_win)
        vx, rx, sx, seg_x, win_x = _xla_chunk(params, spikes, vx, rx, sx, win_len, n_new_win)
        carried = st.clone()
        vt, rt, st, seg_t, win_t = tres.simulate_chunk(port, torch.as_tensor(spikes),
                                                       vt, rt, st, win_len, n_new_win)
        assert rt.dtype == torch.int32 and win_t.shape == (B, n_new_win, 64)
        for ref in ((vk, rk, sk), (vx, rx, sx)):
            np.testing.assert_array_equal(vt.numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(rt.numpy(), np.asarray(ref[1]).astype(np.int32))
            np.testing.assert_array_equal(st.numpy(), np.asarray(ref[2]))
        for k in klif.SEG_KEYS:
            np.testing.assert_array_equal(seg_t[k].numpy(), np.asarray(seg_k[k]), err_msg=f"{c}:{k}")
            np.testing.assert_array_equal(seg_t[k].numpy(), np.asarray(seg_x[k]), err_msg=f"{c}:{k}")
        np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_k))
        np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_x))
        fired += int(carried.sum())
    assert fired > 0                     # the carried spike vector was exercised


def test_lif_chunk_wrapper_cpu_and_validation():
    r = tres.init_reservoir(CHUNK_CFG, n_channels=32)
    ops, kw = r.kernel_operands()
    del kw["n_win"]
    x = torch.zeros(2, 32, 40, dtype=torch.uint8)
    v, s = torch.zeros(2, 256), torch.zeros(2, 256)
    refrac = torch.zeros(2, 256, dtype=torch.int32)
    before = klif.chunk_launches
    v2, r2, s2, seg, win = klif.lif_chunk(x, *ops, v, refrac, s, **kw, win_len=40, n_new_win=1)
    assert klif.chunk_launches == before                 # plain twin: no launch
    assert seg.shape == (9, 2, 64) and win.shape == (2, 1, 64)
    assert not seg[0].any() and torch.isinf(seg[3]).all() and (seg[4] == -1).all()
    with pytest.raises(TypeError):
        klif.lif_chunk(x, *ops, v, refrac.float(), s, **kw, win_len=40, n_new_win=1)
    with pytest.raises(ValueError):
        klif.lif_chunk(x, *ops, v[:, :128], refrac, s, **kw, win_len=40, n_new_win=1)
    with pytest.raises(ValueError, match="windows"):
        klif.lif_chunk(x, *ops, v, refrac, s, **kw, win_len=30, n_new_win=1)
