"""The block-sparse reservoir in the port's continuous engine against
lsm_tpu on the CPU: kernel B6's plain twin over chained chunks, and
ContinuousKWS serving a SparseReservoir.

Weights are lsm_tpu's sparse draw carried across with
`convert.sparse_reservoir`, dyadic with zero leak, so equal spikes in give
equal spikes out: the carried state (v, refrac, s_prev), the segment fields
and the window counts are held bit-equal. Features and logits keep the
tolerances of tests/test_torch_continuous.py: rtol 1e-5 / atol 1e-6, the two
variance features within 8 float32 ulps of the second moment they cancel
from (plus atol 1e-6), logits rtol 1e-4 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lsm_tpu.config import FEATURE_SETS, FrontendConfig, ReservoirConfig
from lsm_tpu.io import dataset
from lsm_tpu.models import reservoir as jres
from lsm_tpu.models import sparse as jsp
from lsm_tpu.models.continuous import ContinuousKWS as JaxKWS
from lsm_tpu.ops.pallas.sparse_lif_chunk_kernel import simulate_chunk_sparse_pallas
from lsm_tpu.readout import logistic as jlog
from lsm_tpu.readout import scaler as jsc

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.models import sparse as tsp
from lsm_tpu_torch.models.continuous import ContinuousKWS, fit_continuous_readout
from lsm_tpu_torch.ops.kernels import sparse_lif as ksp

# Under pytest-xdist several workers share a few cores; torch's intra-op
# thread pools would contend (the tiny ops here run ~10x slower so).
torch.set_num_threads(1)

N, NO, C, K, L, STREAMS, HOPS = 256, 64, 16, 4, 1600, 3, 3
RCFG = ReservoirConfig(num_neurons=N, num_output_neurons=NO, small_world_k=52,
                       mean_weight=0.03, input_fanout=6, sparse=True)
FCFG = FrontendConfig(n_filters=C)
D = len(FEATURE_SETS["original"]) * NO
VAR_KEYS = ("spike_variances", "isi_variances")


def _dyadic(params):
    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0
    return dataclasses.replace(params, w_blocks=q(params.w_blocks), w_in=q(params.w_in),
                               leak=jnp.zeros_like(params.leak))


@pytest.fixture(scope="module")
def params():
    return _dyadic(jsp.init_reservoir_sparse(RCFG, n_channels=C))


def _xla_chunk(p, spikes, v, refrac, s_prev, win_len, n_new_win):
    """lsm_tpu's XLA sparse chunk scan (tests/test_continuous.py:206-281)."""
    wb = p.w_blocks.astype(jnp.bfloat16)
    w_in = p.w_in.astype(jnp.bfloat16)
    no = p.n_outputs

    def step(carry, x_t):
        vv, rr, ss = carry
        drive = jsp.sparse_drive(ss, wb, p.src_idx, jnp.bfloat16) + jnp.dot(
            x_t.astype(jnp.bfloat16), w_in, preferred_element_type=jnp.float32)
        vv, rr, spike = jres.lif_update(vv, rr, drive, 1.0 - p.leak, p.threshold,
                                        p.refractory)
        return (vv, rr, spike.astype(jnp.float32)), spike[:, :no]

    xs_t = jnp.moveaxis(jnp.asarray(spikes, jnp.float32), -1, 0)
    (v, refrac, s_prev), out = jax.lax.scan(step, (v, refrac, s_prev), xs_t)
    out = out.transpose(1, 0, 2)
    seg = jres.segment_summary(out, p.burst_isi_max)
    win = out.astype(jnp.float32).reshape(out.shape[0], n_new_win, win_len, no).sum(axis=2)
    return v, refrac, s_prev, seg, win


@pytest.mark.parametrize("n_new_win", [1, 2])
def test_chunk_twin_bit_equal_to_pallas_and_xla(params, n_new_win):
    """Three chained chunks from the carried state: v, refrac, s_prev, the
    nine segment fields and the window counts bit-equal to the Pallas chunk
    kernel (interpret mode) and to the XLA scan."""
    win_len, B = 40, 3
    T = win_len * n_new_win
    sr = convert.sparse_reservoir(params)
    ops, kw = sr.kernel_operands()
    del kw["n_win"]
    c_pad = params.w_in.shape[0]
    rng = np.random.default_rng(n_new_win)
    zeros = np.zeros((B, N), np.float32)
    st_p = (jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(zeros))   # refrac as f32
    st_x = (jnp.asarray(zeros), jnp.asarray(zeros, jnp.int32), jnp.asarray(zeros))
    st_t = (torch.zeros(B, N), torch.zeros(B, N, dtype=torch.int32), torch.zeros(B, N))
    carried = 0.0
    for c in range(3):
        spikes = (rng.random((B, c_pad, T)) < 0.15).astype(np.uint8)
        carried += float(st_t[2].sum())
        with pltpu.force_tpu_interpret_mode():
            *st_p, seg_p, win_p = simulate_chunk_sparse_pallas(
                params, jnp.asarray(spikes), *st_p, win_len, n_new_win, b_tile=128)
        *st_x, seg_x, win_x = _xla_chunk(params, spikes, *st_x, win_len, n_new_win)
        *st_t, seg_t, win_t = ksp.sparse_lif_chunk(
            torch.as_tensor(spikes[:, :C].copy()), *ops, *st_t, **kw, win_len=win_len,
            n_new_win=n_new_win)
        for name, a, p, x in zip(("v", "refrac", "s_prev"), st_t, st_p, st_x):
            np.testing.assert_array_equal(a.numpy(), np.asarray(x), err_msg=f"{c}:{name}")
            np.testing.assert_array_equal(a.numpy().astype(np.float32), np.asarray(p),
                                          err_msg=f"{c}:{name}")
        for i, k in enumerate(ksp.SEG_KEYS):
            np.testing.assert_array_equal(seg_t[i].numpy(), np.asarray(seg_x[k]), err_msg=k)
            np.testing.assert_array_equal(seg_t[i].numpy(), np.asarray(seg_p[k]), err_msg=k)
        np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_x))
        np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_p))
    assert carried > 0                     # the carried spike vector was exercised


def _readout():
    rng = np.random.default_rng(5)
    ro = jlog.LogisticParams(w=jnp.asarray(rng.normal(0, 0.1, (D, K)).astype(np.float32)),
                             b=jnp.asarray(rng.normal(0, 0.1, K).astype(np.float32)))
    sc = jsc.ScalerState(mean=jnp.asarray(rng.random(D).astype(np.float32)),
                         scale=jnp.asarray((rng.random(D) + 0.5).astype(np.float32)))
    return ro, sc


def _audio(seed=3):
    audio, _ = dataset.synthetic_audio_batch_hard(1, STREAMS, seed=seed)
    return audio


def _assert_features_close(port, ref, kws):
    """rtol 1e-5 / atol 1e-6; the variance features within 8 ulps of the
    second moment they cancel from."""
    stats = tres.fold_segment_stats(kws.state.segs, kws._t_c, kws.reservoir.burst_isi_max)
    second = {
        "spike_variances": torch.mean(kws.state.win_ring ** 2, dim=-1).numpy(),
        "isi_variances": (stats["sum_isi2"] / torch.clamp(stats["n_isi"], min=1.0)).numpy(),
    }
    for i, k in enumerate(FEATURE_SETS["original"]):
        a, b = port[:, i * NO:(i + 1) * NO], ref[:, i * NO:(i + 1) * NO]
        if k in VAR_KEYS:
            lim = 1e-6 + 8 * np.finfo(np.float32).eps * second[k]
            assert (np.abs(a - b) <= lim).all(), (k, np.abs(a - b).max())
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)


def test_engine_matches_reference_on_sparse_weights(params):
    ro, sc = _readout()
    j = JaxKWS(params, ro, sc, FCFG, "original", STREAMS)
    t = ContinuousKWS(convert.sparse_reservoir(params), convert.readout(ro),
                      convert.scaler(sc), tcfg.FrontendConfig(n_filters=C), "original", STREAMS)
    assert t.state.v.shape == (STREAMS, N) and t.state.refrac.dtype == torch.int32
    audio = _audio()
    for h in range(HOPS):
        ch = audio[:, h * L:(h + 1) * L]
        lj, lt = j.step(ch), t.step(ch)
        for k in ("v", "refrac", "s_prev"):
            np.testing.assert_array_equal(getattr(t.state, k).numpy(),
                                          np.asarray(getattr(j.state, k)), err_msg=k)
        for k, v in j.state.segs.items():
            np.testing.assert_array_equal(t.state.segs[k].numpy(), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(t.state.win_ring.numpy(), np.asarray(j.state.win_ring))
        _assert_features_close(t.features(), j.features(), t)
        np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-5)
    assert float(t.state.segs["counts"].sum()) > 0
    assert t.diagnostics().render() == j.diagnostics().render()


def test_sparse_engine_equals_dense_engine_on_densify(params):
    """Inside the port: the sparse engine (B6's twin) and the dense engine
    (B4's twin) on densify() give the same logits, features and state
    (tests/test_continuous.py:576-616)."""
    ro, sc = _readout()
    sr = convert.sparse_reservoir(params)
    args = (convert.readout(ro), convert.scaler(sc), tcfg.FrontendConfig(n_filters=C))
    ks = ContinuousKWS(sr, *args, n_streams=2)
    kd = ContinuousKWS(tsp.densify(sr), *args, n_streams=2)
    rng = np.random.default_rng(7)
    for _ in range(3):
        chunk = (rng.standard_normal((2, L)) * 0.3).astype(np.float32)
        np.testing.assert_array_equal(ks.step(chunk), kd.step(chunk))
    assert torch.equal(ks.state.v, kd.state.v[:, :N])
    assert torch.equal(ks.state.s_prev, kd.state.s_prev[:, :N])
    np.testing.assert_array_equal(ks.features(), kd.features())
    assert float(ks.state.segs["counts"].sum()) > 0


def test_fit_continuous_readout_on_sparse_reservoir(params):
    audio, labels = dataset.synthetic_audio_batch_hard(2, K, seed=11)
    sr = convert.sparse_reservoir(params)
    ro, sc = fit_continuous_readout(sr, tcfg.FrontendConfig(n_filters=C), audio, labels, K,
                                    max_iter=50)
    assert ro.w.shape == (D, K) and sc.mean.shape == (D,)
    assert torch.isfinite(ro.w).all() and torch.isfinite(sc.scale).all()
    kws = ContinuousKWS(sr, ro, sc, tcfg.FrontendConfig(n_filters=C), n_streams=len(labels))
    logits = kws.step(audio[:, :L])
    assert logits.shape == (len(labels), K) and np.isfinite(logits).all()
