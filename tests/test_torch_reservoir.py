"""Parity of the port's reservoir, calibration and diagnostics with the JAX
reference on the CPU.

Weights come from lsm_tpu's init_reservoir (bit-equal to the port's own
draw) and, for the bit-equality oracles, are snapped to a dyadic grid with
zero leak (tests/test_reservoir.py's recipe): every sum is then exact in
float32, so spike decisions cannot depend on summation order. Features go
through a few float divisions and are held at rtol 1e-5 / atol 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lsm_tpu.config import FEATURE_SETS, ReservoirConfig
from lsm_tpu.models import calibration as jcal
from lsm_tpu.models import diagnostics as jdiag
from lsm_tpu.models import reservoir as jres
from lsm_tpu.ops.pallas.lif_kernel import simulate_batch_pallas

from lsm_tpu_torch import convert
from lsm_tpu_torch.models import calibration as tcal
from lsm_tpu_torch.models import diagnostics as tdiag
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops.kernels import lif as klif

# Under pytest-xdist several workers share a few cores; torch's intra-op
# thread pools would contend (the tiny ops here run ~10x slower so).
torch.set_num_threads(1)

KEYS = tuple(FEATURE_SETS["all"])
SMALL = ReservoirConfig(
    num_neurons=256, num_output_neurons=128, small_world_k=32,
    mean_weight=0.02, input_fanout=6,
)                                   # tests/test_pallas_kernels.py:41-46


def _dyadic(params):
    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0
    return dataclasses.replace(
        params, w_rec=q(params.w_rec), w_in=q(params.w_in),
        leak=jnp.zeros_like(params.leak),
    )


@pytest.fixture(scope="module")
def small_case():
    """JAX side at the Pallas test config, computed once: the XLA scan and
    the Pallas kernel (interpret mode) at T=40 and at T=45 (window clamp)."""
    params = _dyadic(jres.init_reservoir(SMALL, n_channels=32))
    rng = np.random.default_rng(21)
    out = {}
    for T, b in ((40, 8), (45, 4)):
        spikes = (rng.random((b, 32, T)) < 0.2).astype(np.uint8)
        xla = jres.simulate_batch(params, jnp.asarray(spikes), matmul_dtype=jnp.bfloat16)
        with pltpu.force_tpu_interpret_mode():
            pal = simulate_batch_pallas(params, jnp.asarray(spikes))
        out[T] = (spikes, {k: np.asarray(v) for k, v in xla.items()},
                  {k: np.asarray(v) for k, v in pal.items()})
    return params, out


def test_init_reservoir_bit_equal_flagship():
    cfg = ReservoirConfig()
    ref = jres.init_reservoir(cfg, n_channels=128, mean_weight=0.0113800716)
    port = tres.init_reservoir(cfg, n_channels=128, mean_weight=0.0113800716)
    for name in ("w_rec", "w_in", "leak"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    assert port.w_rec.shape == (1024, 1024) and port.w_in.shape == (128, 1024)
    for f in ("n_neurons", "n_outputs", "n_channels", "threshold", "refractory",
              "burst_isi_max", "n_rate_windows"):
        assert getattr(port, f) == getattr(ref, f)


def test_init_reservoir_heterogeneous_leak_bit_equal():
    cfg = ReservoirConfig(num_neurons=200, small_world_k=40, leak_variance_divisor=4.0)
    ref = jres.init_reservoir(cfg, n_channels=16, mean_weight=0.02)
    port = tres.init_reservoir(cfg, n_channels=16, mean_weight=0.02)
    np.testing.assert_array_equal(port.leak.numpy(), np.asarray(ref.leak))
    np.testing.assert_array_equal(port.w_rec.numpy(), np.asarray(ref.w_rec))


@pytest.mark.parametrize("T", [40, 45])
def test_stats_bit_equal_to_xla_and_pallas(small_case, T):
    params, cases = small_case
    spikes, xla, pal = cases[T]
    port = tres.simulate_batch(convert.reservoir(params), torch.as_tensor(spikes))
    got = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in port.items()}
    for k in ("counts", "sum_t", "sum_t2", "first", "last", "n_isi", "sum_isi",
              "sum_isi2", "bursts", "all_counts"):
        np.testing.assert_array_equal(got[k], xla[k], err_msg=k)
        np.testing.assert_array_equal(got[k], pal[k], err_msg=k)
    win = xla["win_counts"]
    np.testing.assert_array_equal(got["win_sum"], win.sum(-1))
    np.testing.assert_array_equal(got["win_sum2"], (win * win).sum(-1))
    np.testing.assert_array_equal(got["win_sum"], pal["win_sum"])
    np.testing.assert_array_equal(got["win_sum2"], pal["win_sum2"])
    assert got["n_win_used"] == pal["n_win_used"]


@pytest.mark.parametrize("T", [40, 45])
def test_features_match_xla_and_pallas(small_case, T):
    params, cases = small_case
    spikes, xla, pal = cases[T]
    ref_x = np.asarray(jres.features_from_stats({k: jnp.asarray(v) for k, v in xla.items()}, KEYS))
    pal_in = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) and v.ndim else v)
              for k, v in pal.items()}
    ref_p = np.asarray(jres.features_from_stats(pal_in, KEYS))
    out = tres.extract_features(convert.reservoir(params), torch.as_tensor(spikes), KEYS).numpy()
    assert out.shape == (spikes.shape[0], len(KEYS) * SMALL.num_output_neurons)
    np.testing.assert_allclose(out, ref_x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, ref_p, rtol=1e-5, atol=1e-6)


def test_dyadic_and_kernel_operands_follow_the_reference_recipe():
    params = jres.init_reservoir(SMALL, n_channels=32)
    port = convert.reservoir(params).dyadic()
    ref = convert.reservoir(_dyadic(params))
    for name in ("w_rec", "w_in", "leak"):
        assert torch.equal(getattr(port, name), getattr(ref, name)), name
    (w_rec, w_in, leak_keep), kw = port.kernel_operands()
    assert torch.equal(w_rec.float(), port.w_rec) and torch.equal(w_in.float(), port.w_in)
    assert w_rec.dtype == w_in.dtype == torch.bfloat16
    assert torch.equal(leak_keep, 1.0 - port.leak)
    assert kw == dict(threshold=SMALL.membrane_threshold, refractory=SMALL.refractory_period,
                      burst_isi_max=SMALL.burst_isi_max, n_outputs=SMALL.num_output_neurons,
                      n_win=SMALL.n_rate_windows)
    assert set(port.state_dict()) == {"w_rec", "w_in", "leak"}


def test_lif_wrapper_cpu_and_validation():
    r = tres.init_reservoir(SMALL, n_channels=32)
    x = torch.zeros(2, 32, 10, dtype=torch.uint8)
    ops, kw = r.kernel_operands()
    before = _build.launches.copy()
    stats, all_counts = klif.lif_stats(x, *ops, **kw)
    assert _build.launches == before                       # plain twin: no launch
    assert stats.shape == (11, 2, 128) and all_counts.shape == (2, 256)
    assert not stats[0].any() and torch.isinf(stats[3]).all()   # silent input
    with pytest.raises(TypeError):
        klif.lif_stats(x.float(), *ops, **kw)
    with pytest.raises(TypeError):
        klif.lif_stats(x, r.w_rec, *ops[1:], **kw)                 # f32 weights
    with pytest.raises(ValueError):
        klif.lif_stats(torch.zeros(2, 200, 10, dtype=torch.uint8), *ops, **kw)


def test_calibration_matches():
    rng = np.random.default_rng(4)
    spikes = (rng.random((520, 16, 40)) < 0.07).astype(np.uint8)
    cfg = ReservoirConfig()
    ref = jcal.calibrate_weight(cfg, jnp.asarray(spikes), 0.6)
    out = tcal.calibrate_weight(cfg, torch.as_tensor(spikes), 0.6)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    assert tcal.calibrate_weight(cfg, spikes, 0.6) == out       # NumPy input
    assert tcal.w_critico(cfg, float("nan")) == jcal.w_critico(cfg, float("nan")) == 0.007
    assert np.isnan(tcal.average_input_rate(spikes[:0]))


def test_diagnostics_render_equal_on_dyadic_weights():
    cfg = ReservoirConfig()
    params = _dyadic(jres.init_reservoir(cfg, n_channels=128, mean_weight=0.012))
    rng = np.random.default_rng(9)
    spikes = (rng.random((6, 128, 120)) < 0.05).astype(np.uint8)
    ref = jdiag.run_network_diagnostics(params, spikes)
    out = tdiag.run_network_diagnostics(convert.reservoir(params), spikes)
    assert out.regime == ref.regime
    assert out.render() == ref.render()
    for p in (10.0, 50.0, 99.0):
        assert tdiag.classify_regime(p) == jdiag.classify_regime(p)
