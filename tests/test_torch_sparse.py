"""The port's block-sparse reservoir (lsm_tpu_torch.models.sparse, kernel
B5's plain twin) against lsm_tpu on the CPU.

lsm_tpu draws its sparse weights with jax.random, the port with a torch
Generator, so parity runs on lsm_tpu's arrays carried across with
`convert.sparse_reservoir`, snapped to a dyadic grid with zero leak
(tests/test_sparse_reservoir.py's recipe): every sum is then exact in
float32 and the spikes cannot depend on summation order. Tolerances: the
six raster-exact features (counts, spike times, mean ISI, bursts) and
all_counts bit-equal; the two variance features, whose mean(x^2) -
mean(x)^2 epilogue the reference's compiled programs may contract into an
FMA, at rtol 1e-4 / atol 1e-5 (test_sparse_reservoir.py:165-173). The
port's own draws are held to the structure lsm_tpu's test holds.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lsm_tpu import config as jcfg
from lsm_tpu.models import reservoir as jres
from lsm_tpu.models import sparse as jsp
from lsm_tpu.ops.pallas.sparse_lif_kernel import simulate_batch_sparse_pallas

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.io import artifacts
from lsm_tpu_torch.io import dataset as tds
from lsm_tpu_torch.models.calibration import calibrate_weight
from lsm_tpu_torch.models.diagnostics import run_network_diagnostics
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.models import sparse as tsp
from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops.kernels import sparse_lif as ksp

# Under pytest-xdist several workers share a few cores; torch's intra-op
# thread pools would contend (the tiny ops here run ~10x slower so).
torch.set_num_threads(1)

KEYS = tuple(jcfg.FEATURE_SETS["all"])
EXACT = (0, 2, 3, 4, 5, 7)          # counts, times, mean_isi, bursts in KEYS order
REPO = Path(__file__).resolve().parent.parent


def _cfg(pkg, n=384, k=76, **kw):
    kw.setdefault("num_output_neurons", 128)
    kw.setdefault("mean_weight", 0.02)
    kw.setdefault("input_fanout", 6)
    kw.setdefault("sparse_partner_blocks", 2)
    return pkg.ReservoirConfig(num_neurons=n, small_world_k=k, **kw)


def _quantize(params):
    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0
    return dataclasses.replace(params, w_blocks=q(params.w_blocks), w_in=q(params.w_in),
                               leak=jnp.zeros_like(params.leak))


def _assert_features(port, ref, no):
    for i in EXACT:
        np.testing.assert_array_equal(port[:, i * no:(i + 1) * no], ref[:, i * no:(i + 1) * no],
                                      err_msg=KEYS[i])
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def dyadic_case():
    """lsm_tpu's sparse reservoir (seed 9) on dyadic weights and 5 trains of
    40 steps: the XLA scan's features and all_counts, and the Pallas kernel's
    features in interpret mode for both drive formulations."""
    params = _quantize(jsp.init_reservoir_sparse(_cfg(jcfg, seed=9), n_channels=32))
    spikes = (np.random.default_rng(0).random((5, 32, 40)) < 0.15).astype(np.uint8)
    xla = np.asarray(jsp.extract_features_sparse(params, jnp.asarray(spikes), KEYS,
                                                 matmul_dtype=jnp.bfloat16))
    counts = np.asarray(jsp.simulate_batch_sparse(params, jnp.asarray(spikes))["all_counts"])
    pallas = {}
    for fuse_gather in (False, True):
        with pltpu.force_tpu_interpret_mode():
            st = simulate_batch_sparse_pallas(params, jnp.asarray(spikes), b_tile=8,
                                              fuse_gather=fuse_gather)
        pallas[fuse_gather] = (np.asarray(jres.features_from_stats(st, KEYS)),
                               np.asarray(st["all_counts"]))
    return params, spikes, xla, counts, pallas


def test_rejects_non_multiple_of_block():
    with pytest.raises(ValueError, match="% 128"):
        tsp.init_reservoir_sparse(_cfg(tcfg, n=1000, k=200), n_channels=32)


def test_structure_out_degree_and_blocks():
    """The port's own draw has lsm_tpu's structure (test_sparse_reservoir.py:48-81)."""
    cfg = _cfg(tcfg, n=512, k=102, seed=7)
    sr = tsp.init_reservoir_sparse(cfg, n_channels=32)
    nb, half = 512 // tsp.BLOCK, cfg.small_world_k // 2
    assert sr.n_band == (tsp.BLOCK - 1 + half) // tsp.BLOCK + 1
    S = sr.n_band + cfg.sparse_partner_blocks
    assert tuple(sr.w_blocks.shape) == (nb, S, tsp.BLOCK, tsp.BLOCK)
    assert sr.src_idx.dtype == torch.int32 and tuple(sr.src_idx.shape) == (nb, S)
    src_idx = sr.src_idx.numpy()
    for d in range(sr.n_band):                       # band slots: ring predecessors
        np.testing.assert_array_equal(src_idx[:, d], (np.arange(nb) - d) % nb)
    for s in range(sr.n_band, S):                    # partner slots: permutations
        assert sorted(src_idx[:, s]) == list(range(nb))

    w = tsp.densify(sr).w_rec.numpy()
    assert np.abs(np.diagonal(w)).max() == 0.0       # no self-loop
    out_deg = (w != 0).sum(axis=1)
    assert (out_deg <= half).all() and out_deg.min() >= half - 5
    assert out_deg.mean() > half - 1
    vals = w[w != 0]
    std = abs(cfg.mean_weight) * np.sqrt(cfg.weight_variance)
    assert abs(vals.mean() - cfg.mean_weight) < 3 * std / np.sqrt(len(vals)) * 5
    assert abs(vals.std() - std) / std < 0.05
    w_in = sr.w_in.numpy()
    assert w_in.shape == (128, 512) and ((w_in[:32] != 0).sum(axis=1) == 6).all()
    assert not w_in[32:].any() and (sr.leak.numpy() == np.float32(cfg.leak_coefficient)).all()


def test_init_is_deterministic_in_seed_and_device_free():
    """One CPU generator seeded with cfg.seed draws everything: the same seed
    gives the same weights, wherever the module is moved afterwards."""
    cfg = _cfg(tcfg, n=256, k=52, seed=4, leak_variance_divisor=4.0)
    a = tsp.init_reservoir_sparse(cfg, n_channels=16, mean_weight=0.03)
    b = tsp.init_reservoir_sparse(cfg, n_channels=16, mean_weight=0.03, device="cpu").to("cpu")
    for name in ("w_blocks", "src_idx", "w_in", "leak"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    c = tsp.init_reservoir_sparse(dataclasses.replace(cfg, seed=5), n_channels=16,
                                  mean_weight=0.03)
    assert not torch.equal(a.w_blocks, c.w_blocks)
    assert 0.0 < float(a.leak.std()) and float(a.leak.min()) >= 0.0


def test_features_bit_equal_to_xla_and_pallas(dyadic_case):
    params, spikes, xla, counts, pallas = dyadic_case
    sr = convert.sparse_reservoir(params)
    no = params.n_outputs
    out = tsp.extract_features_sparse(sr, torch.as_tensor(spikes), KEYS).numpy()
    st = tsp.simulate_batch_sparse(sr, torch.as_tensor(spikes))
    assert out.shape == (5, len(KEYS) * no)
    _assert_features(out, xla, no)
    np.testing.assert_array_equal(st["all_counts"].numpy(), counts)
    for fuse_gather, (feats, all_counts) in pallas.items():
        _assert_features(out, feats, no)
        np.testing.assert_array_equal(st["all_counts"].numpy(), all_counts)
    assert out[:, :no].sum() > 0                     # the outputs fired


def test_window_clamp_non_divisible_t():
    """T = 45 with 10 rate windows: the last window takes the overflow, as in
    the Pallas kernel (test_sparse_reservoir.py:177-197), random weights."""
    params = jsp.init_reservoir_sparse(_cfg(jcfg, seed=9), n_channels=32)
    spikes = (np.random.default_rng(1).random((4, 32, 45)) < 0.2).astype(np.uint8)
    with pltpu.force_tpu_interpret_mode():
        st = simulate_batch_sparse_pallas(params, jnp.asarray(spikes), b_tile=8)
    ref = np.asarray(jres.features_from_stats(st, KEYS))
    out = tsp.extract_features_sparse(convert.sparse_reservoir(params),
                                      torch.as_tensor(spikes), KEYS).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    assert out[:, :params.n_outputs].sum() > 0


def test_sparse_matches_densified_dense_bitwise():
    """Inside the port: B5's twin on the blocks == B2's twin on densify(),
    features and all_counts bit-equal (test_sparse_reservoir.py:84-103)."""
    sr = tsp.init_reservoir_sparse(_cfg(tcfg, seed=3), n_channels=32).dyadic()
    spikes = torch.as_tensor((np.random.default_rng(2).random((5, 32, 40)) < 0.15)
                             .astype(np.uint8))
    dense = tsp.densify(sr)
    assert isinstance(dense, tres.Reservoir) and dense.w_rec.shape == (384, 384)
    f_sparse = tres.extract_features(sr, spikes, KEYS)
    f_dense = tres.extract_features(dense, spikes, KEYS)
    assert torch.equal(f_sparse, f_dense)
    assert torch.equal(tres.simulate_batch(sr, spikes)["all_counts"],
                       tres.simulate_batch(dense, spikes)["all_counts"])
    assert f_sparse[:, :sr.n_outputs].sum() > 0


def test_sparse_drive_equals_reference():
    """The plain block-sparse drive against lsm_tpu's `sparse_drive` in
    float32 on 0/1 spikes and dyadic blocks: every sum is exact."""
    params = _quantize(jsp.init_reservoir_sparse(_cfg(jcfg, seed=5), n_channels=32))
    s = (np.random.default_rng(3).random((4, 384)) < 0.3).astype(np.float32)
    ref = np.asarray(jsp.sparse_drive(jnp.asarray(s), params.w_blocks, params.src_idx,
                                      jnp.float32))
    out = tsp.sparse_drive(torch.as_tensor(s), torch.as_tensor(np.asarray(params.w_blocks)),
                           torch.as_tensor(np.asarray(params.src_idx), dtype=torch.int64))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert np.abs(ref).sum() > 0


def test_dyadic_and_kernel_operands(dyadic_case):
    params = dyadic_case[0]
    sr = convert.sparse_reservoir(params)
    (wb, src_idx, w_in, leak_keep), kw = sr.kernel_operands()
    assert wb.dtype == w_in.dtype == torch.bfloat16 and src_idx.dtype == torch.int32
    assert torch.equal(wb.float(), sr.w_blocks) and torch.equal(w_in.float(), sr.w_in)
    assert torch.equal(leak_keep, 1.0 - sr.leak)
    assert kw == dict(threshold=params.threshold, refractory=params.refractory,
                      burst_isi_max=params.burst_isi_max, n_outputs=params.n_outputs,
                      n_win=params.n_rate_windows)
    assert set(sr.state_dict()) == {"w_blocks", "src_idx", "w_in", "leak"}
    raw = tsp.init_reservoir_sparse(_cfg(tcfg, seed=3), n_channels=32)
    dy = raw.dyadic()
    assert torch.equal(dy.w_blocks, torch.round(raw.w_blocks * 256) / 256)
    assert torch.equal(dy.src_idx, raw.src_idx) and not dy.leak.any()


def test_convert_keeps_every_array_and_field():
    params = jsp.init_reservoir_sparse(_cfg(jcfg, n=256, k=52, seed=2), n_channels=16)
    sr = convert.sparse_reservoir(params)
    for name in ("w_blocks", "src_idx", "w_in", "leak"):
        np.testing.assert_array_equal(getattr(sr, name).numpy(), np.asarray(getattr(params, name)))
    for f in ("n_neurons", "n_outputs", "n_channels", "threshold", "refractory",
              "burst_isi_max", "n_rate_windows", "n_band"):
        assert getattr(sr, f) == getattr(params, f), f


@pytest.mark.parametrize("kw", [
    dict(), dict(num_neurons=4096), dict(num_neurons=4100), dict(num_neurons=10240),
    dict(num_neurons=10240, sparse=False), dict(num_neurons=512, sparse=True),
])
def test_use_sparse_equals_reference(kw):
    assert tcfg.ReservoirConfig(**kw).use_sparse() == jcfg.ReservoirConfig(**kw).use_sparse()


def test_pipeline_extract_dispatches_sparse():
    """use_sparse() routes the port's init, diagnostics and extraction through
    the block-sparse path (test_sparse_reservoir.py:244-268)."""
    rcfg = tcfg.ReservoirConfig(num_neurons=512, num_output_neurons=128, small_world_k=102,
                                sparse=True, input_fanout=6)
    cfg = tcfg.PipelineConfig(reservoir=rcfg, feature_set="original", batch_size=8)
    rng = np.random.default_rng(6)
    x = (rng.random((40, 32, 40)) < 0.15).astype(np.uint8)
    y = (np.arange(40) % 4).astype(np.int32)
    ext = tpipe.extract_lsm_features(cfg, artifacts.SpikeDataset(x_spikes=x, y_labels=y),
                                     torch.device("cpu"))
    assert isinstance(ext.reservoir, tsp.SparseReservoir)
    assert ext.artifact.x_train.shape == (32, 5 * 128) and ext.artifact.x_test.shape == (8, 5 * 128)
    assert np.isfinite(ext.artifact.x_train).all() and np.isfinite(ext.artifact.x_test).all()
    assert ext.diagnostics is not None and len(ext.diagnostics.participation) == 5


def test_sparse_wrapper_cpu_and_validation():
    sr = tsp.init_reservoir_sparse(_cfg(tcfg, n=256, k=52, seed=1), n_channels=16)
    ops, kw = sr.kernel_operands()
    x = torch.zeros(2, 16, 10, dtype=torch.uint8)
    before = _build.launches.copy()
    stats, all_counts = ksp.sparse_lif_stats(x, *ops, **kw)
    assert stats.shape == (11, 2, 128) and all_counts.shape == (2, 256)
    assert not stats[0].any() and torch.isinf(stats[3]).all()     # silent input
    ckw = {k: v for k, v in kw.items() if k != "n_win"}
    state = (torch.zeros(2, 256), torch.zeros(2, 256, dtype=torch.int32), torch.zeros(2, 256))
    ksp.sparse_lif_chunk(torch.zeros(2, 16, 40, dtype=torch.uint8), *ops, *state, **ckw,
                         win_len=40, n_new_win=1)
    assert _build.launches == before           # plain twins: no launch
    with pytest.raises(TypeError):
        ksp.sparse_lif_stats(x.float(), *ops, **kw)
    with pytest.raises(TypeError):
        ksp.sparse_lif_stats(x, sr.w_blocks, *ops[1:], **kw)       # f32 weights
    with pytest.raises(TypeError):
        ksp.sparse_lif_stats(x, ops[0], ops[1].long(), *ops[2:], **kw)
    with pytest.raises(ValueError, match="block-sparse shapes"):
        ksp.sparse_lif_stats(x, ops[0][:1], *ops[1:], **kw)
    with pytest.raises(ValueError, match="channels"):
        ksp.sparse_lif_stats(torch.zeros(2, 200, 10, dtype=torch.uint8), *ops, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ksp.sparse_lif_stats(torch.zeros(2, 10, 16, dtype=torch.uint8).transpose(1, 2),
                             *ops, **kw)
    with pytest.raises(ValueError, match="several devices"):
        ksp.sparse_lif_stats(x.to("meta"), *ops, **kw)
    with pytest.raises(ValueError, match="windows"):
        ksp.sparse_lif_chunk(torch.zeros(2, 16, 40, dtype=torch.uint8), *ops, *state, **ckw,
                             win_len=30, n_new_win=1)
    with pytest.raises(TypeError):
        ksp.sparse_lif_chunk(torch.zeros(2, 16, 40, dtype=torch.uint8), *ops, state[0],
                             state[1].float(), state[2], **ckw, win_len=40, n_new_win=1)


def test_configs3_draw_matches_reference_statistically():
    """At BASELINE configs[3] width (10240 neurons, k = 2048) the port's own
    draw and lsm_tpu's jax.random draw, calibrated at multiplier 1.6 on the
    hard corpus as the configs[3] slice is and run through the same
    simulation, agree in structure and in regime."""
    audio, labels = tds.synthetic_audio_batch_hard(30, 12, seed=42)
    rcfg = tcfg.ReservoirConfig(num_neurons=10240, small_world_k=2048)
    spikes = tpipe.featurize_audio_array(tcfg.PipelineConfig(reservoir=rcfg), audio,
                                         torch.device("cpu"))
    x_train = tpipe.stratified_split(spikes, labels, 0.2, 42)[0]
    _, mw = calibrate_weight(rcfg, x_train[:500], 1.6)
    draws = {
        "port": tsp.init_reservoir_sparse(rcfg, 128, mean_weight=mw),
        "lsm_tpu": convert.sparse_reservoir(jsp.init_reservoir_sparse(
            jcfg.ReservoirConfig(num_neurons=10240, small_world_k=2048), 128, mean_weight=mw)),
    }
    stats = {}
    for name, r in draws.items():
        nz = r.w_blocks[r.w_blocks != 0]
        rep = run_network_diagnostics(r, x_train)
        stats[name] = (rep.regime, rep.avg_participation, nz.numel() / 10240,
                       float(nz.mean()), float(nz.std()))
        print(f"{name}: {rep.regime} participation {rep.avg_participation:.2f} % "
              f"edges/row {stats[name][2]:.1f} mean {stats[name][3]:.6f} std {stats[name][4]:.6f}")
    (r_p, part_p, deg_p, m_p, s_p), (r_j, part_j, deg_j, m_j, s_j) = stats["port"], stats["lsm_tpu"]
    assert r_p == r_j and abs(part_p - part_j) < 1.0
    assert abs(deg_p - deg_j) / deg_j < 1e-3
    assert abs(m_p - m_j) / m_j < 0.01 and abs(s_p - s_j) / s_j < 0.01


def test_cli_sparse_runs_without_jax(tmp_path):
    """`python -m lsm_tpu_torch --sparse` end to end on the CPU at 512
    neurons: no jax, no lsm_tpu, and the block-sparse path was taken."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['lsm_tpu_torch', '--synthetic', '--samples-per-class', '5',"
        " '--num-neurons', '512', '--num-output-neurons', '128', '--sparse',"
        " '--n-filters', '32', '--device', 'cpu', '--skip-artifacts']\n"
        "runpy.run_module('lsm_tpu_torch', run_name='__main__')\n"
        "ref = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lsm_tpu')]\n"
        "assert not ref, ref\n"
        "print('JAX_FREE')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    for line in ("Using block-sparse reservoir (512 neurons)", "STATUS:", "Test Accuracy:",
                 "--- Pipeline Finished ---", "JAX_FREE"):
        assert line in proc.stdout, line
    assert not list(tmp_path.glob("*.npz"))
