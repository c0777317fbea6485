"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Every test here needs a CUDA device and skips without one.

This file imports no jax and nothing of lsm_tpu, so it also runs where jax
is not installed:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from lsm_tpu_torch.config import FEATURE_SETS, FrontendConfig, ReservoirConfig
from lsm_tpu_torch.io import dataset
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models import sparse
from lsm_tpu_torch.models.continuous import ContinuousKWS
from lsm_tpu_torch.models.frontend import featurize_batch
from lsm_tpu_torch.models.streaming import decode_pcm_device
from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops import gammatone as gt
from lsm_tpu_torch.ops import hysteresis as hyst
from lsm_tpu_torch.ops.kernels import fold as kfold
from lsm_tpu_torch.ops.kernels import gtgram as kgt
from lsm_tpu_torch.ops.kernels import hysteresis as khyst
from lsm_tpu_torch.ops.kernels import lif as klif
from lsm_tpu_torch.ops.kernels import sparse_lif as ksp
from lsm_tpu_torch.readout import logistic, scaler

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def dense_body_launches(body):
    """B2 and B4 launches on one dense body so far."""
    return (_build.launches[f"lsm_lif_stats:{body}"]
            + _build.launches[f"lsm_lif_chunk:{body}"])


def _wave(cuda, batch, samples, seed):
    return torch.as_tensor(
        (np.random.default_rng(seed).standard_normal((batch, samples)) * 0.2).astype(np.float32)
    ).to(cuda)


@pytest.mark.parametrize("batch,channels", [(70, 128), (3, 32), (5, 200)])
def test_gtgram_kernel_matches_plain(cuda, batch, channels):
    wave = _wave(cuda, batch, 16000, batch)
    fb = gt.filterbank(16000.0, channels, 50.0, 80, cuda)
    before = _build.launches["lsm_gtgram_sub_energy"]
    out = kgt.sub_energy(wave, fb)
    assert _build.launches["lsm_gtgram_sub_energy"] == before + 1
    ref = kgt.sub_energy_plain(wave, fb)
    torch.cuda.synchronize()
    assert out.shape == (200, batch, channels)
    torch.testing.assert_close(out, ref, rtol=5e-3, atol=1e-6)


def test_gtgram_kernel_rejects_what_it_cannot_run(cuda):
    fb = gt.filterbank(16000.0, 8, 50.0, 80, cuda)
    with pytest.raises(ValueError, match="multiple"):
        kgt.sub_energy(torch.zeros(2, 16001, device=cuda), fb)
    with pytest.raises(ValueError, match="multiple"):
        kgt.sub_energy(torch.zeros(2, 0, device=cuda), fb)          # no sub-block
    with pytest.raises(TypeError):
        kgt.sub_energy(torch.zeros(2, 16000, device=cuda, dtype=torch.float64), fb)
    # The cascade reads samples one float at a time: a wave that starts off
    # any 16-byte boundary runs, bit-equal to an aligned copy.
    wave = _wave(cuda, 2, 16001, 9)
    shifted = wave.view(-1)[1:1 + 32000].view(2, 16000)
    out = kgt.sub_energy(shifted, fb)
    assert torch.equal(out, kgt.sub_energy(shifted.clone(), fb)) and out.abs().sum() > 0


@pytest.mark.parametrize("fs,g", [(8000.0, 40), (16000.0, 80), (16000.0, 160)])
def test_gtgram_kernels_at_any_sub_block(cuda, fs, g):
    """B1 and B3 against their twins at the sub-block lengths that
    FrontendConfig(sample_rate=8000) (g = 40) and gt_window_time=0.03
    (g = 160) give."""
    n = int(fs)
    wave = _wave(cuda, 6, n, g)
    fb = gt.filterbank(fs, 128, 50.0, g, cuda)
    e1 = kgt.sub_energy(wave, fb)
    torch.testing.assert_close(e1, kgt.sub_energy_plain(wave, fb), rtol=5e-3, atol=1e-6)
    assert e1.shape == (n // g, 6, 128)
    state = kgt.chunk_plain(wave[:, : n // 10], fb, torch.zeros(6, 8, 128, device=cuda))[0]
    hop = wave[:, n // 10: n // 5].contiguous()
    s3, e3 = kgt.chunk(hop, fb, state)
    s_ref, e_ref = kgt.chunk_plain(hop, fb, state)
    torch.cuda.synchronize()
    torch.testing.assert_close(e3, e_ref, rtol=5e-3, atol=1e-6)
    torch.testing.assert_close(s3, s_ref, rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("cfg,c,t,b", [
    (ReservoirConfig(num_neurons=256, num_output_neurons=128, small_world_k=32,
                     mean_weight=0.02, input_fanout=6), 32, 40, 8),
    (ReservoirConfig(num_neurons=256, num_output_neurons=128, small_world_k=32,
                     mean_weight=0.02, input_fanout=6), 32, 45, 4),
    (ReservoirConfig(mean_weight=0.0114), 128, 400, 6),
])
def test_lif_kernel_bit_equal_on_dyadic_weights(cuda, cfg, c, t, b):
    r = res.init_reservoir(cfg, c, device=cuda).dyadic()
    spikes = torch.as_tensor(
        (np.random.default_rng(t).random((b, c, t)) < 0.2).astype(np.uint8)
    ).to(cuda)
    ops, kw = r.kernel_operands()
    before = _build.launches["lsm_lif_stats"]
    stats, all_counts = klif.lif_stats(spikes, *ops, **kw)
    assert _build.launches["lsm_lif_stats"] == before + 1
    ref_stats, ref_counts = klif.lif_stats_plain(spikes, *ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(stats, ref_stats)
    assert torch.equal(all_counts, ref_counts)
    assert all_counts.sum() > 0


def test_featurize_on_card_matches_cpu(cuda):
    cfg = FrontendConfig()
    audio, _ = dataset.synthetic_audio_batch_hard(1, 12, seed=5)
    on_card = featurize_batch(torch.as_tensor(audio).to(cuda), cfg).cpu().numpy()
    on_cpu = featurize_batch(torch.as_tensor(audio), cfg).numpy()
    assert (on_card != on_cpu).mean() <= 1e-3


def _carried_state(cuda, batch, channels, seed):
    """A cascade state a stream reaches after 0.3 s of audio."""
    fb = gt.filterbank(16000.0, channels, 50.0, 80, cuda)
    return kgt.chunk_plain(_wave(cuda, batch, 4800, seed), fb,
                           torch.zeros(batch, 8, channels, device=cuda))[0]


@pytest.mark.parametrize("batch,channels", [(70, 128), (3, 32)])
def test_gtgram_chunk_kernel_matches_plain(cuda, batch, channels):
    hop = _wave(cuda, batch, 1600, batch + 1)
    fb = gt.filterbank(16000.0, channels, 50.0, 80, cuda)
    state = _carried_state(cuda, batch, channels, batch)
    before = _build.launches["lsm_gtgram_chunk"]
    s_out, e = kgt.chunk(hop, fb, state)
    assert _build.launches["lsm_gtgram_chunk"] == before + 1
    s_ref, e_ref = kgt.chunk_plain(hop, fb, state)
    torch.cuda.synchronize()
    assert e.shape == (20, batch, channels) and s_out.shape == (batch, 8, channels)
    torch.testing.assert_close(e, e_ref, rtol=5e-3, atol=1e-6)
    # The state passes through zero: atol 1e-5 against magnitudes ~0.4
    # (the twin sums x @ W_xs in cuBLAS order, the kernel runs the cascade).
    torch.testing.assert_close(s_out, s_ref, rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("fs,g", [(16000.0, 80), (8000.0, 40), (16000.0, 160)])
def test_gtgram_chunk_kernel_chaining_is_exact(cuda, fs, g):
    """Ten B3 hops threading the state are bit-equal to one whole-second B3
    call, whose energies are B1's."""
    n = int(fs)
    wave = _wave(cuda, 66, n, 4)
    fb = gt.filterbank(fs, 128, 50.0, g, cuda)
    st = torch.zeros(66, 8, 128, device=cuda)
    s_whole, e_whole = kgt.chunk(wave, fb, st)
    parts = []
    for c in range(10):
        st, e = kgt.chunk(wave[:, c * n // 10:(c + 1) * n // 10].contiguous(), fb, st)
        parts.append(e)
    e_b1 = kgt.sub_energy(wave, fb)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), e_whole)
    assert torch.equal(st, s_whole)
    assert torch.equal(e_whole, e_b1)


@pytest.mark.parametrize("conv_sub", [1, 10, 200])
def test_gtgram_conversion_period(cuda, conv_sub):
    """Chunks of one conversion period (conv_sub sub-blocks) threading the
    state are bit-equal to one call at that period, and every period stays
    within the twin's tolerance; the period must be positive."""
    wave = _wave(cuda, 33, 16000, conv_sub)
    fb = gt.filterbank(16000.0, 64, 50.0, 80, cuda)
    st = torch.zeros(33, 8, 64, device=cuda)
    s_whole, e_whole = kgt.chunk(wave, fb, st, conv_sub=conv_sub)
    step = conv_sub * 80
    parts = []
    for c in range(0, 16000, step):
        st, e = kgt.chunk(wave[:, c:c + step].contiguous(), fb, st, conv_sub=conv_sub)
        parts.append(e)
    e_b1 = kgt.sub_energy(wave, fb, conv_sub=conv_sub)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), e_whole) and torch.equal(st, s_whole)
    assert torch.equal(e_whole, e_b1)
    torch.testing.assert_close(e_b1, kgt.sub_energy_plain(wave, fb), rtol=5e-3, atol=1e-6)
    with pytest.raises(ValueError, match="period"):
        kgt.sub_energy(wave, fb, conv_sub=0)


@pytest.mark.parametrize("n_new_win", [1, 2])
def test_lif_chunk_kernel_bit_equal_over_chained_chunks(cuda, n_new_win):
    cfg = ReservoirConfig(mean_weight=0.0114)
    r = res.init_reservoir(cfg, 128, device=cuda).dyadic()
    ops, kw = r.kernel_operands()
    del kw["n_win"]
    kw.update(win_len=40, n_new_win=n_new_win)
    b, n_pad = 6, ops[0].shape[0]
    rng = np.random.default_rng(n_new_win)
    state_k = state_p = (torch.zeros(b, n_pad, device=cuda),
                         torch.zeros(b, n_pad, dtype=torch.int32, device=cuda),
                         torch.zeros(b, n_pad, device=cuda))
    carried = 0.0
    for _ in range(3):
        x = torch.as_tensor(
            (rng.random((b, 128, 40 * n_new_win)) < 0.2).astype(np.uint8)).to(cuda)
        carried += float(state_k[2].sum())
        before = _build.launches["lsm_lif_chunk"]
        out_k = klif.lif_chunk(x, *ops, *state_k, **kw)
        assert _build.launches["lsm_lif_chunk"] == before + 1
        out_p = klif.lif_chunk_plain(x, *ops, *state_p, **kw)
        torch.cuda.synchronize()
        for a, p in zip(out_k, out_p):
            assert a.dtype == p.dtype and torch.equal(a, p)
        state_k, state_p = out_k[:3], out_p[:3]
    assert carried > 0                    # the carried spike vector was exercised


def test_chunk_kernels_refuse_what_they_cannot_run(cuda):
    fb = gt.filterbank(16000.0, 16, 50.0, 80, cuda)
    hop = torch.zeros(2, 1600, device=cuda)
    st = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        kgt.chunk(hop, fb, st.double())
    with pytest.raises(ValueError, match="cascade state"):
        kgt.chunk(hop, fb, torch.zeros(2, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        kgt.chunk(hop, fb, st.cpu())
    with pytest.raises(ValueError, match="multiple"):
        kgt.chunk(hop[:, :0], fb, st)                           # no sub-block
    # Any sub-block length runs: g = 40 from a carried state, as the twin.
    fb40 = gt.filterbank(16000.0, 16, 50.0, 40, cuda)
    wave = _wave(cuda, 2, 3200, 5)
    st40 = kgt.chunk_plain(wave[:, :1600], fb40, st)[0]
    out_k = kgt.chunk(wave[:, 1600:].contiguous(), fb40, st40)
    out_p = kgt.chunk_plain(wave[:, 1600:].contiguous(), fb40, st40)
    torch.testing.assert_close(out_k[1], out_p[1], rtol=5e-3, atol=1e-6)
    torch.testing.assert_close(out_k[0], out_p[0], rtol=5e-3, atol=1e-5)

    r = res.init_reservoir(ReservoirConfig(num_neurons=256, num_output_neurons=128,
                                           small_world_k=32, mean_weight=0.02), 32,
                           device=cuda)
    ops, kw = r.kernel_operands()
    del kw["n_win"]
    kw.update(win_len=40, n_new_win=1)
    x = torch.zeros(2, 32, 40, dtype=torch.uint8, device=cuda)
    v, s = torch.zeros(2, 256, device=cuda), torch.zeros(2, 256, device=cuda)
    refrac = torch.zeros(2, 256, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        klif.lif_chunk(x, *ops, v, refrac.float(), s, **kw)
    with pytest.raises(TypeError):
        klif.lif_chunk(x.float(), *ops, v, refrac, s, **kw)
    with pytest.raises(ValueError):
        klif.lif_chunk(x, *ops, v, refrac.cpu(), s, **kw)
    with pytest.raises(ValueError, match="windows"):
        klif.lif_chunk(x, *ops, v, refrac, s, **{**kw, "win_len": 30})
    # 1100 neurons (N_pad 1152) run on the block body, bit-equal to the twin.
    big = res.init_reservoir(ReservoirConfig(num_neurons=1100, small_world_k=32,
                                             mean_weight=0.02), 32, device=cuda).dyadic()
    ops_b, kw_b = big.kernel_operands()
    del kw_b["n_win"]
    n_b = ops_b[0].shape[0]
    state = (torch.zeros(2, n_b, device=cuda), torch.zeros(2, n_b, dtype=torch.int32, device=cuda),
             torch.zeros(2, n_b, device=cuda))
    x_b = torch.as_tensor((np.random.default_rng(3).random((2, 32, 40)) < 0.3)
                          .astype(np.uint8)).to(cuda)
    out_k = klif.lif_chunk(x_b, *ops_b, *state, **kw_b, win_len=40, n_new_win=1)
    out_p = klif.lif_chunk_plain(x_b, *ops_b, *state, **kw_b, win_len=40, n_new_win=1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, p) for a, p in zip(out_k, out_p))
    # So do wider ones: 4200 neurons (N_pad 4224, 33 blocks) on B4, bit-equal.
    wide_r = res.init_reservoir(ReservoirConfig(num_neurons=4200, small_world_k=32,
                                                mean_weight=0.02), 32, device=cuda).dyadic()
    ops_w, kw_w = wide_r.kernel_operands()
    del kw_w["n_win"]
    n_w = ops_w[0].shape[0]
    assert n_w == 4224
    state_w = (torch.zeros(2, n_w, device=cuda),
               torch.zeros(2, n_w, dtype=torch.int32, device=cuda),
               torch.zeros(2, n_w, device=cuda))
    held = BlockCounts("lsm_lif_chunk")
    out_k = klif.lif_chunk(x_b, *ops_w, *state_w, **kw_w, win_len=40, n_new_win=1)
    held.held(x_b, n_w, n_w // 128, 40)
    out_p = klif.lif_chunk_plain(x_b, *ops_w, *state_w, **kw_w, win_len=40, n_new_win=1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, p) for a, p in zip(out_k, out_p))
    # What the block body refuses: a width that is no multiple of 128.
    n_r = 4160
    ragged = (torch.zeros(n_r, n_r, dtype=torch.bfloat16, device=cuda),
              torch.zeros(128, n_r, dtype=torch.bfloat16, device=cuda),
              torch.ones(n_r, device=cuda))
    with pytest.raises(ValueError, match="N_pad"):
        klif.lif_chunk(x, *ragged, torch.zeros(2, n_r, device=cuda),
                       torch.zeros(2, n_r, dtype=torch.int32, device=cuda),
                       torch.zeros(2, n_r, device=cuda), **kw_b, win_len=40, n_new_win=1)


def _dense_both_bit_equal(cuda, r, x):
    """B2 over x and B4 over three chained chunks of it (a spike vector
    carried between them), each bit-equal to its twin; returns the twin's
    spike total."""
    ops, kw = r.kernel_operands()
    before = _build.launches["lsm_lif_stats"]
    stats, counts = klif.lif_stats(x, *ops, **kw)
    assert _build.launches["lsm_lif_stats"] == before + 1
    ref_stats, ref_counts = klif.lif_stats_plain(x, *ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(stats, ref_stats) and torch.equal(counts, ref_counts)
    equal, carried = _chained_chunks(cuda, r, x, klif.lif_chunk, klif.lif_chunk_plain)
    assert equal and carried > 0
    return float(ref_counts.sum())


def _chained_chunks(cuda, r, x, run, reference):
    """Three chained 40-step B4 chunks of x from a zero state through run
    and reference (each called as lif_chunk is): (every output bit-equal,
    spikes carried into the second and third chunk)."""
    ops, kw = r.kernel_operands()
    del kw["n_win"]
    kw.update(win_len=40, n_new_win=1)
    b, n_pad = x.shape[0], ops[0].shape[0]
    state_k = state_p = (torch.zeros(b, n_pad, device=cuda),
                         torch.zeros(b, n_pad, dtype=torch.int32, device=cuda),
                         torch.zeros(b, n_pad, device=cuda))
    equal, carried = True, 0.0
    for c in range(3):
        xc = x[..., c * 40:(c + 1) * 40].contiguous()
        carried += float(state_k[2].sum())
        out_k = run(xc, *ops, *state_k, **kw)
        out_p = reference(xc, *ops, *state_p, **kw)
        torch.cuda.synchronize()
        equal = equal and all(torch.equal(a, q) for a, q in zip(out_k, out_p))
        state_k, state_p = out_k[:3], out_p[:3]
    return equal, carried


def _dense_cfg(n_neurons, mean_weight=None):
    return ReservoirConfig(num_neurons=n_neurons, num_output_neurons=min(400, n_neurons),
                           small_world_k=int(0.2 * n_neurons),
                           mean_weight=mean_weight or (0.0114 if n_neurons >= 1000 else 0.02))


@pytest.mark.parametrize("n_neurons,channels,batch", [
    (100, 32, 9),       # N_pad 128: K = 2
    (300, 32, 37),      # N_pad 384: K = 6, not a power of two
    (1000, 128, 1),     # the flagship width, one stream
    (1000, 128, 200),   # the flagship width, a ragged last round
])
def test_cluster_body_bit_equal_on_dyadic_weights(cuda, n_neurons, channels, batch):
    """The cluster body (B2, and B4 over three chained chunks with the
    spike vector carried) against the twins on dyadic weights."""
    r = res.init_reservoir(_dense_cfg(n_neurons), channels, device=cuda).dyadic()
    x = torch.as_tensor((np.random.default_rng(batch).random((batch, channels, 120)) < 0.1)
                        .astype(np.uint8)).to(cuda)
    ops, kw = r.kernel_operands()
    n_pad = ops[0].shape[0]
    plan = klif.card_plan(x, n_pad, kw["refractory"], chunk=False)
    assert plan.body == klif.CLUSTER and plan.cluster_size * 64 == n_pad
    if batch == 200:
        assert batch % plan.streams                  # the last round is ragged
    before = dense_body_launches(klif.CLUSTER)
    assert _dense_both_bit_equal(cuda, r, x) > 0
    assert dense_body_launches(klif.CLUSTER) == before + 4


def test_cluster_body_equals_one_thread_body_on_calibrated_weights(cuda):
    """On weights that are not dyadic the sums round, so only the same
    sums in the same order give the same bits: the cluster body and the
    one-thread body at the flagship shape, B2 and three chained B4 chunks."""
    r = res.init_reservoir(ReservoirConfig(mean_weight=0.0114), 128, device=cuda)
    x = torch.as_tensor((np.random.default_rng(11).random((70, 128, 400)) < 0.05)
                        .astype(np.uint8)).to(cuda)
    ops, kw = r.kernel_operands()
    one = klif.card_plan(x, 1024, kw["refractory"], chunk=False, body=klif.ONE_THREAD)
    assert klif.card_plan(x, 1024, kw["refractory"], chunk=False).cluster_size == 16
    out = klif.lif_stats(x, *ops, **kw)
    ref = klif.lif_stats(x, *ops, **kw, plan=one)
    torch.cuda.synchronize()
    assert all(torch.equal(a, q) for a, q in zip(out, ref)) and out[1].sum() > 0

    def one_thread(xc, *args, **kws):
        plan = klif.card_plan(xc, 1024, kws["refractory"], chunk=True, body=klif.ONE_THREAD)
        return klif.lif_chunk(xc, *args, **kws, plan=plan)

    before = dense_body_launches(klif.CLUSTER)
    equal, carried = _chained_chunks(cuda, r, x, klif.lif_chunk, one_thread)
    assert dense_body_launches(klif.CLUSTER) == before + 3
    assert equal and carried > 0


@pytest.mark.parametrize("steps", [2, 4])
def test_cluster_body_back_to_back_short_rounds(cuda, steps):
    """Rounds of an even number of steps, one after another: a round's step 0
    sends into the buffer and barrier phase that the round before read and
    waited on in its last step, so a cluster barrier must end every round.
    B2 and B4 (from a carried state that fires) at the flagship width, 2400
    streams in many rounds at a 30 % input rate, against the one-thread body
    on calibrated weights."""
    r = res.init_reservoir(ReservoirConfig(mean_weight=0.0114), 128, device=cuda)
    rng = np.random.default_rng(steps)
    x = torch.as_tensor((rng.random((2400, 128, steps)) < 0.3).astype(np.uint8)).to(cuda)
    ops, kw = r.kernel_operands()
    plan = klif.card_plan(x, 1024, kw["refractory"], chunk=False)
    assert plan.body == klif.CLUSTER and plan.rounds >= 10
    one = klif.card_plan(x, 1024, kw["refractory"], chunk=False, body=klif.ONE_THREAD)
    out = klif.lif_stats(x, *ops, **kw)
    ref = klif.lif_stats(x, *ops, **kw, plan=one)
    torch.cuda.synchronize()
    assert all(torch.equal(a, q) for a, q in zip(out, ref)) and out[1].sum() > 2400 * steps

    del kw["n_win"]
    kw.update(win_len=steps, n_new_win=1)
    state = (torch.zeros(2400, 1024, device=cuda),
             torch.zeros(2400, 1024, dtype=torch.int32, device=cuda),
             torch.as_tensor((rng.random((2400, 1024)) < 0.05).astype(np.float32)).to(cuda))
    one_c = klif.card_plan(x, 1024, kw["refractory"], chunk=True, body=klif.ONE_THREAD)
    out = klif.lif_chunk(x, *ops, *state, **kw)
    ref = klif.lif_chunk(x, *ops, *state, **kw, plan=one_c)
    torch.cuda.synchronize()
    assert all(torch.equal(a, q) for a, q in zip(out, ref)) and out[2].sum() > 0


def test_card_plan_is_asked_once_and_sized_by_the_kernel(cuda):
    """card_plan computes a shape's plan once; its shared memory is what
    csrc/lif.cu lays out (barriers, slices, spike and input words, source
    lists) at its M streams."""
    x = torch.zeros(256, 128, 400, dtype=torch.uint8, device=cuda)
    plan = klif.card_plan(x, 1024, 2, chunk=False)
    assert klif.card_plan(x, 1024, 2, chunk=False) is plan
    m = plan.streams
    expected = 16 + 131_072 + 16_384 + 8 * m * 32 + 4 * 32 * m * 4 + 2 * m * 1024
    assert plan.smem_bytes == klif.cluster_smem(1024, 128, m) == expected


@pytest.mark.parametrize("n_neurons,channels,body", [
    (1000, 2048, klif.ONE_THREAD),   # redundancy 16: W_in's 256 KB slice does not fit
    (1100, 128, klif.BLOCK),         # N_pad 1152: above one CTA's 1024 neurons
])
def test_dense_plan_boundaries_launch_their_bodies(cuda, n_neurons, channels, body):
    r = res.init_reservoir(_dense_cfg(n_neurons, 0.01), channels, device=cuda).dyadic()
    x = torch.as_tensor((np.random.default_rng(channels).random((3, channels, 120)) < 0.05)
                        .astype(np.uint8)).to(cuda)
    ops, kw = r.kernel_operands()
    assert klif.card_plan(x, ops[0].shape[0], kw["refractory"], chunk=False).body == body
    before = dense_body_launches(body)
    assert _dense_both_bit_equal(cuda, r, x) > 0
    assert dense_body_launches(body) == before + 4


@pytest.mark.parametrize("n_neurons", [1100, 2048])
def test_wide_dense_lif_kernels_bit_equal(cuda, n_neurons):
    """Dense reservoirs above 1024 padded neurons (B2 and B4 on the block
    body) against their twins on dyadic weights."""
    cfg = ReservoirConfig(num_neurons=n_neurons, small_world_k=int(0.2 * n_neurons),
                          mean_weight=0.01)
    r = res.init_reservoir(cfg, 128, device=cuda).dyadic()
    rng = np.random.default_rng(n_neurons)
    x = torch.as_tensor((rng.random((4, 128, 120)) < 0.1).astype(np.uint8)).to(cuda)
    assert _dense_both_bit_equal(cuda, r, x) > 0


@pytest.mark.parametrize("n_neurons,channels", [
    (100, 256),      # --num-neurons 100 --n-filters 256: C = 256 > N_pad = 128
    (1000, 2048),    # redundancy_factor=16 at 1000 neurons: C = 2048 > N_pad = 1024
])
def test_dense_lif_kernels_take_more_channels_than_neurons(cuda, n_neurons, channels):
    """Dense B2/B4 with more input channels than padded neurons (thread n
    compacts channels n, n + N_pad, ...), bit-equal on dyadic weights."""
    cfg = ReservoirConfig(num_neurons=n_neurons, num_output_neurons=min(400, n_neurons),
                          small_world_k=int(0.2 * n_neurons), mean_weight=0.01)
    r = res.init_reservoir(cfg, channels, device=cuda).dyadic()
    assert r.kernel_operands()[0][0].shape[0] < channels
    x = torch.as_tensor((np.random.default_rng(channels).random((5, channels, 120)) < 0.05)
                        .astype(np.uint8)).to(cuda)
    assert _dense_both_bit_equal(cuda, r, x) > 0


@pytest.mark.parametrize("n_neurons", [1100, 2048])
def test_block_body_bit_equal_at_refractory_300(cuda, n_neurons):
    """A refractory period past the 8-bit counter (the 16-bit one): dense
    B2/B4 above 1024 padded neurons, B5, and B6 over chained chunks, each
    bit-equal on dyadic weights; the carried counts cross chunk ends."""
    cfg = ReservoirConfig(num_neurons=n_neurons, small_world_k=int(0.2 * n_neurons),
                          mean_weight=0.01, refractory_period=300)
    x = torch.as_tensor((np.random.default_rng(7).random((4, 128, 120)) < 0.1)
                        .astype(np.uint8)).to(cuda)
    r = res.init_reservoir(cfg, 128, device=cuda).dyadic()
    assert r.kernel_operands()[1]["refractory"] == 300
    assert _dense_both_bit_equal(cuda, r, x) > 0
    sr = _sparse(cuda, 1024, 204, 4, 128, 0.01)
    ops, kw = sr.kernel_operands()
    kw["refractory"] = 300
    stats, counts = ksp.sparse_lif_stats(x, *ops, **kw)
    ref_stats, ref_counts = ksp.sparse_lif_stats_plain(x, *ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(stats, ref_stats) and torch.equal(counts, ref_counts)
    assert counts.sum() > 0
    del kw["n_win"]
    kw.update(win_len=40, n_new_win=1)
    state_k = state_p = (torch.zeros(4, 1024, device=cuda),
                         torch.zeros(4, 1024, dtype=torch.int32, device=cuda),
                         torch.zeros(4, 1024, device=cuda))
    for c in range(3):
        xc = x[..., c * 40:(c + 1) * 40].contiguous()
        out_k = ksp.sparse_lif_chunk(xc, *ops, *state_k, **kw)
        out_p = ksp.sparse_lif_chunk_plain(xc, *ops, *state_p, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, q) for a, q in zip(out_k, out_p))
        state_k, state_p = out_k[:3], out_p[:3]
    assert int(state_k[1].max()) > 255          # a count the 8-bit counter could not hold


def _sparse(cuda, n, k, r, c, mean_weight, seed=3):
    cfg = ReservoirConfig(num_neurons=n, small_world_k=k, sparse_partner_blocks=r,
                          num_output_neurons=min(400, n // 2), mean_weight=mean_weight,
                          input_fanout=6, seed=seed)
    return sparse.init_reservoir_sparse(cfg, c, device=cuda).dyadic()


def test_sparse_init_same_on_card(cuda):
    """One CPU generator draws the sparse reservoir, so the card gets the
    CPU's weights for a seed."""
    cfg = ReservoirConfig(num_neurons=1024, small_world_k=204, mean_weight=0.01, seed=6)
    on_card = sparse.init_reservoir_sparse(cfg, 128, device=cuda)
    on_cpu = sparse.init_reservoir_sparse(cfg, 128)
    for name in ("w_blocks", "src_idx", "w_in", "leak", "w_blocks_bf16", "leak_keep"):
        assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name)), name


class BlockCounts:
    """The block body's counter (`sparse_lif.counts`) over one call of
    `entry`: it must advance by the plan's arithmetic, ceil(B / tile) tiles
    each using and loading every destination block's slots a step."""

    def __init__(self, entry):
        self.entry = entry
        self.before = ksp.counts.copy()

    def held(self, x, n, slots, steps):
        B, C = x.shape[:2]
        plan = ksp.card_block_plan(x, n, slots)
        per_step = -(-B // plan.tile) * (n // 128) * (slots + -(-C // 128))
        delta = {f: ksp.counts[f"{self.entry}:{f}"] - self.before[f"{self.entry}:{f}"]
                 for f in ("steps", "block_uses", "block_loads")}
        assert delta == {"steps": steps, "block_uses": steps * per_step,
                         "block_loads": steps * per_step}


@pytest.mark.parametrize("n,k,r,c,t,b,mw", [
    (384, 76, 2, 32, 40, 5, 0.02),
    (384, 76, 2, 32, 45, 4, 0.02),        # T % n_win != 0: the last window folds
    (10240, 2048, 4, 128, 400, 8, 0.003),  # BASELINE configs[3] width
    (384, 76, 2, 32, 40, 70, 0.02),       # 70 rows: a ragged last stream tile
    (10240, 2048, 4, 128, 400, 70, 0.003),
    # Tilings the persistent CTAs walk: one 64-stream tile (three items at
    # 384 neurons), three 64-stream tiles, and at 10240 neurons four and five
    # 128-stream tiles (320 and 400 items on the card's SMs).
    (384, 76, 2, 32, 40, 1, 0.02),
    (384, 76, 2, 32, 40, 130, 0.02),
    (10240, 2048, 4, 128, 400, 512, 0.003),
    (10240, 2048, 4, 128, 400, 640, 0.003),
])
def test_sparse_lif_kernel_bit_equal_on_dyadic_weights(cuda, n, k, r, c, t, b, mw):
    sr = _sparse(cuda, n, k, r, c, mw)
    x = torch.as_tensor((np.random.default_rng(t).random((b, c, t)) < 0.15)
                        .astype(np.uint8)).to(cuda)
    ops, kw = sr.kernel_operands()
    before = _build.launches["lsm_sparse_lif_stats"]
    held = BlockCounts("lsm_sparse_lif_stats")
    stats, counts = ksp.sparse_lif_stats(x, *ops, **kw)
    assert _build.launches["lsm_sparse_lif_stats"] == before + 1
    held.held(x, n, sr.src_idx.shape[1], t)
    ref_stats, ref_counts = ksp.sparse_lif_stats_plain(x, *ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(stats, ref_stats)
    assert torch.equal(counts, ref_counts)
    assert counts.sum() > 0


def test_sparse_lif_kernel_equals_dense_kernel_on_densify(cuda):
    """B5 on the block-sparse reservoir == B2 on its densified matrix."""
    sr = _sparse(cuda, 1024, 204, 4, 128, 0.01)
    x = torch.as_tensor((np.random.default_rng(8).random((6, 128, 200)) < 0.1)
                        .astype(np.uint8)).to(cuda)
    ops, kw = sr.kernel_operands()
    stats, counts = ksp.sparse_lif_stats(x, *ops, **kw)
    d_ops, d_kw = sparse.densify(sr).kernel_operands()
    d_stats, d_counts = klif.lif_stats(x, *d_ops, **d_kw)
    torch.cuda.synchronize()
    assert torch.equal(stats, d_stats) and torch.equal(counts, d_counts)
    assert counts.sum() > 0


@pytest.mark.parametrize("n,n_new_win,b", [
    (384, 1, 6), (384, 2, 6), (10240, 1, 6),
    # Stream counts that are no multiple of the stream tile. The body takes
    # 128-stream tiles when a step still has two tiles for every SM, else 64:
    # on a 132-SM H100 at 10240 neurons (80 blocks) 70 and 383 streams run
    # on 64-stream tiles, 390, just past the switch, on 128-stream tiles.
    (384, 1, 70), (10240, 1, 70), (10240, 1, 383), (10240, 1, 390),
    # One 64-stream tile, an odd number of them, an even and an odd number
    # of 128-stream tiles.
    (384, 1, 1), (384, 1, 130), (10240, 1, 512), (10240, 1, 640),
])
def test_sparse_chunk_kernel_bit_equal_over_chained_chunks(cuda, n, n_new_win, b):
    c = 128
    sr = _sparse(cuda, n, int(0.2 * n), 4 if n > 1000 else 2, c,
                 0.003 if n > 1000 else 0.02)
    ops, kw = sr.kernel_operands()
    del kw["n_win"]
    kw.update(win_len=40, n_new_win=n_new_win)
    rng = np.random.default_rng(n_new_win)
    state_k = state_p = (torch.zeros(b, n, device=cuda),
                         torch.zeros(b, n, dtype=torch.int32, device=cuda),
                         torch.zeros(b, n, device=cuda))
    carried = 0.0
    for _ in range(3):
        x = torch.as_tensor(
            (rng.random((b, c, 40 * n_new_win)) < 0.15).astype(np.uint8)).to(cuda)
        carried += float(state_k[2].sum())
        before = _build.launches["lsm_sparse_lif_chunk"]
        held = BlockCounts("lsm_sparse_lif_chunk")
        out_k = ksp.sparse_lif_chunk(x, *ops, *state_k, **kw)
        assert _build.launches["lsm_sparse_lif_chunk"] == before + 1
        held.held(x, n, sr.src_idx.shape[1], 40 * n_new_win)
        out_p = ksp.sparse_lif_chunk_plain(x, *ops, *state_p, **kw)
        torch.cuda.synchronize()
        for a, p in zip(out_k, out_p):
            assert a.dtype == p.dtype and torch.equal(a, p)
        state_k, state_p = out_k[:3], out_p[:3]
    assert carried > 0                    # the carried spike vector was exercised


def test_sparse_kernels_refuse_what_they_cannot_run(cuda):
    sr = _sparse(cuda, 256, 52, 2, 16, 0.03)
    ops, kw = sr.kernel_operands()
    x = torch.zeros(2, 16, 40, dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        ksp.sparse_lif_stats(x.float(), *ops, **kw)
    with pytest.raises(TypeError):
        ksp.sparse_lif_stats(x, sr.w_blocks, *ops[1:], **kw)        # f32 weights
    with pytest.raises(TypeError):
        ksp.sparse_lif_stats(x, ops[0], ops[1].long(), *ops[2:], **kw)
    with pytest.raises(ValueError, match="channels"):
        ksp.sparse_lif_stats(torch.zeros(2, 200, 40, dtype=torch.uint8, device=cuda),
                             *ops, **kw)
    with pytest.raises(ValueError, match="devices"):
        ksp.sparse_lif_stats(x.cpu(), *ops, **kw)
    # The stream-tiled body keeps no reservoir in shared memory: 20480
    # neurons run (silent, on zero weights and input).
    nb = 160
    wide = (torch.zeros(nb, 1, 128, 128, dtype=torch.bfloat16, device=cuda),
            torch.arange(nb, dtype=torch.int32, device=cuda)[:, None].contiguous(),
            torch.zeros(128, nb * 128, dtype=torch.bfloat16, device=cuda),
            torch.ones(nb * 128, device=cuda))
    stats, counts = ksp.sparse_lif_stats(x, *wide, **kw)
    torch.cuda.synchronize()
    assert counts.shape == (2, nb * 128) and not counts.any() and not stats[0].any()
    # Its real limit: refrac is kept in at most 16 bits between steps; 256,
    # past the 8-bit counter, runs on the 16-bit one.
    with pytest.raises(ValueError, match="refractory"):
        ksp.sparse_lif_stats(x, *ops, **{**kw, "refractory": 65536})
    wide_r = ksp.sparse_lif_stats(x, *ops, **{**kw, "refractory": 256})
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(
        wide_r, ksp.sparse_lif_stats_plain(x, *ops, **{**kw, "refractory": 256})))
    # Weights at any alignment (each call copies the blocks K-major first).
    flat = torch.zeros(ops[0].numel() + 1, dtype=torch.bfloat16, device=cuda)
    flat[1:] = ops[0].flatten()
    x_on = torch.as_tensor((np.random.default_rng(2).random((2, 16, 40)) < 0.3)
                           .astype(np.uint8)).to(cuda)
    shifted = ksp.sparse_lif_stats(x_on, flat[1:].view(ops[0].shape), *ops[1:], **kw)
    aligned = ksp.sparse_lif_stats(x_on, *ops, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(shifted, aligned)) and aligned[1].any()
    del kw["n_win"]
    kw.update(win_len=40, n_new_win=1)
    v, s = torch.zeros(2, 256, device=cuda), torch.zeros(2, 256, device=cuda)
    refrac = torch.zeros(2, 256, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ksp.sparse_lif_chunk(x, *ops, v, refrac.float(), s, **kw)
    with pytest.raises(ValueError):
        ksp.sparse_lif_chunk(x, *ops, v, refrac.cpu(), s, **kw)
    with pytest.raises(ValueError):
        ksp.sparse_lif_chunk(x, *ops, v[:, :128].contiguous(), refrac, s, **kw)
    with pytest.raises(ValueError, match="windows"):
        ksp.sparse_lif_chunk(x, *ops, v, refrac, s, **{**kw, "win_len": 30})


HYST_THRESHOLDS = {1: (0.5,), 4: FrontendConfig().spike_thresholds,
                   7: (0.3, 0.95, 0.2, 0.6, 0.8, 0.45, 0.7)}


def _hyst_spec(shape, thresholds, gap, seed):
    """Spectrogram values in [0, 1] with a run exactly on the ON thresholds
    and the OFF levels, and NaNs, in the first (row, filter) of each layout."""
    spec = np.random.default_rng(seed).random(shape).astype(np.float32)
    on, off = hyst.levels(thresholds, gap)
    edges = np.concatenate([on, off, [np.nan]]).astype(np.float32)
    flat = spec.reshape(-1, spec.shape[-1])
    flat[0, ::2] = np.resize(edges, flat[0, ::2].shape)
    flat[1, 3::7] = np.nan
    return spec


@pytest.mark.parametrize("n_thr", [1, 4, 7])
def test_hysteresis_kernel_bit_equal_at_batch_shape(cuda, n_thr):
    """The kernel against its plain twin on the batch path's contiguous
    (B, F, T) spectrogram: the batch entry (all-off start, no state out)
    and the carried-state entry from a random state, which it must not
    write."""
    thr, gap = HYST_THRESHOLDS[n_thr], 0.1
    on, off = hyst.levels(thr, gap)
    spec = torch.as_tensor(_hyst_spec((37, 128, 100), thr, gap, n_thr)).to(cuda)
    state = torch.as_tensor(np.random.default_rng(n_thr).random((37, n_thr, 128)) < 0.5).to(cuda)
    keep = state.clone()
    before = _build.launches["lsm_hysteresis_encode"]
    spikes = hyst.hysteresis_encode(spec, thr, gap)
    step_spikes, step_state = hyst.hysteresis_encode_step(spec, state, thr, gap)
    assert _build.launches["lsm_hysteresis_encode"] == before + 2
    zeros = torch.zeros_like(state)
    ref_spikes = khyst.encode_plain(spec, zeros, on, off)[0]
    ref_step, ref_state = khyst.encode_plain(spec, state, on, off)
    torch.cuda.synchronize()
    assert spikes.shape == (37, 128, 100 * n_thr) and spikes.dtype == torch.uint8
    assert torch.equal(spikes, ref_spikes) and spikes.any()
    assert torch.equal(step_spikes, ref_step) and torch.equal(step_state, ref_state)
    assert torch.equal(state, keep)
    assert not torch.equal(step_spikes, spikes)     # the carried state mattered


@pytest.mark.parametrize("n_thr", [1, 4, 7])
def test_hysteresis_kernel_chained_on_the_serving_layout(cuda, n_thr):
    """The serving engine's layout: each hop's 10 bins as the (B, F, T)
    view of a contiguous (T, B, F) tensor, the state threaded hop to hop;
    every hop bit-equal to the twin, and the hops together to one
    whole-signal call on the contiguous layout."""
    thr, gap = HYST_THRESHOLDS[n_thr], 0.1
    on, off = hyst.levels(thr, gap)
    spec = torch.as_tensor(_hyst_spec((37, 128, 100), thr, gap, 10 + n_thr)).to(cuda)
    whole = spec.permute(2, 0, 1).contiguous()                          # (T, B, F)
    state = torch.zeros(37, n_thr, 128, dtype=torch.bool, device=cuda)
    twin_state = state
    hops = []
    for s in range(0, 100, 10):
        view = whole[s:s + 10].clone().permute(1, 2, 0)              # (B, F, 10)
        assert view.stride() == (128, 1, 37 * 128)
        spikes, state = hyst.hysteresis_encode_step(view, state, thr, gap)
        twin, twin_state = khyst.encode_plain(view, twin_state, on, off)
        torch.cuda.synchronize()
        assert torch.equal(spikes, twin) and torch.equal(state, twin_state)
        hops.append(spikes)
    one = hyst.hysteresis_encode(spec, thr, gap)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(hops, dim=-1), one) and one.any()


@pytest.mark.parametrize("n_thr,layout", [(4, "batch"), (7, "engine")])
def test_hysteresis_kernel_bit_equal_over_several_tiles(cuda, n_thr, layout):
    """Past 128 bins the kernel walks a row in several tiles, the triggers
    carried between them."""
    thr, gap = HYST_THRESHOLDS[n_thr], 0.1
    on, off = hyst.levels(thr, gap)
    spec = torch.as_tensor(_hyst_spec((3, 50, 300), thr, gap, 20 + n_thr)).to(cuda)
    if layout == "engine":
        spec = spec.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    state = torch.as_tensor(np.random.default_rng(n_thr).random((3, n_thr, 50)) < 0.5).to(cuda)
    spikes, new = hyst.hysteresis_encode_step(spec, state, thr, gap)
    ref, ref_state = khyst.encode_plain(spec, state, on, off)
    torch.cuda.synchronize()
    assert torch.equal(spikes, ref) and torch.equal(new, ref_state) and spikes.any()


def test_hysteresis_kernel_refuses_what_it_cannot_run(cuda):
    spec = torch.rand(2, 8, 10, device=cuda)
    with pytest.raises(ValueError, match="thresholds"):
        hyst.hysteresis_encode(spec, np.linspace(0.1, 0.9, 33), 0.05)
    with pytest.raises(TypeError, match="float32"):
        hyst.hysteresis_encode(spec.double(), (0.5,), 0.1)
    with pytest.raises(TypeError, match="bool"):
        hyst.hysteresis_encode_step(spec, torch.zeros(2, 1, 8, device=cuda), (0.5,), 0.1)
    with pytest.raises(ValueError, match="gap"):
        hyst.hysteresis_encode(spec, (0.5,), -0.1)
    # 32 thresholds is the kernel's limit, and runs.
    thr = np.linspace(0.02, 0.98, 32)
    on, off = hyst.levels(thr, 0.01)
    out = hyst.hysteresis_encode(spec, thr, 0.01)
    torch.cuda.synchronize()
    off_state = torch.zeros(2, 32, 8, dtype=torch.bool, device=cuda)
    assert torch.equal(out, khyst.encode_plain(spec, off_state, on, off)[0])


def test_hysteresis_kernel_launches_once_a_call(cuda):
    """featurize_batch and each ContinuousKWS.step launch the kernel once."""
    fcfg = FrontendConfig()
    audio, _ = dataset.synthetic_audio_batch_hard(1, 12, seed=5)
    before = _build.launches["lsm_hysteresis_encode"]
    featurize_batch(torch.as_tensor(audio[:4]).to(cuda), fcfg)
    assert _build.launches["lsm_hysteresis_encode"] == before + 1
    r = res.init_reservoir(ReservoirConfig(num_neurons=128, num_output_neurons=64), fcfg.n_filters,
                           mean_weight=0.01, device=cuda)
    d = len(FEATURE_SETS["original"]) * r.n_outputs
    kws = ContinuousKWS(r, logistic.LogisticReadout(torch.zeros(d, 12, device=cuda),
                                                    torch.zeros(12, device=cuda)),
                        scaler.Scaler(torch.zeros(d, device=cuda), torch.ones(d, device=cuda)),
                        fcfg, "original", n_streams=3)
    wire = (np.clip(audio[:3, :3200], -1, 1) * 32767).astype(np.int16)
    for c in range(2):
        before = _build.launches["lsm_hysteresis_encode"]
        kws.step(np.ascontiguousarray(wire[:, c * 1600:(c + 1) * 1600]))
        assert _build.launches["lsm_hysteresis_encode"] == before + 1


# The benchmark's calibrated mean weights (benchmark/configs/): the flagship
# dense reservoir at the edge of chaos, the 10240-neuron sparse one
# sub-critical, so the rings hold busy and silent outputs alike.
FLAGSHIP_WEIGHT, SCALED10K_WEIGHT = 0.010725368437499999, 0.002963560740152995


def _serving_engine(cuda, kind, n_streams, feature_set):
    fcfg = FrontendConfig()
    if kind == "dense":
        r = res.init_reservoir(ReservoirConfig(), fcfg.n_filters, mean_weight=FLAGSHIP_WEIGHT,
                               device=cuda)
    else:
        cfg = ReservoirConfig(num_neurons=10240, small_world_k=2048, sparse_partner_blocks=4,
                              input_fanout=8)
        r = sparse.init_reservoir_sparse(cfg, fcfg.n_filters, mean_weight=SCALED10K_WEIGHT,
                                         device=cuda)
    d = len(FEATURE_SETS[feature_set]) * r.n_outputs
    rng = np.random.default_rng(n_streams)
    ro = logistic.LogisticReadout(
        torch.as_tensor(rng.normal(0, 0.01, (d, 12)).astype(np.float32)).to(cuda),
        torch.zeros(12, device=cuda))
    sc = scaler.Scaler(torch.as_tensor(rng.random(d).astype(np.float32)).to(cuda),
                       torch.as_tensor((rng.random(d) + 0.5).astype(np.float32)).to(cuda))
    return ContinuousKWS(r, ro, sc, fcfg, feature_set, n_streams=n_streams)


def _serving_wire(n_streams, hops):
    """(n_streams, hops * 1600) int16: each stream a window of two hard-corpus
    utterances from its own offset."""
    audio, _ = dataset.synthetic_audio_batch_hard(2, 12, seed=19)
    wave = np.concatenate([audio, audio[::-1]], axis=1)               # (24, 32000)
    n = hops * 1600
    s = np.arange(n_streams)
    off = (s * 311) % (wave.shape[1] - n)
    rows = wave[(s % wave.shape[0])[:, None], off[:, None] + np.arange(n)]
    return (np.clip(rows, -1, 1) * 32767).astype(np.int16)


@pytest.mark.parametrize("kind,n_streams", [("dense", 4096), ("sparse", 1024)])
@pytest.mark.parametrize("feature_set", ["original", "all"])
def test_fold_kernel_bit_equal_to_its_twin_on_serving_rings(cuda, kind, n_streams, feature_set):
    """Eleven chained hops of the engine at the serving cells' shapes: each
    hop launches the fold kernel once, and its rings, window ring and logits
    equal the plain twin's on the same state and reservoir output;
    features() (one fold-only launch) equals the twin's features of that
    hop, all bit for bit."""
    kws = _serving_engine(cuda, kind, n_streams, feature_set)
    wire = _serving_wire(n_streams, 11)
    sc, ro = kws.scaler_state, kws.readout
    for c in range(11):
        chunk = np.ascontiguousarray(wire[:, c * 1600:(c + 1) * 1600])
        st = kws.state
        spikes = kws._featurize(decode_pcm_device(torch.as_tensor(chunk).to(cuda)), st)[0]
        new_seg, win_new = kws._reservoir_chunk(spikes, st)[3:]
        segs, win, feats = kfold.fold_plain(st.segs, st.win_ring, kws._t_c,
                                            kws.reservoir.burst_isi_max, kws.keys,
                                            new_seg, win_new)
        logits = ((feats - sc.mean) / sc.scale @ ro.w + ro.b).cpu().numpy()
        before = _build.launches["lsm_fold_window"]
        out = kws.step(chunk)
        assert _build.launches["lsm_fold_window"] == before + 1
        torch.cuda.synchronize()
        assert all(torch.equal(kws.state.segs[k], segs[k]) for k in klif.SEG_KEYS), c
        assert torch.equal(kws.state.win_ring, win), c
        assert np.array_equal(out, logits), c
        assert np.array_equal(kws.features(), feats.cpu().numpy()), c
        assert _build.launches["lsm_fold_window"] == before + 2
    stats = res.fold_segment_stats(kws.state.segs, kws._t_c, kws.reservoir.burst_isi_max)
    fired = stats["counts"] > 0
    assert fired.any() and not fired.all() and (stats["n_isi"] > 0).any()


@pytest.mark.parametrize("n_win,n_new,n_ring,no", [
    (10, 1, 10, 400),     # the serving cells' rings
    (10, 2, 5, 24),       # rows no multiple of a CTA
    (10, 10, 1, 7),       # a one-slot ring, the whole window ring replaced
    (400, 40, 10, 33),    # one-step rate windows: 200 KB of shared memory a CTA
])
def test_fold_kernel_bit_equal_at_any_ring_shape(cuda, n_win, n_new, n_ring, no):
    """Random rasters cut into segments as the reservoir kernels write them:
    the push and the fold-only mode against the twin, every feature set."""
    seg_len, burst, b = 40, 5, 37
    raster = torch.as_tensor(np.random.default_rng(no).random((b, (n_ring + 1) * seg_len, no))
                             < 0.15).to(cuda)
    raster[:, :, 0] = False                                           # a silent neuron
    sums = [res.segment_summary(raster[:, s * seg_len:(s + 1) * seg_len], burst)
            for s in range(n_ring + 1)]
    segs = {k: torch.stack([sm[k] for sm in sums[:n_ring]]) for k in klif.SEG_KEYS}
    win = torch.as_tensor(np.random.default_rng(n_win).integers(0, 9, (b, no, n_win))
                          .astype(np.float32)).to(cuda)
    win_new = torch.as_tensor(np.random.default_rng(n_new).integers(0, 9, (b, n_new, no))
                              .astype(np.float32)).to(cuda)
    for name, keys in FEATURE_SETS.items():
        args = (segs, win, seg_len, burst, keys)
        before = _build.launches["lsm_fold_window"]
        out = kfold.fold(*args, sums[n_ring], win_new)
        only = kfold.fold(*args)
        assert _build.launches["lsm_fold_window"] == before + 2
        ref = kfold.fold_plain(*args, sums[n_ring], win_new)
        ref_only = kfold.fold_plain(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(out[0][k], ref[0][k]) for k in klif.SEG_KEYS), name
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2]), name
        assert only[0] is segs and only[1] is win and torch.equal(only[2], ref_only[2]), name
        assert out[2].abs().sum() > 0


def test_fold_kernel_refuses_what_it_cannot_run(cuda):
    segs = {k: torch.zeros(2, 3, 8, device=cuda) for k in klif.SEG_KEYS}
    keys = FEATURE_SETS["original"]
    with pytest.raises(ValueError, match="rate windows"):
        kfold.fold(segs, torch.zeros(3, 8, kfold.MAX_WINDOWS + 1, device=cuda), 40, 5, keys)
    with pytest.raises(ValueError):
        kfold.fold(segs, torch.zeros(3, 8, 10), 40, 5, keys)         # the window ring on the CPU
    with pytest.raises(TypeError):
        kfold.fold({**segs, "counts": segs["counts"].half()}, torch.zeros(3, 8, 10, device=cuda),
                   40, 5, keys)
    # No streams: nothing to launch.
    empty = {k: torch.zeros(2, 0, 8, device=cuda) for k in klif.SEG_KEYS}
    before = _build.launches["lsm_fold_window"]
    out = kfold.fold(empty, torch.zeros(0, 8, 10, device=cuda), 40, 5, keys)
    assert out[2].shape == (0, 5 * 8) and _build.launches["lsm_fold_window"] == before
