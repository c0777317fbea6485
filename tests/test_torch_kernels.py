"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Every test here needs a CUDA device and skips without one.

This file imports no jax and nothing of lsm_tpu, so it also runs where jax
is not installed:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from lsm_tpu_torch.config import FrontendConfig, ReservoirConfig
from lsm_tpu_torch.io import dataset
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models import sparse
from lsm_tpu_torch.models.frontend import featurize_batch
from lsm_tpu_torch.ops import gammatone as gt
from lsm_tpu_torch.ops.kernels import gtgram as kgt
from lsm_tpu_torch.ops.kernels import lif as klif
from lsm_tpu_torch.ops.kernels import sparse_lif as ksp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _wave(cuda, batch, samples, seed):
    return torch.as_tensor(
        (np.random.default_rng(seed).standard_normal((batch, samples)) * 0.2).astype(np.float32)
    ).to(cuda)


@pytest.mark.parametrize("batch,channels", [(70, 128), (3, 32), (5, 200)])
def test_gtgram_kernel_matches_plain(cuda, batch, channels):
    wave = _wave(cuda, batch, 16000, batch)
    fb = gt.filterbank(16000.0, channels, 50.0, 80, cuda)
    before = kgt.launches
    out = kgt.sub_energy(wave, fb)
    assert kgt.launches == before + 1
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
    before = klif.launches
    stats, all_counts = klif.lif_stats(spikes, *ops, **kw)
    assert klif.launches == before + 1
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
    before = kgt.chunk_launches
    s_out, e = kgt.chunk(hop, fb, state)
    assert kgt.chunk_launches == before + 1
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
        before = klif.chunk_launches
        out_k = klif.lif_chunk(x, *ops, *state_k, **kw)
        assert klif.chunk_launches == before + 1
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
    # 1100 neurons (N_pad 1152) run on the block body, bit-equal to the twin;
    # N_pad 4224 is past the largest dense reservoir the port draws.
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
    n_w = 4224
    wide = (torch.zeros(n_w, n_w, dtype=torch.bfloat16, device=cuda),
            torch.zeros(128, n_w, dtype=torch.bfloat16, device=cuda),
            torch.ones(n_w, device=cuda))
    with pytest.raises(ValueError, match="N_pad"):
        klif.lif_chunk(x, *wide, torch.zeros(2, n_w, device=cuda),
                       torch.zeros(2, n_w, dtype=torch.int32, device=cuda),
                       torch.zeros(2, n_w, device=cuda), **kw_b, win_len=40, n_new_win=1)


def _dense_both_bit_equal(cuda, r, x):
    """B2 over x and B4 over three chained chunks of it, each bit-equal to
    its twin; returns the twin's spike total."""
    ops, kw = r.kernel_operands()
    before = klif.launches
    stats, counts = klif.lif_stats(x, *ops, **kw)
    assert klif.launches == before + 1
    ref_stats, ref_counts = klif.lif_stats_plain(x, *ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(stats, ref_stats) and torch.equal(counts, ref_counts)
    del kw["n_win"]
    kw.update(win_len=40, n_new_win=1)
    b, n_pad = x.shape[0], ops[0].shape[0]
    state_k = state_p = (torch.zeros(b, n_pad, device=cuda),
                         torch.zeros(b, n_pad, dtype=torch.int32, device=cuda),
                         torch.zeros(b, n_pad, device=cuda))
    for c in range(3):
        xc = x[..., c * 40:(c + 1) * 40].contiguous()
        out_k = klif.lif_chunk(xc, *ops, *state_k, **kw)
        out_p = klif.lif_chunk_plain(xc, *ops, *state_p, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, q) for a, q in zip(out_k, out_p))
        state_k, state_p = out_k[:3], out_p[:3]
    return float(ref_counts.sum())


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


@pytest.mark.parametrize("n,k,r,c,t,b,mw", [
    (384, 76, 2, 32, 40, 5, 0.02),
    (384, 76, 2, 32, 45, 4, 0.02),        # T % n_win != 0: the last window folds
    (10240, 2048, 4, 128, 400, 8, 0.003),  # BASELINE configs[3] width
    (384, 76, 2, 32, 40, 70, 0.02),       # 70 rows: a ragged last stream tile
    (10240, 2048, 4, 128, 400, 70, 0.003),
])
def test_sparse_lif_kernel_bit_equal_on_dyadic_weights(cuda, n, k, r, c, t, b, mw):
    sr = _sparse(cuda, n, k, r, c, mw)
    x = torch.as_tensor((np.random.default_rng(t).random((b, c, t)) < 0.15)
                        .astype(np.uint8)).to(cuda)
    ops, kw = sr.kernel_operands()
    before = ksp.launches
    stats, counts = ksp.sparse_lif_stats(x, *ops, **kw)
    assert ksp.launches == before + 1
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
    # 128-stream tiles when a step still has two CTAs for every SM, else 64:
    # on a 132-SM H100 at 10240 neurons (80 blocks) 70 and 383 streams run
    # on 64-stream tiles, 390, just past the switch, on 128-stream tiles.
    (384, 1, 70), (10240, 1, 70), (10240, 1, 383), (10240, 1, 390),
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
        before = ksp.chunk_launches
        out_k = ksp.sparse_lif_chunk(x, *ops, *state_k, **kw)
        assert ksp.chunk_launches == before + 1
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
