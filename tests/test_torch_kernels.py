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


@pytest.mark.parametrize("batch,channels", [(70, 128), (3, 32)])
def test_gtgram_kernel_matches_plain(cuda, batch, channels):
    wave = torch.as_tensor(
        (np.random.default_rng(batch).standard_normal((batch, 16000)) * 0.2).astype(np.float32)
    ).to(cuda)
    kmat = gt.block_system_tensor(16000.0, channels, 50.0, 80, cuda)
    before = kgt.launches
    out = kgt.sub_energy(wave, kmat)
    assert kgt.launches == before + 1
    ref = kgt.sub_energy_plain(wave, kmat)
    torch.cuda.synchronize()
    assert out.shape == (200, channels, batch)
    torch.testing.assert_close(out, ref, rtol=5e-3, atol=1e-6)


def test_gtgram_kernel_rejects_what_it_cannot_run(cuda):
    wave = torch.zeros(2, 16000 + 4, device=cuda)
    kmat = torch.as_tensor(gt.block_system(16000.0, 8, 50.0, 80)).to(cuda)
    with pytest.raises(ValueError, match="multiple"):
        kgt.sub_energy(torch.zeros(2, 16001, device=cuda), kmat)
    with pytest.raises(ValueError, match="aligned"):
        kgt.sub_energy(wave.view(-1)[1:1 + 32000].view(2, 16000), kmat)
    with pytest.raises(ValueError, match="g=80"):
        kgt.sub_energy(torch.zeros(2, 16000, device=cuda),
                       torch.as_tensor(gt.block_system(16000.0, 8, 50.0, 40)).to(cuda))


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
    wave = torch.as_tensor(
        (np.random.default_rng(seed).standard_normal((batch, 4800)) * 0.2).astype(np.float32)
    ).to(cuda)
    kmat = gt.block_system_tensor(16000.0, channels, 50.0, 80, cuda)
    return kgt.chunk_plain(wave, kmat, torch.zeros(batch, 8, channels, device=cuda))[0]


@pytest.mark.parametrize("batch,channels", [(70, 128), (3, 32)])
def test_gtgram_chunk_kernel_matches_plain(cuda, batch, channels):
    hop = torch.as_tensor(
        (np.random.default_rng(batch + 1).standard_normal((batch, 1600)) * 0.2).astype(np.float32)
    ).to(cuda)
    kmat = gt.block_system_tensor(16000.0, channels, 50.0, 80, cuda)
    state = _carried_state(cuda, batch, channels, batch)
    before = kgt.chunk_launches
    s_out, e = kgt.chunk(hop, kmat, state)
    assert kgt.chunk_launches == before + 1
    s_ref, e_ref = kgt.chunk_plain(hop, kmat, state)
    torch.cuda.synchronize()
    assert e.shape == (20, batch, channels) and s_out.shape == (batch, 8, channels)
    torch.testing.assert_close(e, e_ref, rtol=5e-3, atol=1e-6)
    # The state passes through zero: atol 1e-5 against magnitudes ~0.4
    # (the twin sums x @ W_xs in cuBLAS order, the kernel in one FMA chain).
    torch.testing.assert_close(s_out, s_ref, rtol=5e-3, atol=1e-5)


def test_gtgram_chunk_kernel_chaining_is_exact(cuda):
    """Ten B3 hops threading the state are bit-equal to one whole-second B3
    call, whose energies are B1's (in B1's layout)."""
    wave = torch.as_tensor(
        (np.random.default_rng(4).standard_normal((66, 16000)) * 0.2).astype(np.float32)
    ).to(cuda)
    kmat = gt.block_system_tensor(16000.0, 128, 50.0, 80, cuda)
    st = torch.zeros(66, 8, 128, device=cuda)
    s_whole, e_whole = kgt.chunk(wave, kmat, st)
    parts = []
    for c in range(10):
        st, e = kgt.chunk(wave[:, c * 1600:(c + 1) * 1600].contiguous(), kmat, st)
        parts.append(e)
    e_b1 = kgt.sub_energy(wave, kmat)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), e_whole)
    assert torch.equal(st, s_whole)
    assert torch.equal(e_whole.permute(0, 2, 1), e_b1)


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
    kmat = gt.block_system_tensor(16000.0, 16, 50.0, 80, cuda)
    hop = torch.zeros(2, 1600, device=cuda)
    st = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        kgt.chunk(hop, kmat, st.double())
    with pytest.raises(ValueError, match="cascade state"):
        kgt.chunk(hop, kmat, torch.zeros(2, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        kgt.chunk(hop, kmat, st.cpu())
    with pytest.raises(ValueError, match="g=80"):
        kgt.chunk(hop, gt.block_system_tensor(16000.0, 16, 50.0, 40, cuda), st)

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


@pytest.mark.parametrize("n_neurons", [1100, 2048])
def test_wide_dense_lif_kernels_bit_equal(cuda, n_neurons):
    """Dense reservoirs above 1024 padded neurons (B2 and B4 on the block
    body) against their twins on dyadic weights."""
    cfg = ReservoirConfig(num_neurons=n_neurons, small_world_k=int(0.2 * n_neurons),
                          mean_weight=0.01)
    r = res.init_reservoir(cfg, 128, device=cuda).dyadic()
    ops, kw = r.kernel_operands()
    rng = np.random.default_rng(n_neurons)
    x = torch.as_tensor((rng.random((4, 128, 120)) < 0.1).astype(np.uint8)).to(cuda)
    before = klif.launches
    stats, counts = klif.lif_stats(x, *ops, **kw)
    assert klif.launches == before + 1
    ref_stats, ref_counts = klif.lif_stats_plain(x, *ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(stats, ref_stats) and torch.equal(counts, ref_counts)
    assert counts.sum() > 0
    del kw["n_win"]
    kw.update(win_len=40, n_new_win=1)
    n_pad = ops[0].shape[0]
    state_k = state_p = (torch.zeros(4, n_pad, device=cuda),
                         torch.zeros(4, n_pad, dtype=torch.int32, device=cuda),
                         torch.zeros(4, n_pad, device=cuda))
    for c in range(3):
        xc = x[..., c * 40:(c + 1) * 40].contiguous()
        out_k = klif.lif_chunk(xc, *ops, *state_k, **kw)
        out_p = klif.lif_chunk_plain(xc, *ops, *state_p, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, p) for a, p in zip(out_k, out_p))
        state_k, state_p = out_k[:3], out_p[:3]


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


@pytest.mark.parametrize("n,n_new_win", [(384, 1), (384, 2), (10240, 1)])
def test_sparse_chunk_kernel_bit_equal_over_chained_chunks(cuda, n, n_new_win):
    c = 128
    sr = _sparse(cuda, n, int(0.2 * n), 4 if n > 1000 else 2, c,
                 0.003 if n > 1000 else 0.02)
    ops, kw = sr.kernel_operands()
    del kw["n_win"]
    kw.update(win_len=40, n_new_win=n_new_win)
    b = 6
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
    # A reservoir whose state does not fit one CTA's shared memory.
    nb = 160
    wide = (torch.zeros(nb, 1, 128, 128, dtype=torch.bfloat16, device=cuda),
            torch.arange(nb, dtype=torch.int32, device=cuda)[:, None].contiguous(),
            torch.zeros(128, nb * 128, dtype=torch.bfloat16, device=cuda),
            torch.ones(nb * 128, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        ksp.sparse_lif_stats(x, *wide, **kw)
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
