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
from lsm_tpu_torch.models.frontend import featurize_batch
from lsm_tpu_torch.ops import gammatone as gt
from lsm_tpu_torch.ops.kernels import gtgram as kgt
from lsm_tpu_torch.ops.kernels import lif as klif

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
    big = res.init_reservoir(ReservoirConfig(num_neurons=1100, small_world_k=32,
                                             mean_weight=0.02), 32, device=cuda)
    ops_b, kw_b = big.kernel_operands()
    del kw_b["n_win"]
    n_b = ops_b[0].shape[0]
    with pytest.raises(ValueError, match="N_pad"):
        klif.lif_chunk(x, *ops_b, torch.zeros(2, n_b, device=cuda),
                       torch.zeros(2, n_b, dtype=torch.int32, device=cuda),
                       torch.zeros(2, n_b, device=cuda), **kw_b, win_len=40, n_new_win=1)
