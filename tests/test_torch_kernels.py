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
