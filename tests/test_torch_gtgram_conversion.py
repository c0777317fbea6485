"""Kernel B1/B3's state conversion against float64 (ROADMAP C5), on the
CPU through the float32 emulation of lsm_tpu_torch/tools/gtgram_conversion.py.

The kernel converts its cascade state between the block form's TDF2 and
its delta form once a serving hop (1600 samples, 20 sub-blocks at g = 80);
it used to convert at every sub-block. On the configs[2] corpus
(`synthetic_audio_batch(30, 35, seed=77)`, 256 filters) row 177 carries
channel 3's worst reading of the per-sub-block form (1.074e-3 over the
first 256 rows) and row 191 channel 10's (4.797e-4, the worst of all 256
channels in the per-hop form). The per-hop form must read <= 1e-3, the
port's rule against float64, and the per-sub-block form more where it
did. No jax here."""

import numpy as np
import pytest
import torch

from lsm_tpu_torch.config import FrontendConfig
from lsm_tpu_torch.io.dataset import synthetic_audio_batch
from lsm_tpu_torch.ops import gammatone as gt
from lsm_tpu_torch.ops.kernels import gtgram as kgt
from lsm_tpu_torch.tools import gtgram_conversion as tool

ROWS = [177, 191]
CHANNELS = [3, 10]
F64_REL = 1e-3
HOP = 1600


@pytest.fixture(scope="module")
def readings():
    """Worst relative error per (form, row, channel) against float64."""
    fc = FrontendConfig(n_filters=256)
    g = 80
    fs, ch = float(fc.sample_rate), np.asarray(CHANNELS)
    n0, n1, b1, b2 = gt._section_coeffs(fs, fc.n_filters, fc.gt_f_min)
    sec = (n0[ch], n1[:, ch], b1[ch], b2[ch])
    q = gt.cascade_coeffs(fs, fc.n_filters, fc.gt_f_min)[ch]
    audio, _ = synthetic_audio_batch(30, 35, seed=77)
    x = np.ascontiguousarray(audio[ROWS], np.float32)
    ref = tool.sub_energies("float64", x, q, sec, g)
    out = {}
    for form in tool.FORMS:
        e = tool.sub_energies(form, x, q, sec, g, HOP)
        out[form] = np.stack([tool.worst_by_channel(e[:, r:r + 1], ref[:, r:r + 1])
                              for r in range(len(ROWS))])          # (rows, channels)
    return out


def test_the_kernel_form_reads_within_the_rule(readings):
    assert readings["kernel"].max() <= F64_REL, readings["kernel"]


def test_per_sub_block_conversion_read_past_it_in_channel_3(readings):
    k, per_sub = readings["kernel"], readings["per_sub_block"]
    assert per_sub[0, 0] > F64_REL                      # row 177, channel 3: 1.074e-3
    assert per_sub[0, 0] > 5 * k[0, 0]
    np.testing.assert_allclose(per_sub[0, 0], 1.074e-3, rtol=1e-3)


def test_one_conversion_a_hop_costs_what_none_costs(readings):
    k, none = readings["kernel"], readings["no_conversion"]
    assert k.max() == pytest.approx(none.max(), rel=1e-6)          # row 191, channel 10
    assert k[1, 1] == k.max()


@pytest.mark.parametrize("fs,g,period", [(16000.0, 80, 20), (8000.0, 40, 20),
                                         (16000.0, 160, 10)])
def test_the_featurizers_period_is_one_hop(fs, g, period):
    """phase 5's g = 40 (8 kHz) and g = 160 (a 30 ms window) included."""
    assert gt.conversion_period(fs, g) == period
    assert gt.filterbank(fs, 4, 50.0, g, torch.device("cpu")).conv_sub == period
    assert period * g == round(0.1 * fs)


def test_the_wrappers_refuse_a_bad_period():
    fb = gt.filterbank(16000.0, 4, 50.0, 80, torch.device("cpu"))
    w = torch.zeros(2, 1600)
    for bad in (0, -20, 2.5):
        with pytest.raises(ValueError, match="period"):
            kgt.sub_energy(w, fb, conv_sub=bad)
        with pytest.raises(ValueError, match="period"):
            kgt.chunk(w, fb, torch.zeros(2, 8, 4), conv_sub=bad)
    # On the CPU the plain twin runs, which has no conversion at all.
    assert torch.equal(kgt.sub_energy(w, fb, conv_sub=1), kgt.sub_energy(w, fb))
